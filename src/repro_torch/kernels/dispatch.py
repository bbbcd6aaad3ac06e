"""Dispatch of the path's ops to their kernels.

The kernel follows the tensor's device: a CUDA tensor goes to the
hand-written Hopper kernel, a CPU tensor to the plain PyTorch version.
The ``force_plain()`` context sends every op called inside it to the plain
version on any device; it exists for the parity tests and for
``chip_smoke.py``'s comparisons, and nothing on the serving path enters it.
No environment variable is read.

``check_card_support`` refuses, before a CUDA session is built, a config
that some hand kernel would refuse deep inside a layer, naming the kernel
and its limit; the device rule leaves no other route for such a config.

``dense_linear`` has no hand kernel, as ``repro``'s has no Pallas one: it is
one ``torch.matmul`` on f32-upcast operands plus the epilogue, the way XLA's
f32-accumulating dot is in the JAX package.

Every op counts its calls by (role, route) in a module-local registry
(``kernel_metrics``, ``dispatch_counts``; ``repro.kernels.dispatch:112-160``
is the counterpart): route ``cuda`` is the hand kernel, ``plain`` the plain
PyTorch version (``dense_linear``'s only route).  A count is a host-side
float add: it adds no device sync to a tick.  Inside an explicit
``kernel_timing()`` context each call is also fenced with
``torch.cuda.synchronize()`` before and after and its wall time recorded in
the ``kernel_wall_seconds`` histogram; nothing else turns the fence on.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

import torch

from . import int4_matmul as _int4
from . import paged_attention as _paged
from . import prefill_attention as _prefill
from . import scan_rglru as _rglru
from . import scan_wkv as _wkv
from . import tt_embed as _embed
from . import tt_linear as _tt
from ..obs.registry import MetricsRegistry
from .epilogue import apply_epilogue

_plain: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_force_plain", default=False)
_timed: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_kernel_timing", default=False)
_METRICS = MetricsRegistry()
_COUNTERS: dict = {}  # (role, route) -> its Counter, skipping the label sort


def kernel_metrics() -> MetricsRegistry:
    """Registry holding ``kernel_dispatch_total{role,route}`` counters and
    (inside ``kernel_timing()``) ``kernel_wall_seconds`` histograms."""
    return _METRICS


def dispatch_counts() -> dict[tuple[str, str], int]:
    """{(role, route): calls} since the last ``reset_dispatch_metrics()``."""
    return {(lab["role"], lab["route"]): int(m.value)
            for name, lab, m in _METRICS.collect() if name == "kernel_dispatch_total"}


def reset_dispatch_metrics() -> None:
    _METRICS.reset()
    _COUNTERS.clear()


@contextlib.contextmanager
def kernel_timing():
    """Fence and time every op called inside (``kernel_wall_seconds``)."""
    token = _timed.set(True)
    try:
        yield
    finally:
        _timed.reset(token)


def _start(t):
    """A start stamp inside ``kernel_timing()`` (after a fence), else None."""
    if not _timed.get():
        return None
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _record(role: str, t0, t, out, route: str | None = None):
    """Count one call of ``role`` on ``t``'s route (the hand kernel for a
    CUDA tensor outside ``force_plain()``); time it when ``t0`` is set."""
    route = route or ("cuda" if t.is_cuda and not _plain.get() else "plain")
    c = _COUNTERS.get((role, route))
    if c is None:
        c = _COUNTERS[(role, route)] = _METRICS.counter(
            "kernel_dispatch_total", role=role, route=route)
    c.inc()
    if t0 is not None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        _METRICS.histogram("kernel_wall_seconds", role=role, route=route).observe(
            time.perf_counter() - t0)
    return out


def plain_forced() -> bool:
    """Whether a ``force_plain()`` context is open."""
    return _plain.get()


@contextlib.contextmanager
def force_plain():
    """Run every op called inside on its plain version."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def _linear_specs(specs: dict):
    """The LinearSpecs of a specs dict (rec_specs nests its MLP's)."""
    for v in specs.values():
        yield from _linear_specs(v) if isinstance(v, dict) else (v,)


def card_limits(cfg, backend: str) -> list[str]:
    """Why the hand kernels cannot serve ``cfg`` through ``backend`` on the
    card: one line a kernel limit the config crosses, empty when none.  The
    attention kernels' head dims are checked for each kernel the backend
    runs, under its own name: the paged backend's decode kernel
    (``paged_attention.HEAD_DIMS``) and chunked-prefill kernel
    (``prefill_attention.HEAD_DIMS``), which whisper's encdec backend runs
    for its decoder's self-attention too, the ring backend's ring kernel (the
    prefill tuple: its decode shares the decode kernel's body).
    Kernels with no limit a config can cross (the RG-LRU scan; tt_linear,
    whose bf16 specs past the fused kernel's d <= 8 and ranks <= 32 take the
    staged kernel) are not listed.  int4 scales are bf16 wherever a config's
    params are made (``quantize_int4`` in both packages); the int4 wrapper
    refuses others at the call.  MoE experts run through the grouped
    tt_linear, which has no staged kernel: int4 or dense experts, and TT
    experts past the fused route (bf16 activations, d <= 8, ranks <= 32), are
    refused."""
    from ..models import griffin, modules, moe, rwkv, transformer, whisper
    g = cfg.n_heads // max(cfg.n_kv_heads, 1)
    out = []
    if cfg.family == "rwkv":
        specs = list(rwkv.rwkv_specs(cfg).values())
        if cfg.rwkv_head_dim not in _wkv.KERNEL_HEAD_DIMS:
            out.append(f"wkv_scan takes head dims {_wkv.KERNEL_HEAD_DIMS}; rwkv_head_dim is "
                       f"{cfg.rwkv_head_dim}")
    elif cfg.family == "encdec":  # the encoder's and cross attention are plain ops
        specs = [whisper.attn_specs(cfg), modules.mlp_specs(cfg, True)]
    else:
        flags = (True,) if cfg.family == "griffin" else \
            {flag for _, flag in transformer.segment_plan(cfg)}
        blocks = [transformer.make_block_specs(cfg, f) for f in flags]
        specs = [dict(b.attn) | (dict(b.mlp) if b.moe is None else {"router": b.moe["router"]})
                 for b in blocks]
        for expert in (b.moe["expert"] for b in blocks if b.moe is not None):
            for sp in expert.values():
                if sp.kind != "tt":
                    out.append(moe.NON_TT_EXPERTS)
                elif not _tt.fused_route(sp.tt, modules.dt(cfg.compute_dtype),
                                         [modules.dt(cfg.param_dtype)] * sp.tt.d):
                    out.append(f"grouped tt_linear takes bf16 activations, d <= "
                               f"{_tt.FUSED_MAX_D} and ranks <= {_tt.FUSED_MAX_RANK}; an "
                               f"expert linear has d {sp.tt.d}, ranks {sp.tt.ranks}, "
                               f"compute_dtype {cfg.compute_dtype}")
        if cfg.family == "griffin":
            specs.append(griffin.rec_specs(cfg))
    if cfg.family != "rwkv":
        if backend in ("paged", "encdec"):
            if cfg.head_dim not in _paged.HEAD_DIMS:
                out.append(f"paged_attention (decode) takes head_dim {_paged.HEAD_DIMS}; "
                           f"head_dim is {cfg.head_dim}")
            if cfg.head_dim not in _prefill.HEAD_DIMS:
                out.append(f"prefill_attention takes head_dim {_prefill.HEAD_DIMS}; "
                           f"head_dim is {cfg.head_dim}")
            if g % min(g, 16):
                out.append(f"paged_attention (decode) takes a GQA group of at most 16 or a "
                           f"multiple of 16; the group is {g}")
        elif cfg.head_dim not in _prefill.HEAD_DIMS:
            out.append(f"ring_attention takes head_dim {_prefill.HEAD_DIMS}; head_dim is "
                       f"{cfg.head_dim}")
        if g > 64 and g % 64:
            out.append(f"the attention kernels' f32 path takes a GQA group of at most 64 or "
                       f"a multiple of 64; the group is {g}")
    for spec in (s for d in specs for s in _linear_specs(d)):
        if spec.kind != "int4":
            continue
        if spec.n_in % 32 or spec.quant_group % 16:
            out.append(f"int4_matmul takes K % 32 == 0 and group % 16 == 0; an int4 linear "
                       f"has K {spec.n_in}, group {spec.quant_group}")
    embed = modules.embed_spec(cfg)
    if embed is not None and embed.tt.d > 8:
        out.append(f"tt_embed takes at most 8 cores; the embedding has {embed.tt.d}")
    return list(dict.fromkeys(out))


def check_card_support(cfg, device, backend: str) -> None:
    """Raise ``ValueError`` naming each hand-kernel limit ``cfg`` crosses
    when ``device`` is CUDA; on a CPU device every config runs on the plain
    versions and nothing is checked."""
    if torch.device(device).type != "cuda":
        return
    problems = card_limits(cfg, backend)
    if problems:
        raise ValueError(f"{cfg.name} cannot be served on the card: " + "; ".join(problems))


def dense_linear(x, w, *, scale=None, bias=None, residual=None,
                 activation: str | None = None):
    """y = act(x W [* scale] [+ b]) [+ residual];  (…, N) @ (N, M)."""
    t0 = _start(x)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    y = apply_epilogue(y, scale=scale, bias=bias, residual=residual,
                       activation=activation)
    return _record("dense", t0, x, y.to(x.dtype), route="plain")


def tt_linear(x, cores, spec, *, scale=None, bias=None, residual=None,
              activation: str | None = None):
    """(…, N) -> (…, M) through the staged TT contraction + fused epilogue."""
    kw = dict(scale=scale, bias=bias, residual=residual, activation=activation)
    t0 = _start(x)
    fn = _tt.tt_linear_ref if _plain.get() else _tt.tt_linear
    return _record("tt", t0, x, fn(x, cores, spec, **kw))


def tt_linear_grouped(x, offsets, cores, spec, *, activation: str | None = None):
    """(R, N) rows sorted by expert (expert e's rows ``offsets[e] :
    offsets[e + 1]``) -> (R, M) through the experts' stacked TT cores."""
    t0 = _start(x)
    fn = _tt.tt_linear_grouped_ref if _plain.get() else _tt.tt_linear_grouped
    return _record("tt_grouped", t0, x, fn(x, offsets, cores, spec, activation=activation))


def int4_matmul(x, qweight, scales, *, group: int = 128, scale=None, bias=None,
                residual=None, activation: str | None = None):
    """(…, K) -> (…, M) through the w4a16 kernel + fused epilogue."""
    kw = dict(scale=scale, bias=bias, residual=residual, activation=activation)
    t0 = _start(x)
    fn = _int4.int4_matmul_ref if _plain.get() else _int4.int4_matmul
    return _record("int4", t0, x, fn(x, qweight, scales, group, **kw))


def paged_attention(q, cache, block_tables, qpos, *, sm_scale=None):
    """Decode attention, q (B, H, Dh), qpos (B,) (-1 = inactive row -> 0)."""
    t0 = _start(q)
    fn = _paged.paged_attention_ref if _plain.get() else _paged.paged_attention
    return _record("attn_paged", t0, q, fn(q, cache, block_tables, qpos, sm_scale=sm_scale))


def prefill_attention(q, qpos, *, cache=None, block_tables=None, k=None, v=None,
                      kpos=None, window: int = 0, sm_scale=None, k_scale=None,
                      v_scale=None):
    """Chunked-prefill attention, q (B, Sq, H, Dh), qpos (B, Sq) (-1 =
    padding row -> 0), over exactly one layout: the paged pool (``cache`` +
    ``block_tables``) or per-slot rings (``k``/``v`` + ``kpos``, -1 = empty
    entry; int8 rings with ``k_scale``/``v_scale`` (B, WR, Hkv)).  The ring
    layout also serves ring decode (Sq = 1)."""
    paged = cache is not None or block_tables is not None
    ring = k is not None or v is not None or kpos is not None
    if paged == ring:
        raise ValueError("prefill_attention takes exactly one layout: "
                         "cache+block_tables (paged) or k/v/kpos (ring)")
    if paged and (cache is None or block_tables is None):
        raise ValueError("paged layout needs both cache and block_tables")
    if ring and (k is None or v is None or kpos is None):
        raise ValueError("ring layout needs all of k, v and kpos")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is not None and not ring:
        raise ValueError("k_scale/v_scale are ring-layout only")
    t0 = _start(q)
    if paged:
        kw = dict(cache=cache, block_tables=block_tables, window=window, sm_scale=sm_scale)
        fn = _prefill.prefill_attention_ref if _plain.get() else _prefill.prefill_attention
        return _record("attn_prefill", t0, q, fn(q, qpos, **kw))
    kw = dict(k=k, v=v, kpos=kpos, window=window, sm_scale=sm_scale, k_scale=k_scale,
              v_scale=v_scale)
    fn = _prefill.ring_attention_ref if _plain.get() else _prefill.ring_attention
    return _record("attn_ring", t0, q, fn(q, qpos, **kw))


def rglru_scan(log_a, gx, h0, pos=None, *, scan_dtype=None):
    """RG-LRU recurrence: log_a/gx (B, S, W), h0 (B, W) f32, pos (B, S)
    (-1 = padding step: the state passes through bitwise).  Returns
    (h (B, S, W) scan_dtype, h_last (B, W) f32); S == 1 is the decode step.
    Both versions check the shapes and raise ``ValueError``."""
    t0 = _start(log_a)
    fn = _rglru.rglru_scan_ref if _plain.get() else _rglru.rglru_scan
    return _record("rglru_scan", t0, log_a, fn(log_a, gx, h0, pos, scan_dtype=scan_dtype))


def rg_lru_gated(ga, gxp, u, lam, g, h0, pos=None, *, h_out=None):
    """Griffin's RG-LRU with its gate math and output gate in one call: ga,
    gxp, u, g (B, S, W) of one dtype (the gate linears' outputs, the conv
    output, the ``in_g`` linear's output), lam (W,), h0 (B, W) f32, pos
    (B, S) (-1 = padding step).  r = σ(ga), i = σ(gxp), log a =
    -8·softplus(lam)·r, gx = i·u, the scan from h0, y = h·gelu_tanh(g).
    Returns (y (B, S, W) in u's dtype, h_last (B, W) f32, written into
    ``h_out`` when given, which may be h0)."""
    t0 = _start(u)
    fn = _rglru.rg_lru_gated_ref if _plain.get() else _rglru.rg_lru_gated
    return _record("rglru_gated", t0, u, fn(ga, gxp, u, lam, g, h0, pos, h_out=h_out))


def tt_embed(ids, cores, spec):
    """Rows of a vocab-axis TT embedding table (``spec``: M = V, N = D):
    ids of any int shape (negative ids wrap once, then clamp) -> (..., D)
    f32."""
    t0 = _start(ids)
    fn = _embed.tt_embed_ref if _plain.get() else _embed.tt_embed
    return _record("embed_lookup", t0, ids, fn(ids, cores, spec))


def wkv_scan(r, k, v, w, u, state0, pos=None, *, state_scale=None):
    """RWKV6 wkv recurrence: r/k/v/w (B, S, H, hd), u (H, hd), state0
    (B, H, hd, hd) f32, or int8 with ``state_scale`` (B, H) f32, pos (B, S)
    (-1 = padding step).  Returns (y (B, S, H, hd) f32, new state, new scale
    or None); S > 1 takes the floored chunked form, S == 1 the exact step.
    Both versions check the shapes and raise ``ValueError``."""
    t0 = _start(r)
    fn = _wkv.wkv_scan_ref if _plain.get() else _wkv.wkv_scan
    return _record("wkv_scan", t0, r, fn(r, k, v, w, u, state0, pos,
                                              state_scale=state_scale))
