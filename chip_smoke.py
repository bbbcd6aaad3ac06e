#!/usr/bin/env python3
"""On-card smoke run of the repro_torch port (PyTorch + hand-written Hopper kernels).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the eight CUDA kernels from ``src/repro_torch/csrc`` (first use),
then:

1. kernel phases — each kernel against its plain PyTorch version at the
   serving paths' shapes, with its time, the plain version's time, one
   PyTorch library call's time as a yardstick where one exists, and the
   card's bound; each prefill attention phase also prints the key tiles its
   flash tile walks against the tiles its CTAs would walk without the
   visible-tile rule; the int4 phases also run the decode GEMV at one and 16
   tokens and time both bf16 routes (GEMV, wgmma GEMM) on the same inputs
   at B 16-48, where the wrapper's crossover sits; the MoE phases run the
   grouped tt_linear at
   mixtral-8x22b's and kimi-k2-1t-a32b's expert specs (seeded routings, one
   with every row on one expert, one with most experts empty), each printing
   its route (decode tiles or wgmma) and its two launches' device times
   (operator pass, contraction), the routers'
   int4 linears on f32 activations, and one full-width kimi-k2 MoE layer;
   the attention phases at head_dim 112 (kimi-k2's H64/Hkv8) run paged
   decode and prefill over bf16 and int8 pools and ring decode and prefill
   over wrapped rings; the whisper-base phases run paged decode and prefill
   at H8/Hkv8/Dh64, tt_linear on its three d = 3 specs with their biased
   epilogues and its biased int4 512 -> 512;
2. for each of the eight serving paths — llama2-7b (paged K/V),
   recurrentgemma-2b (griffin: RG-LRU state and windowed attention rings),
   llama2-7b-tt-embed (llama2-7b's paged path with its embedding table a
   vocab-axis TT, on the same params with TT cores swapped in for the table),
   rwkv6-7b (wkv matrix state and token-shift tails) and
   chatglm3-6b-compressed (ChatGLM3-6B compressed by the port itself: a
   planted TT + int4 tree made dense in bf16 on the card, ``compress_model``
   there with each TT linear's recovery held to a bound, the int4 leaves
   bitwise the CPU's, then ``save_compressed`` and ``load_compressed``
   bitwise, and the loaded tree served), mixtral-8x22b (MoE: 56 layers of
   8 TT experts, top-2, through the sliding-window ring backend),
   kimi-k2-1t-a32b (MoE: 61 layers of 384 TT experts, top-8, 64 heads of
   112 over 8 KV heads, vocab 163840, through the paged backend) and
   whisper-base (encoder-decoder: 6 + 6 layers, each request's seeded
   (1500, 512) frames encoded at its admission into a per-slot context, the
   decoder's self-attention paged) — at full width and depth:
   a. a logits check at the serve phase's geometry — 8 slots prefilling the
      serve phase's 8 prompts in 256-token chunks, then 4 decode steps,
      through the kernels against the same steps through the plain versions
      (``dispatch.force_plain()``) on the card (rwkv6-7b and the MoE paths
      layer by layer on the plain route's input, the MoE paths' on their
      first 8 layers: mixtral's over rings, kimi-k2's over a paged pool;
      whisper-base's also holds the encoder contexts its begin steps wrote);
   b. the serve phase — the continuous-batching ``Engine`` serving those 8
      requests (random weights from a seed), with every kernel's launch
      counter reset just before and read just after;
   c. a profile of decode steps and of one prefill chunk: wall time against
      device kernel time (``torch.profiler``), the device's busy share, the
      top kernels, each hand kernel's time, the attention kernels' time, the
      count of device kernels and of device-to-host copies a call (none on
      the MoE paths') and the scans' and the int4 kernels' device time a
      call and a launch (the MoE paths': the grouped tt_linear's operator
      pass and contraction, named apart; whisper-base's also one begin step,
      with no device-to-host copy);
   d. on llama2-7b only, the serving front end: ``[frontend]`` serves 12
      requests through ``Engine.run`` and the ``AsyncEngine`` without and
      with dispatch-ahead (bitwise the same tokens, every ahead dispatch
      under ``torch.cuda.set_sync_debug_mode("error")``, decode wall a tick
      by arm, a profiled window of pump ticks), and ``[traffic]`` replays 32
      seeded Poisson requests with cancels and deadlines through
      ``traffic.drive`` with dispatch-ahead on and off (TTFT and inter-token
      percentiles, tokens/s, goodput, the schema check, JSONL traces under
      ``chiprun_out/`` validated), and ``[solo llama2-7b]``: 4 of its
      requests one at a time through ``models.api.Model`` fed the Engine's
      tokens, every step's logits held against the serving session's fed
      the same, and each Engine token within 0.05 of max|logit| of the solo
      path's top logit (a bf16 near-tie may flip a greedy token);
3. the single-sequence path (``models.api.Model``): ``[solo <family>]`` for
   recurrentgemma-2b, rwkv6-7b, whisper-base and mixtral-8x22b at full width
   and 2 layers (a 256-token prefill and 4 decode steps, kernels against
   ``force_plain()``), and ``[solo qwen2-vl-7b]`` at full width and depth
   (28 layers; one 2048-token request of text, a 32 x 32 image block and
   text with M-RoPE positions; 32 decode steps; every launch counted, the
   prefill and a decode step profiled), whose kernel phases run at its TT
   and int4 shapes;
4. training: ``[tt_linear_bwd]`` holds the tt_linear backward at
   tinyllama-1.1b's three specs (B 2048 and 16384 on the fused route, 2048
   on the staged one) against autograd of the plain version — dx through
   the kernel on the transposed train, timed with its bound and
   ``torch.matmul(dz, Wᵀ)``, the cores' GEMMs, the plain autograd;
   ``[train tinyllama-1.1b]`` trains the published config at full width
   and depth (22 layers; batch 8 x 2048, remat "full", AdamW): step 0's
   loss and every gradient leaf against ``force_plain()``, 4 steps through
   the ``Trainer`` with tt_linear's forward, recompute and backward
   launches counted (no plain version on the card), a forced
   ``AsyncCheckpointer`` save restored bitwise, one step profiled;
   ``[train remat]`` (2 layers) runs "none", "dots" and "full" on one batch
   (equal grads, peaks none > dots > full, forward launches F, F, 2F);
   ``[train trainer]`` (2 layers) 30 steps at lr 3e-3 with a fault injected
   at step 12 (one restart from the async checkpoint, the loss falling by
   0.2 or more).

It prints the card's name and power limit, a ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.  It exits
non-zero, without the last line, when there is no CUDA device, when the
package is missing, or when any phase fails.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 tensor-core peak
SEED = 0
# Attention outputs are held element by element: |got - want| <= ATTN_ATOL *
# max|want| of the element's own (query, head) row + ATTN_RTOL * |want|, each
# 2-4 bf16 ulps (an ulp of m is 2^-8..2^-7 of m).  Both sides round the output
# to bf16, and the prefill kernel rounds P (and, from int8 pools, the
# dequantized K and V) to bf16 for its mma products, so its error follows the
# size of the values a row averages, which the row's max reflects: with the
# atol at one ulp (2^-8) the int8 prefill phases reached 1.4 of it.
ATTN_ATOL, ATTN_RTOL = 2.0 ** -6, 2.0 ** -6
# [train tinyllama-1.1b], step 0, hand kernels (g_k) against force_plain()
# (g_p) and the plain versions computing in f32 (g_f32), each gradient leaf:
# |g_k - g_p| / |g_p| <= TRAIN_GRAD_TOL, no looser than 0.05; the readings
# sit near it (PERF.md §6, training: worst 0.04956,
# median 0.0385), since both routes round activations to bf16, in different
# places, through 22 random-weight layers (g_k and g_p are each 5.3e-2 worst,
# 4.2e-2 median from g_f32).  So each leaf's |g_k - g_p| is also held to
# TRAIN_GRAD_RATIO x its |g_p - g_f32|: two independent roundings of equal
# size give sqrt(2), and a kernel fault adds on top.  The losses agree within
# TRAIN_LOSS_TOL (measured: 7e-5), and step 0's loss lies within
# TRAIN_INIT_LOSS_TOL of ln V + 1/2: the init's logits have unit variance
# (the final RMSNorm, a head of std 1/sqrt(D)), so E[lse] ~ ln V + 1/2.
TRAIN_GRAD_TOL = 0.05
TRAIN_GRAD_RATIO = 1.5
TRAIN_LOSS_TOL = 1e-3
TRAIN_INIT_LOSS_TOL = 0.05

SOURCES = {
    "tt_linear": ("src/repro_torch/csrc/tt_linear.cu", "src/repro/kernels/tt_linear.py:91"),
    "int4_matmul": ("src/repro_torch/csrc/int4_matmul.cu", "src/repro/kernels/int4_matmul.py:57"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:78"),
    "prefill_attention": ("src/repro_torch/csrc/prefill_attention.cu",
                          "src/repro/kernels/prefill_attention.py:118"),
    "ring_attention": ("src/repro_torch/csrc/ring_attention.cu",
                       "src/repro/kernels/prefill_attention.py:118"),
    "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu", "src/repro/kernels/scan_rglru.py:87"),
    "tt_embed": ("src/repro_torch/csrc/tt_embed.cu", "src/repro/kernels/tt_embed.py:79"),
    "wkv_scan": ("src/repro_torch/csrc/wkv_scan.cu", "src/repro/kernels/scan_wkv.py:102"),
    "tt_linear_grouped": ("src/repro_torch/csrc/tt_linear.cu",
                          "src/repro/kernels/tt_linear.py:91 (under jax.vmap over the experts, "
                          "src/repro/models/moe.py:91)"),
    "int4_matmul_f32": ("src/repro_torch/csrc/int4_matmul.cu",
                        "src/repro/kernels/int4_matmul.py:57 (f32 activations)"),
    "tt_linear_bwd": ("src/repro_torch/csrc/tt_linear.cu",
                      "src/repro/kernels/tt_linear.py:91 (its backward: repro differentiates "
                      "the ref contraction with XLA's autodiff, no Pallas backward)"),
}
# the kernels line's names where they differ from the phase keys
DISPLAY_NAMES = {"tt_linear_bwd": "tt_linear backward (dx on the transposed train)"}
# kernel -> (wrapper module, its launch counter, its plain-on-CUDA counter)
COUNTERS = {
    "tt_linear": ("tt_linear", "launches", "plain_cuda_calls"),
    "int4_matmul": ("int4_matmul", "launches", "plain_cuda_calls"),
    "paged_attention": ("paged_attention", "launches", "plain_cuda_calls"),
    "prefill_attention": ("prefill_attention", "launches", "plain_cuda_calls"),
    "ring_attention": ("prefill_attention", "ring_launches", "ring_plain_cuda_calls"),
    "rglru_scan": ("scan_rglru", "launches", "plain_cuda_calls"),
    "tt_embed": ("tt_embed", "launches", "plain_cuda_calls"),
    "wkv_scan": ("scan_wkv", "launches", "plain_cuda_calls"),
    "tt_linear_grouped": ("tt_linear", "grouped_launches", "plain_cuda_calls"),
    "int4_matmul_f32": ("int4_matmul", "f32_launches", "plain_cuda_calls"),
    "tt_linear_bwd": ("tt_linear", "bwd_launches", "plain_cuda_calls"),
}
# the kernels each serving path must launch
PATH_KERNELS = {
    "llama2-7b": ("tt_linear", "int4_matmul", "paged_attention", "prefill_attention"),
    "recurrentgemma-2b": ("tt_linear", "int4_matmul", "ring_attention", "rglru_scan"),
    "llama2-7b-tt-embed": ("tt_embed", "tt_linear", "int4_matmul", "paged_attention",
                           "prefill_attention"),
    "rwkv6-7b": ("tt_linear", "int4_matmul", "wkv_scan"),
    "chatglm3-6b-compressed": ("tt_linear", "int4_matmul", "paged_attention",
                               "prefill_attention"),
    "mixtral-8x22b": ("tt_linear", "int4_matmul", "ring_attention", "tt_linear_grouped",
                      "int4_matmul_f32"),
    "kimi-k2-1t-a32b": ("tt_linear", "tt_linear_grouped", "int4_matmul", "int4_matmul_f32",
                        "paged_attention", "prefill_attention"),
    "whisper-base": ("tt_linear", "int4_matmul", "paged_attention", "prefill_attention"),
    "solo qwen2-vl-7b": ("tt_linear", "int4_matmul"),
    "train tinyllama-1.1b": ("tt_linear", "tt_linear_bwd"),
}
# The single-sequence phases at full width and 2 layers: the kernels each
# family's phase must launch besides tt_linear and int4_matmul.
SOLO_FAMILY_KERNELS = {"recurrentgemma-2b": ("rglru_scan",), "rwkv6-7b": ("wkv_scan",),
                       "whisper-base": (),
                       "mixtral-8x22b": ("tt_linear_grouped", "int4_matmul_f32")}


def counters():
    """{kernel: (launches, plain calls on CUDA)} read from the wrappers."""
    import importlib
    out = {}
    for name, (mod, launch, plain) in COUNTERS.items():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        out[name] = (getattr(m, launch), getattr(m, plain))
    return out


def reset_counters():
    import importlib
    for mod, launch, plain in COUNTERS.values():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        setattr(m, launch, 0)
        setattr(m, plain, 0)
    tt = importlib.import_module("repro_torch.kernels.tt_linear")
    tt.staged_launches = tt.recompute_launches = 0


def sm_clock() -> str:
    """The card's SM clock and power draw as nvidia-smi reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "n/a"


def tt_row_flops(spec) -> int:
    """FLOPs of one TT embedding row by the cheapest contraction order: the
    digit-selected cores G_k (r_{k-1}, n_k, r_k) chained as a matrix chain,
    contracting [i..m] with [m+1..j] costs 2 r_{i-1} N_im r_m N_(m+1)j r_j
    (N = product of the in-modes)."""
    n, r, d = spec.in_modes, spec.ranks, spec.d
    prod = [[math.prod(n[i:j + 1]) for j in range(d)] for i in range(d)]
    cost = [[0] * d for _ in range(d)]
    for length in range(2, d + 1):
        for i in range(d - length + 1):
            j = i + length - 1
            cost[i][j] = min(cost[i][m] + cost[m + 1][j]
                             + 2 * r[i] * prod[i][m] * r[m + 1] * prod[m + 1][j] * r[j + 1]
                             for m in range(i, j))
    return cost[0][d - 1]


def mrope_positions(n_text: int, grid: tuple[int, int], n_after: int):
    """(3, 1, S) M-RoPE position ids (numpy int32) of ``n_text`` text tokens,
    an image block of ``grid`` (rows, cols) patches and ``n_after`` text
    tokens, as Qwen2-VL lays them out (arXiv:2409.12191 §2.1): text at t = h =
    w = i; patch (r, c) at (p, p + r, p + c) with p the text prefix length;
    the text after the image resumes at the largest id + 1."""
    import numpy as np
    rows, cols = grid
    t = list(range(n_text))
    h, w = list(t), list(t)
    for r in range(rows):
        for c in range(cols):
            t.append(n_text)
            h.append(n_text + r)
            w.append(n_text + c)
    nxt = max(max(t), max(h), max(w)) + 1
    for i in range(n_after):
        for plane in (t, h, w):
            plane.append(nxt + i)
    return np.array([t, h, w], np.int32)[:, None]


def kernel_events(prof):
    """The profile's device kernels and copies by name.  "Command Buffer Full"
    is the driver's record of the host waiting on a full launch queue, not
    device work: it once read 56 ms of a chunk.  Host-side ranges (an
    autograd node such as ``GeneratedBackwardFor_repro_torch_tt_linear``)
    carry as their own device time the kernels launched inside them outside
    any aten op, which are listed themselves: they are dropped."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_time_total > 0
            and getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CPU
            and not e.key.startswith(("aten::", "cuda", "Command Buffer Full"))]


@functools.lru_cache(maxsize=1)
def _hand_kernel_names():
    """A pattern matching the ``__global__`` functions of ``csrc/``."""
    import re
    names = set()
    for f in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu*"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                                r"(\w+)\s*[(<]", f.read_text()))
    return re.compile(r"(?:^|[\s:])(?:" + "|".join(sorted(names)) + r")[<(]")


def hand_kernel(key: str) -> bool:
    """Whether a profiled device kernel is one of the hand kernels: its name
    is a ``__global__`` function of ``csrc/`` (PyTorch's softmax, say, also
    lives in an anonymous namespace)."""
    return _hand_kernel_names().search(key) is not None


def bound(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Smoke:
    def __init__(self):
        import numpy as np
        import torch
        self.np, self.torch = np, torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(SEED)
        self.rng = np.random.default_rng(SEED)
        self.failures: list[str] = []
        self.phases: dict[str, list[dict]] = {k: [] for k in SOURCES}
        self.phases["moe_layer"] = []  # a model layer, not a kernel: kept out of the JSON line
        self.served: dict[str, list[list[int]]] = {}  # path -> the Engine's tokens a request

    # -- helpers --------------------------------------------------------------
    @contextlib.contextmanager
    def own_generators(self, seed):
        """Phases inside draw from torch and numpy generators seeded with
        ``seed``; the shared ones are left where they were."""
        gen, rng = self.gen, self.rng
        self.gen = self.torch.Generator(device=self.dev)
        self.gen.manual_seed(seed)
        self.rng = self.np.random.default_rng(seed)
        try:
            yield
        finally:
            self.gen, self.rng = gen, rng

    def randn(self, *shape, dtype=None, scale=1.0):
        t = self.torch.randn(*shape, generator=self.gen, device=self.dev) * scale
        return t.to(dtype) if dtype is not None else t

    def time_ms(self, fn, iters: int = 20) -> float:
        """Mean device time of ``fn(i)`` over ``iters`` launches (CUDA events)."""
        torch = self.torch
        for i in range(2):
            fn(i)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def row_ratio(self, got, want, atol=ATTN_ATOL, rtol=ATTN_RTOL) -> float:
        """Worst |got - want| / (atol * row max|want| + rtol * |want|) over
        all elements, rows along the last axis; <= 1 passes."""
        torch = self.torch
        got, want = got.float(), want.float()
        d = (got - want).abs()
        lim = atol * want.abs().amax(-1, keepdim=True) + rtol * want.abs()
        ratio = torch.where(d == 0, torch.zeros_like(d), d / lim)  # lim 0, d > 0 -> inf
        return ratio.max().item()

    def record(self, kernel, label, got, want, rel_tol, why, ms, plain_ms, lib_ms, lib_what,
               nbytes, flops, peak_flops=BF16_FLOPS):
        """``rel_tol`` is a fraction of max|want| over the whole output, or
        ``"rows"`` for the element-wise attention criterion above."""
        err = (got.float() - want.float()).abs().max().item()
        if rel_tol == "rows":
            ratio = self.row_ratio(got, want)
            ok = math.isfinite(ratio) and ratio <= 1.0
            tol_text = f"worst element at {ratio:.3f} of its tolerance " \
                       f"({ATTN_ATOL:g} * row max|want| + {ATTN_RTOL:g} * |want|)"
        else:
            tol = rel_tol * (want.float().abs().max().item() or 1.0)
            ok = math.isfinite(err) and err <= tol
            tol_text = f"tol={tol:.3e}"
        b_ms, b_by = bound(nbytes, flops, peak_flops)
        print(f"[{kernel}] {label}: max|d|={err:.3e} {tol_text} ({why}) "
              f"{'ok' if ok else 'FAIL'} | kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={'none' if lib_ms is None else f'{lib_ms:.4f}'} ({lib_what}) "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not ok:
            self.failures.append(f"{kernel} {label}: max|d| {err}, {tol_text}")
        self.phases[kernel].append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))

    # -- kernel phases --------------------------------------------------------
    def tt_phase(self, arch, role, spec, b, epi=None, core_dtype=None):
        """``epi``: the call site's epilogue (default: silu on gate, none on
        up, the block's residual elsewhere).  ``core_dtype`` f32: the cores
        ``compress_model`` writes, which the fused kernel rounds to bf16 as it
        loads them."""
        torch = self.torch
        from repro_torch.kernels import tt_linear as k
        core_dtype = core_dtype or torch.bfloat16
        cores = [self.randn(*s, dtype=core_dtype, scale=1 / math.sqrt(s[0]))
                 for s in spec.core_matrix_shapes()]
        x = self.randn(b, spec.n_in, dtype=torch.bfloat16)
        if epi is None:
            epi = {"gate": dict(activation="silu"), "up": {}}.get(
                role, dict(residual=self.randn(b, spec.n_out, dtype=torch.bfloat16)))
        staged = k.staged_launches
        got = k.tt_linear(x, cores, spec, **epi)
        if k.staged_launches != staged:
            self.failures.append(f"tt_linear {arch} {role} B={b}: took the staged kernel")
        want = k.tt_linear_ref(x, cores, spec, **epi)
        ms = self.time_ms(lambda i: k.tt_linear(x, cores, spec, **epi))
        plain_ms = self.time_ms(lambda i: k.tt_linear_ref(x, cores, spec, **epi), iters=5)
        eye = torch.eye(spec.n_in, device=self.dev)
        w = k.tt_linear_ref(eye, [c.float() for c in cores], spec).to(torch.bfloat16)
        lib_ms = self.time_ms(lambda i: torch.matmul(x, w))
        del eye, w
        nbytes = 2 * (x.numel() + b * spec.n_out + (b * spec.n_out if "residual" in epi else 0)) \
            + sum(c.numel() * c.element_size() for c in cores) \
            + (4 * spec.n_out if "bias" in epi else 0)
        # the operations of the cheapest contraction order (the staged order
        # at llama2 gate/up, a two-half split elsewhere)
        orders = k.tt_order_flops(spec)
        order = min(orders, key=orders.get)
        plan = k.contraction_plan(spec)
        cores_text = " f32 cores" if core_dtype == torch.float32 else ""
        self.record("tt_linear", f"{arch} {role} B={b}{cores_text}", got, want, 3e-2,
                    f"bf16: the plain version rounds each of the {spec.d} stages to bf16, the "
                    f"kernel its operators and its one intermediate (plan h={plan.h} "
                    f"{'left' if plan.left_first else 'right'} first); bound by the {order} "
                    f"order, {orders[order] / 1e6:.2f} MFLOP a token",
                    ms, plain_ms, lib_ms, "torch.matmul, dense reconstructed W",
                    nbytes, b * orders[order])

    def int4_phase(self, k_in, m, b, routes=(None,), bias=False):
        """``routes``: None takes the wrapper's route for B (the GEMV up to
        GEMV_MAX_B, the GEMM above), "gemv" / "gemm" force one (the crossover
        phases time both on the same weights and inputs); ``bias`` adds an f32
        bias to the epilogue (whisper's biased q/v)."""
        torch = self.torch
        from repro_torch.core.quant import dequantize_int4, quantize_int4
        from repro_torch.kernels import int4_matmul as k
        wbytes = m * k_in // 2
        copies = max(1, math.ceil(128e6 / wbytes))  # rotate weights past the 50 MB L2
        ws = [quantize_int4(self.randn(m, k_in, scale=1 / math.sqrt(k_in)), 128)
              for _ in range(copies)]
        x = self.randn(b, k_in, dtype=torch.bfloat16)
        epi = dict(residual=self.randn(b, m, dtype=torch.bfloat16)) if m < k_in else (
            dict(activation="silu") if m > k_in else {})
        if bias:
            epi["bias"] = self.randn(m, scale=0.1)
        want = k.int4_matmul_ref(x, ws[0]["qweight"], ws[0]["scales"], 128, **epi)

        def run(i, fn=k.int4_matmul):
            w = ws[i % copies]
            return fn(x, w["qweight"], w["scales"], 128, **epi)

        plain_ms = self.time_ms(lambda i: run(i, k.int4_matmul_ref), iters=5)
        dq = [dequantize_int4(w).T.contiguous() for w in ws[:max(1, math.ceil(copies / 4))]]
        lib_ms = self.time_ms(lambda i: torch.matmul(x, dq[i % len(dq)]))
        del dq
        nbytes = 2 * x.numel() + wbytes + 2 * m * (k_in // 128) + 2 * b * m \
            + (2 * b * m if "residual" in epi else 0) + (4 * m if bias else 0)
        default = k.GEMV_MAX_B
        for route in routes:
            k.GEMV_MAX_B = {None: default, "gemv": 8 * k.GEMV_MAX_NT, "gemm": 0}[route]
            try:
                gemv = b <= k.GEMV_MAX_B
                got = run(0)
                ms = self.time_ms(run)
            finally:
                k.GEMV_MAX_B = default
            if gemv:
                p = k.gemv_plan(b, k_in, m, 128)
                how = (f"GEMV: {p.ctas} CTAs of {p.warps} warps, {p.split.splits} K slices "
                       f"of {p.split.per_k}")
            else:
                how = "wgmma GEMM"
            self.record("int4_matmul", f"{k_in}->{m} B={b}" + (" bias" if bias else "")
                        + (f" route {route}" if route else ""),
                        got, want, 1e-2,
                        f"bf16 output rounding; products are exact and summed in f32 in both; "
                        f"{how}", ms, plain_ms, lib_ms, "torch.matmul, dequantized bf16 W",
                        nbytes, 2.0 * b * k_in * m)

    def _pool(self, nb, hkv, int8, dh=128):
        torch = self.torch
        shape = (nb, 16, hkv, dh)
        if not int8:
            return {"k": self.randn(*shape, dtype=torch.bfloat16),
                    "v": self.randn(*shape, dtype=torch.bfloat16)}
        cache = {}
        for nm in ("k", "v"):
            x = self.randn(*shape)
            sc = x.abs().amax(-1).clamp(min=1e-8) / 127.0
            cache[nm] = torch.round(x / sc[..., None]).to(torch.int8)
            cache[nm + "_scale"] = sc
        return cache

    def attn_phase(self, decode, hkv, int8, h=32, w=128, sq=256, dh=128):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.kernels import prefill_attention as pf
        np = self.np
        b, bs = 8, 16
        nb = 1 + b * w
        cache = self._pool(nb, hkv, int8, dh)
        bt = (torch.randperm(nb - 1, generator=self.gen, device=self.dev)[:b * w]
              .reshape(b, w).to(torch.int32) + 1)
        if decode:
            ctx = self.rng.integers(64, min(1600, w * bs), b)  # context incl. the new token
            qpos_np = (ctx - 1)[:, None]
        else:  # 4 prompts at different chunk offsets, 4 idle slots riding along
            qpos_np = np.full((b, sq), -1)
            for row, start in enumerate((0, sq, 3 * sq, 5 * sq)):
                qpos_np[row] = start + np.arange(sq)
        qpos = torch.from_numpy(qpos_np.astype(np.int32)).to(self.dev)
        sq = qpos.shape[1]
        q = self.randn(b, sq, h, dh, dtype=torch.bfloat16)
        if decode:
            q1, p1 = q[:, 0].contiguous(), qpos[:, 0].contiguous()
            fn = lambda i: pa.paged_attention(q1, cache, bt, p1)  # noqa: E731
            ref = lambda i: pa.paged_attention_ref(q1, cache, bt, p1)  # noqa: E731
        else:
            fn = lambda i: pf.prefill_attention(q, qpos, cache=cache, block_tables=bt)  # noqa: E731
            ref = lambda i: pf.prefill_attention_ref(q, qpos, cache=cache, block_tables=bt)  # noqa: E731
        got, want = fn(0), ref(0)
        ms = self.time_ms(fn)
        plain_ms = self.time_ms(ref, iters=3)
        kg, vg = pa.gather_paged_kv(cache, bt)
        kmax = int(qpos.max().item()) + 1
        kg = kg[:, :kmax].to(torch.bfloat16).transpose(1, 2).contiguous()
        vg = vg[:, :kmax].to(torch.bfloat16).transpose(1, 2).contiguous()
        mask = (torch.arange(kmax, device=self.dev)[None, None, :] <= qpos[:, :, None])[:, None]
        qt = q.transpose(1, 2).contiguous()
        lib_ms = self.time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=hkv != h))
        del kg, vg
        visible = np.where(qpos_np >= 0, qpos_np + 1, 0)
        ctx = (qpos_np.max(axis=1) + 1).clip(min=0)  # keys each sequence reads
        elt = 1 if int8 else 2
        # q is read only for live rows (qpos >= 0); the whole output is written
        nbytes = (2 * h * dh * (qpos_np >= 0).sum() + 2 * q.numel()
                  + 2 * ctx.sum() * hkv * dh * elt + (2 * 4 * ctx.sum() * hkv if int8 else 0)
                  + 4 * (-(-ctx // bs)).sum() + 4 * qpos.numel())
        flops = 4.0 * visible.sum() * h * dh
        name = "paged_attention" if decode else "prefill_attention"
        label = f"{'decode B=8' if decode else f'prefill B=8 Sq={sq}'} H{h}/Hkv{hkv}/Dh{dh} " \
                f"{'int8' if int8 else 'bf16'} pool"
        if decode:
            splits, kps = pa.decode_plan(w * bs)
            live = int(sum(min(splits, int(n - 1) // kps + 1) for n in ctx))
            print(f"[{name}] {label}: {splits} splits of {kps} entries a (sequence, head "
                  f"tile), {live * hkv * (h // hkv // pa.head_tile(h // hkv))} CTAs live of "
                  f"{b * splits * hkv * (h // hkv // pa.head_tile(h // hkv))}; one launch, the "
                  f"merge in it", flush=True)
        else:
            self.tile_count(name, label, pf.tiles_walked(qpos, h, hkv))
        self.record(name, label, got, want, "rows",
                    "bf16 output rounding; both read the same pool values", ms, plain_ms,
                    lib_ms, "scaled_dot_product_attention on the gathered context",
                    nbytes, flops)
        # The criterion must see a kernel that skips the last block of a long
        # row: the longest row's 16 newest keys dropped has to fail it.
        row = int(np.argmax(ctx))
        k, v = pa.gather_paged_kv(cache, bt[row:row + 1])
        kpos = torch.arange(k.shape[1], dtype=torch.int32, device=self.dev)[None]
        want_row = want[row:row + 1] if not decode else want[row][None, None]
        self.dropped_keys_check(name, label, q[row:row + 1], k, v, qpos[row:row + 1], kpos,
                                want_row, int(ctx[row]))

    def tile_count(self, name, label, counts):
        """The key tiles the flash tile walks in a prefill phase, from the
        launch's arguments (``tiles_walked``: the same rule as the kernel),
        against the tiles its CTAs would walk without the rule."""
        walked, total = counts
        print(f"[{name}] {label}: {walked} key tiles walked of {total} "
              f"({walked / max(total, 1):.3f}); the rest skipped unread", flush=True)

    def dropped_keys_check(self, name, label, q, k, v, qpos, kpos, want, n_keys, window=0,
                           k_scale=None, v_scale=None):
        """Plain attention of one sequence with the 16 newest keys it sees
        left out — what a kernel that stops a tile early would return — must
        fail the element-wise criterion against ``want``."""
        from repro_torch.kernels.paged_attention import ring_attention_plain
        cut = int(qpos.max().item()) + 1 - 16
        kpos = kpos.clone()
        kpos[kpos >= cut] = -1
        short = ring_attention_plain(q, k, v, qpos, kpos, window=window, k_scale=k_scale,
                                     v_scale=v_scale)
        ratio = self.row_ratio(short, want)
        print(f"[{name}] {label}: the longest row ({n_keys} keys) with its 16 newest keys "
              f"dropped sits at {ratio:.2f} of the tolerance (must exceed 1)", flush=True)
        if not ratio > 1.0:
            self.failures.append(f"{name} {label}: tolerance blind to dropped keys")

    def ring_phase(self, label, sq, h, hkv, dh, window, wr, int8, ctx):
        """The ring kernel over 8 per-slot rings, each holding the last
        min(n, WR) positions of its context n in ring order (a context past
        WR has wrapped, n = 0 is an idle slot), with the queries of the chunk
        (or decode token) that ends at n."""
        torch, np = self.torch, self.np
        import torch.nn.functional as F
        from repro_torch.kernels import prefill_attention as pf
        b = len(ctx)
        kpos_np, qpos_np = np.full((b, wr), -1), np.full((b, sq), -1)
        for i, n in enumerate(ctx):
            p = np.arange(max(0, n - wr), n)
            kpos_np[i, p % wr] = p
            m = min(n, sq)
            qpos_np[i, :m] = np.arange(n - m, n)
        kpos = torch.from_numpy(kpos_np.astype(np.int32)).to(self.dev)
        qpos = torch.from_numpy(qpos_np.astype(np.int32)).to(self.dev)
        kf, vf = self.randn(b, wr, hkv, dh), self.randn(b, wr, hkv, dh)
        ring = {}
        for nm, x in (("k", kf), ("v", vf)):
            if int8:
                sc = x.abs().amax(-1).clamp(min=1e-8) / 127.0
                ring[nm] = torch.round(x / sc[..., None]).to(torch.int8)
                ring[nm + "_scale"] = sc
            else:
                ring[nm] = x.to(torch.bfloat16)
        del kf, vf
        q = self.randn(b, sq, h, dh, dtype=torch.bfloat16)
        kw = dict(k=ring["k"], v=ring["v"], kpos=kpos, window=window,
                  k_scale=ring.get("k_scale"), v_scale=ring.get("v_scale"))
        fn = lambda i: pf.ring_attention(q, qpos, **kw)  # noqa: E731
        ref = lambda i: pf.ring_attention_ref(q, qpos, **kw)  # noqa: E731
        got, want = fn(0), ref(0)
        ms = self.time_ms(fn)
        plain_ms = self.time_ms(ref, iters=3)
        vis_np = (kpos_np[:, None, :] >= 0) & (qpos_np[:, :, None] >= 0) \
            & (kpos_np[:, None, :] <= qpos_np[:, :, None])
        if window:
            vis_np &= qpos_np[:, :, None] - kpos_np[:, None, :] < window
        vis = torch.from_numpy(vis_np).to(self.dev)
        kb, vb = (ring[nm].float() * ring[nm + "_scale"][..., None] if int8 else ring[nm]
                  for nm in ("k", "v"))
        kb, vb = (x.to(torch.bfloat16).transpose(1, 2).contiguous() for x in (kb, vb))
        qt = q.transpose(1, 2).contiguous()
        lib_ms = self.time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kb, vb, attn_mask=vis[:, None], enable_gqa=hkv != h))
        del kb, vb
        # each key visible to some live query of its sequence is read once
        need = vis_np.any(axis=1).sum()
        elt = 1 if int8 else 2
        nbytes = (2 * h * dh * (qpos_np >= 0).sum() + 2 * q.numel()
                  + 2 * need * hkv * dh * elt + (2 * 4 * need * hkv if int8 else 0)
                  + 4 * kpos.numel() + 4 * qpos.numel())
        flops = 4.0 * vis_np.sum() * h * dh
        label = f"{label} B={b} Sq={sq} H{h}/Hkv{hkv}/Dh{dh} WR={wr} window={window} " \
                f"{'int8' if int8 else 'bf16'} rings, contexts {list(ctx)}"
        if sq > 1:
            self.tile_count("ring_attention", label,
                            pf.tiles_walked(qpos, h, hkv, kpos, window=window))
        else:
            print(f"[ring_attention] {label}: {pf.decode_splits(b, wr, hkv)} splits of the "
                  f"ring, then the combine launch", flush=True)
        self.record("ring_attention", label, got, want, "rows",
                    "bf16 output rounding; both read the same ring values", ms, plain_ms,
                    lib_ms, "scaled_dot_product_attention over the ring with the "
                    "visibility mask", nbytes, flops)
        row = int(vis_np.sum(axis=(1, 2)).argmax())  # the row with the most keys
        sl = slice(row, row + 1)
        self.dropped_keys_check("ring_attention", label, q[sl], ring["k"][sl], ring["v"][sl],
                                qpos[sl], kpos[sl], want[sl], ctx[row], window=window,
                                k_scale=ring["k_scale"][sl] if int8 else None,
                                v_scale=ring["v_scale"][sl] if int8 else None)

    def rglru_phase(self, s):
        """The RG-LRU scan at B 8, W 2560 over S steps (S = 1: decode): slot 1
        idle, slots 2 and 3 tail-padded (S > 1).  Real steps are held to a
        tolerance, pad steps and idle rows bitwise."""
        torch = self.torch
        from repro_torch.kernels import scan_rglru as k
        b, w = 8, 2560
        log_a = -8.0 * math.log1p(math.exp(0.7)) * torch.sigmoid(self.randn(b, s, w))
        gx, h0 = self.randn(b, s, w), self.randn(b, w)
        pos = torch.arange(s, device=self.dev, dtype=torch.int32)[None].repeat(b, 1)
        pos[1] = -1
        if s > 1:
            pos[2, 100:] = -1
            pos[3, 200:] = -1
        bf16 = torch.bfloat16

        def run(i, fn=k.rglru_scan):
            return fn(log_a, gx, h0, pos, scan_dtype=bf16)

        (h, last), (hw, lw) = run(0), run(0, k.rglru_scan_ref)
        ms = self.time_ms(run)
        plain_ms = self.time_ms(lambda i: run(i, k.rglru_scan_ref), iters=3)
        bitwise = {"idle row h_last == h0": torch.equal(last[1], h0[1]),
                   "idle row h == h0": torch.equal(h[1], h0[1].to(bf16).expand(s, w))}
        if s > 1:
            bitwise["padded tail h == last real h"] = torch.equal(
                h[2, 100:], h[2, 99:100].expand(s - 100, w))
        last_err = (last - lw).abs().max().item() / lw.abs().max().item()
        real = int((pos >= 0).sum())
        nbytes = 2 * 4 * real * w + 4 * b * w + 4 * pos.numel() + 2 * b * s * w + 4 * b * w
        label = f"{'decode' if s == 1 else 'prefill'} B={b} S={s} W={w} f32 in, bf16 h"
        print(f"[rglru_scan] {label}: bitwise {bitwise}; h_last max|d|/max|want| "
              f"{last_err:.2e} (tol 1e-5: f32 state, expf/sqrtf vs torch's exp/sqrt)",
              flush=True)
        for what, good in bitwise.items():
            if not good:
                self.failures.append(f"rglru_scan {label}: {what} not bitwise")
        if not last_err <= 1e-5:
            self.failures.append(f"rglru_scan {label}: h_last {last_err}")
        self.record("rglru_scan", label, h, hw, 2.0 ** -7,
                    "bf16 h: one rounding of an f32 state that differs by ~1 f32 ulp a step",
                    ms, plain_ms, None, "none: torch has no linear-recurrence scan op",
                    nbytes, 8.0 * real * w, F32_FLOPS)


    def rglru_gated_phase(self, s):
        """The fused entry at griffin's shapes (B 8, W 2560, bf16 operands and
        a bf16 lambda) over S steps (S = 1: decode), h_last written in place
        into the state: slot 1 idle, slots 2 and 3 tail-padded (S > 1).  y is
        held to a tolerance, h_last too, and the idle row's state bitwise."""
        torch = self.torch
        from repro_torch.kernels import scan_rglru as k
        b, w = 8, 2560
        bf16 = torch.bfloat16
        ga, gxp, u, g = (self.randn(b, s, w, dtype=bf16) for _ in range(4))
        lam = self.randn(w, scale=0.5).add_(0.7).to(bf16)
        h0 = self.randn(b, w)
        pos = torch.arange(s, device=self.dev, dtype=torch.int32)[None].repeat(b, 1)
        pos[1] = -1
        if s > 1:
            pos[2, 100:] = -1
            pos[3, 200:] = -1
        state = h0.clone()

        def run(i, fn=k.rg_lru_gated):
            return fn(ga, gxp, u, lam, g, state, pos, h_out=state)

        y, last = run(0)
        last = last.clone()
        state.copy_(h0)
        yw, lw = run(0, k.rg_lru_gated_ref)
        lw = lw.clone()
        ms = self.time_ms(run)
        plain_ms = self.time_ms(lambda i: run(i, k.rg_lru_gated_ref), iters=3)
        bitwise = {"idle row h_last == h0": torch.equal(last[1], h0[1])}
        last_err = (last - lw).abs().max().item() / lw.abs().max().item()
        real = int((pos >= 0).sum())
        # ga, gxp, u of real steps, g and y of every step (bf16); lambda; h0, h_last; pos
        nbytes = 3 * 2 * real * w + 2 * 2 * b * s * w + 2 * w + 2 * 4 * b * w + 4 * pos.numel()
        # a real step: 2 sigmoids (~4 each), log a and gx (2), the pair (~6), the scan's
        # prefix, walk and fix-up (~6); every step: gelu_tanh (~8) and the product (2)
        flops = 22.0 * real * w + 10.0 * b * s * w
        label = (f"gated {'decode' if s == 1 else 'prefill'} B={b} S={s} W={w} bf16 ga/gxp/u/g, "
                 f"bf16 y, h_last in place")
        print(f"[rglru_scan] {label}: bitwise {bitwise}; h_last max|d|/max|want| "
              f"{last_err:.2e} (tol 1e-5)", flush=True)
        for what, good in bitwise.items():
            if not good:
                self.failures.append(f"rglru_scan {label}: {what} not bitwise")
        if not last_err <= 1e-5:
            self.failures.append(f"rglru_scan {label}: h_last {last_err}")
        self.record("rglru_scan", label, y, yw, 2.0 ** -7,
                    "bf16 y: one rounding each of h and gelu(g); h as in the scan phases",
                    ms, plain_ms, None, "none: torch has no linear-recurrence scan op",
                    nbytes, flops, F32_FLOPS)

    def tt_embed_phase(self, spec, t):
        """TT embedding rows of T ids at llama2-7b's embed spec (bf16 cores),
        four of them out of range (-1, -V-3, V, V+7).  Held element by element
        (1e-5 * row max|want| + 1e-5 * |want|): both sides are f32 chains of
        the same products over r, summed in other orders."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import tt_embed as k
        cores = [self.randn(*s, dtype=torch.bfloat16, scale=1 / math.sqrt(s[0]))
                 for s in spec.core_matrix_shapes()]
        v = spec.n_out
        ids = torch.randint(0, v, (t,), generator=self.gen, device=self.dev, dtype=torch.int32)
        ids[:4] = torch.tensor([-1, -v - 3, v, v + 7], dtype=torch.int32)
        got, want = k.tt_embed(ids, cores, spec), k.tt_embed_ref(ids, cores, spec)
        ms = self.time_ms(lambda i: k.tt_embed(ids, cores, spec))
        plain_ms = self.time_ms(lambda i: k.tt_embed_ref(ids, cores, spec), iters=5)
        table = k.tt_embed_ref(torch.arange(v, device=self.dev), cores, spec)  # (V, D) f32
        ids_in = k.resolve_ids(ids, v)
        lib_ms = self.time_ms(lambda i: F.embedding(ids_in, table))
        del table
        label = f"llama2-7b embed T={t} V={v} D={spec.n_in} modes " \
                f"{spec.out_modes}x{spec.in_modes} r16 bf16 cores"
        ratio = self.row_ratio(got, want, atol=1e-5, rtol=1e-5)
        print(f"[tt_embed] {label}: worst element at {ratio:.3f} of its tolerance "
              f"(1e-05 * row max|want| + 1e-05 * |want|)", flush=True)
        if not ratio <= 1.0:
            self.failures.append(f"tt_embed {label}: element-wise ratio {ratio}")
        nbytes = 4 * t + 2 * spec.n_params() + 4 * t * spec.n_in
        self.record("tt_embed", label, got, want, 1e-5, "f32 chains of the same products, "
                    "summed in other orders", ms, plain_ms, lib_ms,
                    "F.embedding on the reconstructed f32 table", nbytes,
                    t * tt_row_flops(spec), F32_FLOPS)

    def wkv_phase(self, s, int8):
        """The wkv scan at rwkv6-7b's serve shapes (B 8, H 64, hd 64) over S
        steps (S = 1: decode), r/k/v bf16, w f32: slot 1 idle, slot 2
        tail-padded (S > 1), slot 3's decays all below the prefill floor
        (w ~ 1e-3 < e^-4.9), the others in (0.5, 1).  An f32 state's idle
        row comes back bitwise, an int8 one's payload and scale too; the
        int8 payload is held within one step of the plain version's."""
        torch = self.torch
        from repro_torch.kernels import scan_wkv as k
        b, h, hd = 8, 64, 64
        bf16 = torch.bfloat16
        r, kk, v = (self.randn(b, s, h, hd, dtype=bf16) for _ in range(3))
        w = 0.5 + 0.499 * torch.rand(b, s, h, hd, generator=self.gen, device=self.dev)
        w[3] = 5e-4 + 1.5e-3 * torch.rand(s, h, hd, generator=self.gen, device=self.dev)
        u = self.randn(h, hd, scale=0.5)
        state0 = self.randn(b, h, hd, hd)
        scale0 = None
        if int8:
            scale0 = state0.abs().amax(dim=(-2, -1)).clamp(min=1e-8) / 127.0
            state0 = torch.round(state0 / scale0[..., None, None]).to(torch.int8)
        pos = torch.arange(s, device=self.dev, dtype=torch.int32)[None].repeat(b, 1) + 300
        pos[1] = -1
        if s > 1:
            pos[2, 100:] = -1

        def run(i, fn=k.wkv_scan):
            return fn(r, kk, v, w, u, state0, pos, state_scale=scale0)

        (y, st, sc), (yw, stw, scw) = run(0), run(0, k.wkv_scan_ref)
        ms = self.time_ms(run)
        plain_ms = self.time_ms(lambda i: run(i, k.wkv_scan_ref), iters=3)
        bitwise = {"idle row state": torch.equal(st[1], state0[1])}
        if int8:
            bitwise["idle row scale"] = torch.equal(sc[1], scale0[1])
            step = (st.int() - stw.int()).abs().max().item()
            sc_err = ((sc - scw).abs() / scw).max().item()
            checks = {f"int8 payload within one step (max {step})": step <= 1,
                      f"scale within 1e-5 relative ({sc_err:.2e})": sc_err <= 1e-5}
        else:
            st_err = (st - stw).abs().max().item() / stw.abs().max().item()
            checks = {f"state within 1e-4 of max|want| ({st_err:.2e})": st_err <= 1e-4}
        real = int((pos >= 0).sum())
        n_steps = b * s
        elt = 1 if int8 else 4
        nbytes = (3 * 2 + 4 + 4) * n_steps * h * hd + 4 * h * hd + 4 * pos.numel() \
            + 2 * elt * b * h * hd * hd + (2 * 4 * b * h if int8 else 0)
        # per state element: a real step's output r_i S_ij (one FMA) and update
        # w_i S_ij + k_i v_j (3 ops); a padding step's output only.  The bonus
        # term v_j sum_i r_i u_i k_i is O(hd) a step and not counted.
        flops = (5.0 * real + 2.0 * (n_steps - real)) * h * hd * hd
        label = f"{'decode' if s == 1 else 'prefill'} B={b} S={s} H={h} hd={hd} bf16 r/k/v, " \
                f"{'int8' if int8 else 'f32'} state"
        print(f"[wkv_scan] {label}: bitwise {bitwise}; {checks}", flush=True)
        for what, good in list(bitwise.items()) + list(checks.items()):
            if not good:
                self.failures.append(f"wkv_scan {label}: {what}")
        why = ("f32 recurrence, the exact step on both sides" if s == 1 else
               "f32 recurrence: both sides take the chunked form with the floored decay, the "
               "kernel its four products a chunk on the tensor cores in 3xTF32")
        self.record("wkv_scan", label, y, yw, 1e-4, why, ms, plain_ms, None,
                    "none: torch has no op for a matrix-state linear recurrence",
                    nbytes, flops, F32_FLOPS)

    # -- MoE phases -----------------------------------------------------------
    def _expert_ids(self, t, e, k, how):
        """(T, K) expert ids: a seeded router's top-k ("router": random tokens
        and router weights in f32, softmax, stable top-k), every row on the
        last expert ("one expert"), or the rows on experts 0 and E/2 only
        ("most empty")."""
        torch = self.torch
        if how == "router":
            probs = torch.softmax(self.randn(t, 512) @ self.randn(512, e), -1)
            return torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
        if how == "one expert":
            return torch.full((t, k), e - 1, dtype=torch.long, device=self.dev)
        return torch.randint(0, 2, (t, k), generator=self.gen, device=self.dev) * (e // 2)

    def dense_experts(self, cores, spec):
        """The experts' reconstructed weights (E, M, N) bf16: each expert's TT
        in f32 on 2048-row slices of the identity."""
        torch = self.torch
        from repro_torch.kernels import tt_linear as kt
        w = torch.empty(cores[0].shape[0], spec.n_out, spec.n_in, dtype=torch.bfloat16,
                        device=self.dev)
        for i in range(w.shape[0]):
            ci = [c[i].float() for c in cores]
            for r0 in range(0, spec.n_in, 2048):
                rows = min(2048, spec.n_in - r0)
                eye = torch.zeros(rows, spec.n_in, device=self.dev)
                idx = torch.arange(rows, device=self.dev)
                eye[idx, r0 + idx] = 1.0
                w[i, :, r0:r0 + rows] = kt.tt_linear_ref(eye, ci, spec).T.to(torch.bfloat16)
        return w

    def grouped_library(self, x, offsets, w):
        """One PyTorch call of the same product on the reconstructed experts
        ``w`` (E, M, N): ``torch._grouped_mm`` where this torch has it, else
        ``torch.bmm`` over a capacity-padded (E, most rows, N) buffer."""
        torch = self.torch
        note = ""
        gm = getattr(torch, "_grouped_mm", None)
        if gm is not None:
            offs = offsets[1:].contiguous()
            try:
                gm(x, w.transpose(1, 2), offs=offs)
                return (self.time_ms(lambda i: gm(x, w.transpose(1, 2), offs=offs)),
                        "torch._grouped_mm on the reconstructed experts")
            except (RuntimeError, TypeError, ValueError) as err:
                note = f"torch._grouped_mm refused it ({str(err).splitlines()[0][:80]}); "
        counts = (offsets[1:] - offsets[:-1]).long()
        e, cap = w.shape[0], int(counts.max())
        if e * cap * x.shape[1] * 2 > 8 * 2 ** 30:
            return None, note + "none: the capacity-padded buffer would pass 8 GiB"
        eid = torch.repeat_interleave(torch.arange(e, device=self.dev), counts)
        pos = torch.arange(x.shape[0], device=self.dev) - offsets[:-1].long()[eid]
        buf = torch.zeros(e, cap, x.shape[1], dtype=x.dtype, device=self.dev)
        buf[eid, pos] = x
        wt = w.transpose(1, 2)
        return (self.time_ms(lambda i: torch.bmm(buf, wt)),
                note + f"torch.bmm over a capacity-padded ({e}, {cap}, N) buffer")

    def grouped_launch_ms(self, run, iters: int = 10):
        """Device ms a call of the grouped call's two launches, the operator
        pass and the contraction, from ``torch.profiler``."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        run(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                run(i)
            torch.cuda.synchronize()
        ops = con = 0.0
        for ev in kernel_events(prof):
            if "tt_ops_mma" in ev.key or "tt_operators" in ev.key:
                ops += ev.self_device_time_total
            elif "tt_wgmma" in ev.key or "tt_fused" in ev.key:
                con += ev.self_device_time_total
        return ops / iters / 1e3, con / iters / 1e3

    def tt_grouped_phases(self, arch, role, spec, e, k, cases):
        """The grouped kernel at an arch's expert spec (bf16 cores, E experts,
        top-k) for each (T tokens, routing) of ``cases``: T·K rows sorted by
        expert.  The bound counts the rows in and out, the cores of the
        experts with rows, and the rows times the cheapest order's
        operations."""
        torch = self.torch
        from repro_torch.kernels import tt_linear as kt
        from repro_torch.models.moe import sort_by_expert
        cores = [self.randn(e, *s, dtype=torch.bfloat16, scale=1 / math.sqrt(s[0]))
                 for s in spec.core_matrix_shapes()]
        w = self.dense_experts(cores, spec)
        act = "silu" if role == "gate" else None
        orders = kt.tt_order_flops(spec)
        order = min(orders, key=orders.get)
        plan = kt.contraction_plan(spec)
        per_expert = sum(c[0].numel() * c.element_size() for c in cores)
        for t, how in cases:
            _, offsets = sort_by_expert(self._expert_ids(t, e, k, how), e)
            r = t * k
            x = self.randn(r, spec.n_in, dtype=torch.bfloat16)

            def run(i, fn=kt.tt_linear_grouped):
                return fn(x, offsets, cores, spec, activation=act)

            g0 = kt.grouped_launches
            got = run(0)
            if kt.grouped_launches != g0 + 2:
                self.failures.append(f"tt_linear_grouped {arch} {role} T={t}: "
                                     f"{kt.grouped_launches - g0} launches, not 2")
            want = run(0, kt.tt_linear_grouped_ref)
            ms = self.time_ms(run)
            plain_ms = self.time_ms(lambda i: run(i, kt.tt_linear_grouped_ref), iters=3)
            lib_ms, lib_what = self.grouped_library(x, offsets, w)
            counts = (offsets[1:] - offsets[:-1]).tolist()
            active = sum(c > 0 for c in counts)
            gp = kt.grouped_plan(spec, r, e)
            tiles, slots = kt.grouped_tiles(offsets.tolist(), gp.tb)
            ops_ms, con_ms = self.grouped_launch_ms(run)
            label = (f"{arch} {role} E={e} top-{k} T={t} ({r} rows, {how}: {active} experts "
                     f"with rows, at most {max(counts)})")
            shape = (f"{gp.tb} rows a CTA tile ({gp.iw} a warpgroup), {gp.bms} MR columns a "
                     f"CTA, {gp.stages} stages, {gp.smem} bytes of shared memory"
                     if gp.route == "wgmma" else f"at most {gp.tb} rows a CTA tile")
            print(f"[tt_linear_grouped] {label}: route {gp.route}, {shape}, {len(tiles)} tiles "
                  f"of {slots} slots; operator pass on the "
                  f"{'tensor cores' if gp.ops_mma else 'CUDA cores'} over "
                  f"{len(kt.active_experts(offsets.tolist(), r))} experts; device ms a call "
                  f"(torch.profiler): operator pass {ops_ms:.4f}, contraction {con_ms:.4f}",
                  flush=True)
            self.record("tt_linear_grouped", label, got, want, 3e-2,
                        f"bf16: the plain version rounds each of the {spec.d} stages to bf16, "
                        f"the kernel its operators and its one intermediate (plan h={plan.h} "
                        f"{'left' if plan.left_first else 'right'} first); bound by the "
                        f"{order} order, {orders[order] / 1e6:.2f} MFLOP a row",
                        ms, plain_ms, lib_ms, lib_what,
                        2 * r * (spec.n_in + spec.n_out) + active * per_expert,
                        r * orders[order])
        del w
        torch.cuda.empty_cache()

    def int4_f32_phase(self, arch, k_in, m, b):
        """The router's int4 linear on f32 activations (f32 out)."""
        torch = self.torch
        from repro_torch.core.quant import dequantize_int4, quantize_int4
        from repro_torch.kernels import int4_matmul as k
        q = quantize_int4(self.randn(m, k_in, scale=1 / math.sqrt(k_in)), 128)
        x = self.randn(b, k_in)

        def run(i, fn=k.int4_matmul):
            return fn(x, q["qweight"], q["scales"], 128)

        f0 = k.f32_launches
        got = run(0)
        if k.f32_launches != f0 + 1 or got.dtype != torch.float32:
            self.failures.append(f"int4_matmul_f32 {k_in}->{m} B={b}: not the f32 route")
        want = run(0, k.int4_matmul_ref)
        ms = self.time_ms(run)
        plain_ms = self.time_ms(lambda i: run(i, k.int4_matmul_ref), iters=5)
        wt = dequantize_int4(q, torch.float32).T.contiguous()
        lib_ms = self.time_ms(lambda i: torch.matmul(x, wt))
        p = k.f32_plan(b, k_in, m, 128)
        nbytes = 4 * b * k_in + m * k_in // 2 + 2 * m * (k_in // 128) + 4 * b * m
        tf32_ms, tf32_by = bound(nbytes, 2 * 2.0 * b * k_in * m, TF32_FLOPS)
        self.record("int4_matmul_f32", f"{arch} router {k_in}->{m} B={b} f32 x, {p.ctas} CTAs "
                    f"({p.split.splits} K slices); two TF32 passes' bound {tf32_ms:.4f} ms "
                    f"({tf32_by})", got, want, 1e-4,
                    "f32-accurate products (x in tf32 hi + lo), sums in another order", ms,
                    plain_ms, lib_ms, "torch.matmul, dequantized f32 W", nbytes,
                    2.0 * b * k_in * m, F32_FLOPS)

    def route_flips(self, eids, eids_w, probs_w, k):
        """Tokens the two routes send to different sets of experts (an order
        swapped on a tie sums the same experts), and the largest distance of
        a differing expert's plain probability from the plain k-th largest,
        relative to it (0 when none differ)."""
        torch = self.torch
        flip = (eids.sort(-1).values != eids_w.sort(-1).values).any(-1)
        worst = 0.0
        for i in torch.nonzero(flip)[:, 0].tolist():
            kth = probs_w[i].sort(descending=True).values[k - 1]
            diff = set(eids[i].tolist()) ^ set(eids_w[i].tolist())
            worst = max(worst, max(abs(float(probs_w[i, j] - kth)) / float(kth) for j in diff))
        return flip, worst

    def moe_layer_phase(self, t):
        """One full-width kimi-k2-1t-a32b MoE layer (serving config: the int4
        router on f32 activations, 384 experts of bf16 TT cores, top-8) on T
        tokens, through the kernels against the plain versions.  A token may
        change experts only on a near-tie (its plain probabilities within
        1e-5 relative: the router's f32 sums differ in order only); tokens
        routed alike are held at 3e-2 of max|want|."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.kernels import dispatch
        from repro_torch.kernels import tt_linear as kt
        from repro_torch.models import moe, transformer
        from repro_torch.serve.steps import serve_config_of
        cfg = serve_config_of(get_config("kimi-k2-1t-a32b"))
        specs = transformer.make_block_specs(cfg, True).moe
        if getattr(self, "kimi_layer", None) is None:
            self.kimi_layer = moe.init_moe(cfg, specs, torch.bfloat16, generator=self.gen,
                                           device=self.dev)
        p = self.kimi_layer
        x = self.randn(1, t, cfg.d_model, dtype=torch.bfloat16)

        def run(i):
            return moe.apply_moe(p, x, specs, cfg, torch.bfloat16)[0]

        got = run(0)
        _, _, eids = moe.route(p, x[0], specs, cfg)
        with dispatch.force_plain():
            want = run(0)
            probs_w, _, eids_w = moe.route(p, x[0], specs, cfg)
            plain_ms = self.time_ms(run, iters=2)
        ms = self.time_ms(run, iters=10)
        flip, gap = self.route_flips(eids, eids_w, probs_w, cfg.experts_per_token)
        n_flip = int(flip.sum())
        if n_flip > 0.01 * t or gap > 1e-5:
            self.failures.append(f"moe_layer T={t}: {n_flip} tokens routed differently, "
                                 f"worst gap {gap:.2e}")
        counts = torch.zeros(cfg.n_experts, device=self.dev).index_add_(
            0, eids_w.reshape(-1), torch.ones(eids_w.numel(), device=self.dev))
        active = int((counts > 0).sum())
        sp = specs["expert"]
        flops_bf16 = t * cfg.experts_per_token * sum(
            min(kt.tt_order_flops(s.tt).values()) for s in sp.values())
        flops_f32 = 2.0 * t * cfg.d_model * cfg.n_experts
        core_bytes = sum(2 * s.tt.n_params() for s in sp.values())
        nbytes = (2 * 2 * t * cfg.d_model + cfg.d_model * cfg.n_experts // 2
                  + 2 * cfg.n_experts * cfg.d_model // 128 + active * core_bytes)
        label = (f"kimi-k2-1t-a32b layer T={t} D={cfg.d_model} E={cfg.n_experts} top-"
                 f"{cfg.experts_per_token}: {active} experts with rows, {n_flip} tokens routed "
                 f"differently (worst gap {gap:.1e} of the k-th probability)")
        self.record("moe_layer", label, got[0][~flip], want[0][~flip], 3e-2,
                    "bf16 TT experts as the tt_linear phases; router in f32", ms, plain_ms, None,
                    "none: no one PyTorch call computes an MoE layer", nbytes,
                    flops_bf16 + flops_f32 * BF16_FLOPS / F32_FLOPS)

    def moe_layerwise_check(self, cfg, params, prompts, max_len, path, n_layers=8,
                            decode_steps=4, layer_tol=2.0 ** -5):
        """An MoE path's check at the serve geometry on its first
        ``n_layers`` layers, layer by layer: every layer runs both routes on
        the plain route's input and K/V, as the rwkv check does, through the
        session's backend: rings (``transformer.ring_layer``, mixtral-8x22b)
        or a paged pool under the serve phase's block tables
        (``transformer._paged_body``, kimi-k2-1t-a32b).  Three comparisons
        a layer, each within ``layer_tol`` of max|ref|:

        * the kernel layer's output.  Its router sees an input that differs
          from the plain router's by the attention half's bf16 rounding, so
          a token may take other experts on a near-tie: such tokens are
          counted, each must be a near-tie (a differing expert's plain
          probability within 10% of the k-th), and every other real row is
          held to the tolerance;
        * the kernel attention half (norm, attention, output projection and
          skip) on every real row;
        * the kernel MoE half on the plain attention half's output: the two
          routers see the same input, so at most 2% of a layer's real rows
          may take other experts, each a near-tie, and every other row is
          held to the tolerance.  (With the inputs apart by rounding, 384
          experts top-8 leave gaps small enough that kimi-k2 moved 4.3% of
          its rows, and one row of a decode step's 8 is 12.5%.)

        The logits of the last layer's two outputs (final norm and head) are
        held to the other paths' criteria on the rows the kernel layer
        routed alike: every kept row, held whole (kimi-k2's 163840-entry
        vocabulary: ~2.9 GB of f32 logits a route at ~4.4 K prompt rows,
        room enough on the card)."""
        torch = self.torch
        from repro_torch.kernels import dispatch
        from repro_torch.models import moe, transformer
        from repro_torch.models.modules import (apply_norm, dt, embed_lookup, paged_write_index,
                                                ring_write_index)
        from repro_torch.models.sessions import default_backend
        lens, chunks, steps = self._check_inputs(cfg, prompts, decode_steps)
        cd = dt(cfg.compute_dtype)
        specs = transformer.make_block_specs(cfg, True)
        layers = params["segments"][0][:n_layers]
        backend = default_backend(cfg)
        if backend == "paged":  # the serve geometry's tables: slot i owns blocks i*W+1 ..
            width = max_len // 16
            bt = torch.arange(1, 1 + len(prompts) * width, dtype=torch.int32,
                              device=self.dev).reshape(len(prompts), width)
            caches = transformer.init_paged_cache(cfg.replace(n_layers=n_layers),
                                                  1 + len(prompts) * width, 16, torch.bfloat16,
                                                  device=self.dev)[0]
        else:
            caches = transformer.init_ring_cache(cfg.replace(n_layers=n_layers), len(prompts),
                                                 max_len, 256, torch.bfloat16,
                                                 device=self.dev)[0]

        def attn_half(lp, x, rope_cs, cache, pos, index):
            """The block's first half (norm, attention, output projection with
            the skip), as ``_paged_body`` and ``ring_layer`` run it."""
            h = apply_norm(lp["ln1"], x)
            if backend == "paged":
                a, _ = transformer.attn_paged(lp, specs, cfg, h, rope_cs, cache, bt, pos, index,
                                              cd, residual=x)
            else:
                a, _ = transformer.attn_ring(lp, specs, cfg, h, rope_cs, cache, pos, cd,
                                             residual=x, index=index)
            return a.to(x.dtype)

        def moe_half(lp, a):
            return transformer.ffn_block(lp, specs, cfg, a, cd)

        def rel(a, b):
            a, b = a.float(), b.float()
            return (a - b).abs().max().item() / b.abs().max().item()

        routes = []
        route = moe.route

        def recording(*a, **kw):
            out = route(*a, **kw)
            routes.append(out)
            return out

        # worst relative error and where: the whole kernel layer (over rows it
        # routes as the plain layer does), its attention half, and its MoE half
        # on the plain attention half's output (over rows routed alike)
        worst = {w: (0.0, None) for w in ("layer", "attention", "moe")}
        flips = {"layer": 0, "moe": 0}
        rows, gap_worst = 0, 0.0
        logits = {"prefill": ([], []), "decode": ([], [])}
        moe.route = recording
        try:
            for kind, calls in (("prefill", chunks),
                                ("decode", [(t, p[:, None]) for t, p in steps])):
                for ci, (tok, pos) in enumerate(calls):
                    pos = pos.to(torch.int32).contiguous()
                    x = embed_lookup(params["embed"], tok, cd, cfg)
                    rope_cs = transformer._paged_rope(cfg, pos)
                    index = paged_write_index(bt, pos, 16) if backend == "paged" else \
                        ring_write_index(pos, caches[0]["k"].shape[1])
                    real = (pos >= 0).reshape(-1)
                    for li, (lp, cache) in enumerate(zip(layers, caches)):
                        where = f"{kind} {ci} layer {li}"
                        mine = {k: v.clone() for k, v in cache.items()}
                        routes.clear()
                        ak = attn_half(lp, x, rope_cs, mine, pos, index)
                        with dispatch.force_plain():
                            a = attn_half(lp, x, rope_cs, cache, pos, index)
                        xk = moe_half(lp, ak)   # the kernel layer
                        yk = moe_half(lp, a)    # its MoE half on the plain route's input
                        with dispatch.force_plain():
                            x = moe_half(lp, a)
                        (_, _, e_layer), (_, _, e_half), (pw, _, ew) = routes
                        rows += int(real.sum())
                        keep = {}
                        for what, ek in (("layer", e_layer), ("moe", e_half)):
                            flip, gap = self.route_flips(ek[real], ew[real], pw[real],
                                                         cfg.experts_per_token)
                            keep[what] = real.clone()
                            keep[what][real] = ~flip
                            flips[what] += int(flip.sum())
                            gap_worst = max(gap_worst, gap)
                        n_half = int((real & ~keep["moe"]).sum())
                        if n_half > 0.02 * real.sum():
                            self.failures.append(f"{path}: {n_half} of {int(real.sum())} rows "
                                                 f"routed differently by the MoE half at {where}")
                        for what, got, want, sel in (
                                ("layer", xk, x, keep["layer"]), ("attention", ak, a, real),
                                ("moe", yk, x, keep["moe"])):
                            r = rel(got.reshape(-1, cfg.d_model)[sel],
                                    want.reshape(-1, cfg.d_model)[sel])
                            if not r <= worst[what][0]:
                                worst[what] = (r, where)
                    for route_rows, y in zip(logits[kind], (xk, x)):
                        h = apply_norm(params["final_norm"], y)
                        h = h.reshape(-1, cfg.d_model)[keep["layer"]]
                        route_rows.append(transformer.logits_from_hidden(params, cfg, h))
        finally:
            moe.route = route
        geometry = f"prompts {lens.tolist()} in {len(chunks)} chunks of 256, {len(steps)} " \
                   f"decode steps x {len(prompts)} slots"
        good = all(math.isfinite(r) and r <= layer_tol for r, _ in worst.values()) \
            and gap_worst <= 0.1
        print(f"[layers {path}] the first {n_layers} of {cfg.n_layers} layers (the depth cut "
              f"for the plain route's time; serve and profile run all {cfg.n_layers}), "
              f"{'over the paged pool, ' if backend == 'paged' else ''}kernels "
              f"vs plain on the plain route's input: layer output max|d|/max|ref|="
              f"{worst['layer'][0]:.4f} at {worst['layer'][1]} (tol {layer_tol:g}) over rows "
              f"routed alike; {flips['layer']} of {rows} (row, layer) pairs routed differently "
              f"(the routers' inputs differ by the attention half's rounding); each half on "
              f"the plain route's input: attention half {worst['attention'][0]:.4f} at "
              f"{worst['attention'][1]}, MoE half {worst['moe'][0]:.4f} at {worst['moe'][1]} "
              f"over rows routed alike (tol {layer_tol:g}), {flips['moe']} pairs routed "
              f"differently (tol 2% a layer); worst gap {gap_worst:.3f} of the k-th "
              f"probability (tol 0.1) {'ok' if good else 'FAIL'}", flush=True)
        ok = good
        for kind, (k_rows, p_rows) in logits.items():
            ok &= self.compare_logits(path, torch.cat(k_rows), torch.cat(p_rows),
                                      f"{kind}, layer {n_layers - 1} on the plain route's input, "
                                      f"final norm and head ({geometry})")
        del logits, caches
        torch.cuda.empty_cache()
        if not ok:
            self.failures.append(f"{path} full-width layer-by-layer check")

    # -- logits check ---------------------------------------------------------
    def session(self, cfg, max_len):
        """The serving session of ``cfg`` at the serve geometry (8 slots,
        256-token chunks, bf16 cache) with its initial state."""
        from repro_torch.models.sessions import SessionSpec, make_session
        sess = make_session(cfg, SessionSpec(slots=8, max_len=max_len, prefill_chunk=256,
                                             block_size=16, cache_dtype="bfloat16"),
                            device=self.dev)
        width = max_len // 16
        bt = self.np.arange(1, 1 + 8 * width, dtype=self.np.int32).reshape(8, width)
        return sess, sess.with_tables(sess.init_state(), bt)

    def _prefill_tiles(self, prompts):
        """The serve geometry's prefill tiles: (the prompt lengths, a (tokens,
        positions) pair of (slots, 256) a chunk, -1 = padding)."""
        torch, np = self.torch, self.np
        slots, chunk = len(prompts), 256
        lens = np.array([len(p) for p in prompts])
        n_chunks = -(-int(lens.max()) // chunk)
        toks = np.zeros((slots, n_chunks * chunk), np.int32)
        pos = np.full((slots, n_chunks * chunk), -1, np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)], pos[i, :len(p)] = p, np.arange(len(p))
        toks, pos = (torch.from_numpy(a).to(self.dev) for a in (toks, pos))
        return lens, [(toks[:, c * chunk:(c + 1) * chunk].contiguous(),
                       pos[:, c * chunk:(c + 1) * chunk].contiguous()) for c in range(n_chunks)]

    def _check_inputs(self, cfg, prompts, decode_steps):
        """The serve geometry's prefill tiles (:meth:`_prefill_tiles`) and
        ``decode_steps`` decode steps of fixed random tokens."""
        torch, np = self.torch, self.np
        slots = len(prompts)
        lens, chunks = self._prefill_tiles(prompts)
        dec_toks = torch.from_numpy(self.rng.integers(0, cfg.vocab_size, (decode_steps, slots))
                                    .astype(np.int32)).to(self.dev)
        dec_pos = torch.from_numpy(lens.astype(np.int32)).to(self.dev)
        steps = [(dec_toks[i][:, None].contiguous(), dec_pos + i) for i in range(decode_steps)]
        return lens, chunks, steps

    def compare_logits(self, path, kernel, plain, what):
        """Kernel-route logits against plain-route logits, (rows, V) each:
        max|d|/max|ref| <= 0.1, mean|d|/mean|ref| <= 0.05, and the kernel
        route's greedy token a top token of the plain route's within 0.05 of
        max|ref| (random weights give near-ties that may flip)."""
        a, b = kernel, plain
        scale = b.abs().max().item()
        rel = (a - b).abs().max().item() / scale
        mean_rel = (a - b).abs().mean().item() / b.abs().mean().item()
        pick = a.argmax(-1, keepdim=True)
        gap = ((b.max(-1).values - b.gather(-1, pick)[:, 0]).max().item()) / scale
        agree = (pick[:, 0] == b.argmax(-1)).float().mean().item()
        good = all(map(math.isfinite, (rel, mean_rel, gap))) and rel <= 0.1 and \
            mean_rel <= 0.05 and gap <= 0.05
        print(f"[logits {path}] {what}: max|d|/max|ref|={rel:.4f} (tol 0.1) "
              f"mean|d|/mean|ref|={mean_rel:.4f} (tol 0.05) greedy-token logit gap "
              f"{gap:.4f} of max|ref| (tol 0.05; argmax agreement {agree:.3f}) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        return good

    def compare_ctx(self, path, kernel, plain, what):
        """Kernel-route against plain-route values by the logits check's first
        two criteria: max|d|/max|ref| <= 0.1 and mean|d|/mean|ref| <= 0.05."""
        a, b = kernel.float(), plain.float()
        rel = (a - b).abs().max().item() / b.abs().max().item()
        mean_rel = (a - b).abs().mean().item() / b.abs().mean().item()
        good = all(map(math.isfinite, (rel, mean_rel))) and rel <= 0.1 and mean_rel <= 0.05
        print(f"[logits {path}] {what}: max|d|/max|ref|={rel:.4f} (tol 0.1) "
              f"mean|d|/mean|ref|={mean_rel:.4f} (tol 0.05) {'ok' if good else 'FAIL'}",
              flush=True)
        return good

    def logits_check(self, cfg, params, prompts, max_len, every_position, path,
                     decode_steps=4, frames=None):
        """The serve phase's geometry (8 slots, its prompts in 256-token
        chunks, then ``decode_steps`` decode steps on fixed random tokens)
        through the kernels and through the plain versions.  The logits of
        every prompt position are compared, or with ``every_position`` off
        (a 256000-token vocabulary) those of each row's last position in
        each chunk, and the logits of every decode step.  bf16 through every
        layer: kernels and plain versions sum in different orders, so their
        bf16 roundings differ and the differences compound layer by layer.
        An enc-dec session first runs each slot's begin step on ``frames``
        (a (T_enc, D) tensor a slot), and the encoder contexts it writes
        (``encode_ctx``'s cross K/V) are compared too."""
        torch = self.torch
        from repro_torch.kernels import dispatch
        lens, chunks, steps = self._check_inputs(cfg, prompts, decode_steps)
        out, ctx = {}, {}
        for plain in (False, True):
            sess, state = self.session(cfg, max_len)
            pre, dec = [], []
            with dispatch.force_plain() if plain else contextlib.nullcontext():
                if frames is not None:
                    for slot, f in enumerate(frames):
                        state = sess.begin_sequence(params, state, slot, f[None])
                    ctx[plain] = state["cross"]
                for tok, pos in chunks:
                    real = pos >= 0
                    if every_position:
                        lg, state = sess.prefill_chunk(params, state, tok, pos)
                        pre.append(lg[real])
                    else:
                        cols = (real.sum(1) - 1).clamp(min=0)
                        lg, state = sess.prefill_chunk(params, state, tok, pos, logit_cols=cols)
                        pre.append(lg[real.any(1)])
                for tok, pos in steps:
                    lg, state = sess.decode_step(params, state, tok, pos)
                    dec.append(lg)
            out[plain] = (torch.cat(pre), torch.cat(dec))
            del state, pre, dec
            torch.cuda.empty_cache()
        which = "every prompt position" if every_position else "each row's last position per chunk"
        geometry = f"prompts {lens.tolist()} in {len(chunks)} chunks of 256, {len(steps)} " \
                   f"decode steps x {len(prompts)} slots, bf16 through {cfg.n_layers} layers"
        ok = True
        for nm in ("k", "v") if ctx else ():
            ok &= self.compare_ctx(path, ctx[False][nm], ctx[True][nm],
                                   f"encoder context {nm} {tuple(ctx[True][nm].shape)} f32 "
                                   f"after {cfg.n_enc_layers} bf16 encoder layers")
        for k, name in enumerate(("prefill", "decode")):
            rows = f"{out[True][k].shape[0]} rows: {which if k == 0 else 'every step'}"
            ok &= self.compare_logits(path, out[False][k], out[True][k],
                                      f"{name} ({rows}; {geometry})")
        del out, ctx
        torch.cuda.empty_cache()
        if not ok:
            self.failures.append(f"{path} full-width logits check")

    def layerwise_check(self, cfg, params, prompts, path, decode_steps=4, layer_tol=2.0 ** -5):
        """rwkv6-7b's check at the serve geometry, layer by layer.  With random
        weights this model amplifies any rounding difference through its 32
        bf16 layers, so an end-to-end comparison cannot separate a faulty
        kernel from rounding (measured in PERF.md).  Here every layer runs both
        routes through ``rwkv.session_layer`` on the plain route's input and
        state: each layer's output and new wkv state must sit within
        ``layer_tol`` of max|ref| (8 bf16 ulps: a layer rounds its linears'
        outputs, the scan's normalized output and the gates to bf16), and
        the logits of the last layer's two outputs are held to the criteria
        of the other paths."""
        torch = self.torch
        from repro_torch.kernels import dispatch
        from repro_torch.models import rwkv
        from repro_torch.models.modules import dt, embed_lookup
        lens, chunks, steps = self._check_inputs(cfg, prompts, decode_steps)
        cd = dt(cfg.compute_dtype)
        specs = rwkv.rwkv_specs(cfg)
        state = rwkv.init_session_state(cfg, len(prompts), torch.bfloat16, device=self.dev)
        worst = {"layer output": (0.0, None), "wkv state": (0.0, None)}
        logits = {"prefill": ([], []), "decode": ([], [])}
        for kind, calls in (("prefill", chunks), ("decode", [(t, p[:, None]) for t, p in steps])):
            for ci, (tok, pos) in enumerate(calls):
                x = embed_lookup(params["embed"], tok, cd)
                real = pos >= 0
                for li, (p, st) in enumerate(zip(params["blocks"], state)):
                    mine = {k: t.clone() for k, t in st.items()}
                    xk = rwkv.session_layer(p, specs, cfg, x, mine, cd, pos)
                    with dispatch.force_plain():
                        x = rwkv.session_layer(p, specs, cfg, x, st, cd, pos)
                    for what, a, b in (("layer output", xk[real], x[real]),
                                       ("wkv state", mine["wkv"], st["wkv"])):
                        r = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                        if not r <= worst[what][0]:
                            worst[what] = (r, f"{kind} {ci} layer {li}")
                for route, y in zip(logits[kind], (xk, x)):
                    route.append(rwkv.session_logits(params, cfg, y)[real])
        geometry = f"prompts {lens.tolist()} in {len(chunks)} chunks of 256, {len(steps)} " \
                   f"decode steps x {len(prompts)} slots"
        ok = True
        for what, (r, where) in worst.items():
            good = math.isfinite(r) and r <= layer_tol
            ok &= good
            print(f"[layers {path}] {what}, kernels vs plain on the plain route's input, worst "
                  f"over {cfg.n_layers} layers x {len(chunks)} chunks + {len(steps)} decode steps: "
                  f"max|d|/max|ref|={r:.4f} at {where} (tol {layer_tol:g}) "
                  f"{'ok' if good else 'FAIL'}", flush=True)
        for kind, (k_rows, p_rows) in logits.items():
            ok &= self.compare_logits(path, torch.cat(k_rows), torch.cat(p_rows),
                                      f"{kind}, last layer on the plain route's input "
                                      f"({geometry})")
        del logits, state
        torch.cuda.empty_cache()
        if not ok:
            self.failures.append(f"{path} full-width layer-by-layer check")

    def seeded_biases(self, params):
        """Fill every bias leaf (a linear's ``b``, a layernorm's ``bias``)
        with seeded N(0, 0.1²) values in place: ``init_lm`` makes them zeros,
        which would leave the kernels' bias epilogues unchecked."""
        for k, v in params.items():
            if isinstance(v, dict):
                self.seeded_biases(v)
            elif isinstance(v, list):  # per-layer blocks (TT cores are lists of tensors)
                for item in v:
                    if isinstance(item, dict):
                        self.seeded_biases(item)
            elif k in ("b", "bias"):
                v.copy_(self.randn(*v.shape, scale=0.1))

    # -- serve phase (a main path) ---------------------------------------------
    def engine(self, cfg, params, max_len, **kw):
        """An Engine at the serve geometry: 8 slots, block 16, 256-token
        prefill chunks, prefill batch 4, bf16 cache."""
        from repro_torch.serve.engine import Engine
        return Engine(cfg, params, slots=8, max_len=max_len, block_size=16, prefill_chunk=256,
                      prefill_batch=4, cache_dtype="bfloat16", device=self.dev, **kw)

    # -- serve phase (a main path) ---------------------------------------------
    def serve(self, cfg, params, card, prompts, max_len, path, frames=None):
        """``frames``: a request's encoder frames each (enc-dec), encoded at
        its admission inside its time to first token."""
        torch = self.torch
        np = self.np
        eng = self.engine(cfg, params, max_len)
        dec = {"t": 0.0, "tokens": 0}
        orig_dispatch, orig_collect = eng._decode_dispatch, eng._decode_collect

        def dispatch(plan):
            dec["t0"] = time.perf_counter()
            return orig_dispatch(plan)

        def collect(plan, toks):
            orig_collect(plan, toks)
            dec["t"] += time.perf_counter() - dec["t0"]
            dec["tokens"] += len(plan.active)

        eng._decode_dispatch, eng._decode_collect = dispatch, collect
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_tokens=32, enc_frames=None if frames is None else frames[i])
                for i, p in enumerate(prompts)]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the wrappers hold the engine's bound methods: drop them, so the
        # engine and its state are freed when this phase returns
        del eng._decode_dispatch, eng._decode_collect
        counts = counters()
        self.served[path] = [r.out_tokens for r in reqs]
        from repro_torch.kernels import tt_linear
        staged = tt_linear.staged_launches
        launches = {k: n for k, (n, _) in counts.items()}
        plain = {k: n for k, (_, n) in counts.items()}
        ttft = np.array([r.t_first - r.t_submit for r in reqs])
        print(f"[serve {path}] prompts={[len(p) for p in prompts]} launches={launches} "
              f"plain_calls_on_cuda={plain} staged_tt_linear_launches={staged}", flush=True)
        print(f"[serve {path}] {card}: TTFT p50={np.median(ttft) * 1e3:.1f} ms "
              f"max={ttft.max() * 1e3:.1f} ms; decode {dec['tokens']} tokens in "
              f"{dec['t']:.3f} s = {dec['tokens'] / dec['t']:.1f} tokens/s; "
              f"run wall {wall:.2f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        checks = {
            "every request finished with 32 tokens": all(
                r.done and len(r.out_tokens) == 32 for r in reqs),
            "pool drained": eng.manager is None
            or eng.num_free_blocks == eng.manager.num_blocks - 1,
            "every kernel of the path launched": all(
                launches[k] > 0 for k in PATH_KERNELS[path]),
            "no plain version on CUDA": not any(plain.values()),
            "no staged tt_linear launch": staged == 0,
            "tokens in vocab": all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
        }
        for what, good in checks.items():
            if not good:
                self.failures.append(f"serve {path}: {what}")
        print(f"[serve {path}] checks: {checks}", flush=True)
        if frames is not None:
            print(f"[serve {path}] greedy tokens, the first 8 a request: "
                  f"{[r.out_tokens[:8] for r in reqs]}", flush=True)
        return launches

    # -- the single-sequence path (models.api.Model) ------------------------------
    def solo_generate(self, model, params, batch, max_len, n_steps, dec_positions=None,
                      forced=None):
        """``model.prefill`` on ``batch``, then ``n_steps`` ``decode_step``s
        fed the greedy token (or the ``forced`` tokens, (1, 1) each), at
        positions S, S + 1, ... (``dec_positions``: each step's M-RoPE ids).
        Returns (the prefill's and every step's (B, V) logits, the tokens fed)
        with no host sync."""
        torch = self.torch
        logits, cache = model.prefill(params, batch, cache_dtype=torch.bfloat16,
                                      max_len=max_len)
        out, fed = [logits], []
        s = batch["tokens"].shape[1]
        for i in range(n_steps):
            tok = logits.argmax(-1, keepdim=True).to(torch.int32) if forced is None \
                else forced[i]
            fed.append(tok)
            dec = {"tokens": tok}
            if dec_positions is not None:
                dec["positions"] = dec_positions[i]
            logits, cache = model.decode_step(params, cache, dec, s + i)
            out.append(logits)
        del cache
        return out, fed

    def solo_check(self, path, model, params, batch, max_len, n_steps, kernels, card,
                   dec_positions=None):
        """[solo <path>]: the main path (prefill + ``n_steps`` greedy decode
        steps) through the kernels with every launch counter reset just
        before and read just after, then the same calls under
        ``force_plain()`` fed the kernel route's tokens: the prefill's and
        the decode steps' logits are held to ``compare_logits``' criteria.
        Each kernel of ``kernels`` must have launched, no plain version may
        run on CUDA.  Returns (the counts, the kernel route's wall seconds)."""
        torch = self.torch
        from repro_torch.kernels import dispatch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        got, fed = self.solo_generate(model, params, batch, max_len, n_steps, dec_positions)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        with dispatch.force_plain():
            want, _ = self.solo_generate(model, params, batch, max_len, n_steps, dec_positions,
                                         forced=fed)
        launches = {k: n for k, (n, _) in counts.items()}
        plain = {k: n for k, (_, n) in counts.items()}
        s = batch["tokens"].shape[1]
        geometry = f"1 sequence of {s} tokens, {n_steps} decode steps, bf16 through " \
                   f"{model.cfg.n_layers} layers"
        ok = self.compare_logits(f"solo {path}", got[0], want[0], f"prefill (last position; "
                                 f"{geometry})")
        ok &= self.compare_logits(f"solo {path}", torch.cat(got[1:]), torch.cat(want[1:]),
                                  f"decode ({n_steps} steps; {geometry})")
        checks = {"logits within tolerance": ok,
                  "every kernel of the path launched": all(launches[k] > 0 for k in kernels),
                  "no plain version on CUDA": not any(plain.values()),
                  "tokens in vocab": all(0 <= int(t) < model.cfg.vocab_size
                                         for t in torch.cat(fed).flatten().tolist())}
        print(f"[solo {path}] {card}: launches={launches} plain_calls_on_cuda={plain}; "
              f"kernel route {wall:.3f} s wall for the prefill and {n_steps} steps; peak device "
              f"memory {peak:.2f} GiB; checks: {checks}", flush=True)
        for what, good in checks.items():
            if not good:
                self.failures.append(f"solo {path}: {what}")
        del got, want
        torch.cuda.empty_cache()
        return launches, wall

    def profile_call(self, path, card, what, run, n):
        """Wall and device kernel time of ``run()`` (``n`` calls) under
        ``torch.profiler``, the device's busy share and the hand kernels'
        share of the device time; the launches each kernel made a call."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        reset_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: n_ / n for k, (n_, _) in counters().items() if n_}
        events = kernel_events(prof)
        device_s = sum(e.self_device_time_total for e in events) / 1e6
        hand_s = sum(e.self_device_time_total for e in events if hand_kernel(e.key)) / 1e6
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        print(f"[solo {path}] {card}: {what} wall {wall / n * 1e3:.2f} ms, device kernel "
              f"time {device_s / n * 1e3:.2f} ms, device busy share {device_s / wall:.3f}; "
              f"hand kernels {hand_s / n * 1e3:.3f} ms; launches a call {launches}; top "
              f"kernels a call: " + "; ".join(f"{e.key[:48]} {e.self_device_time_total / n / 1e3:.3f}"
                                             f" ms" for e in top), flush=True)

    def solo_qwen(self, card):
        """[solo qwen2-vl-7b]: qwen2-vl-7b's serving config at full width
        and depth (28 layers of d 3584, 28 heads of 128 over 4 KV heads,
        int4 q/k/v, TT attn_o and MLP, vocab 152064), random bf16 params from
        the seed, through ``models.api.Model``: one request of 2048 tokens
        (64 text, a 32 x 32 image block, 960 text) with M-RoPE positions,
        ``prefill`` (flash_attention's blocked branch at S 2048) and 32
        ``decode_step``s.  Returns the counts of the main path's run."""
        torch, np = self.torch, self.np
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.serve.steps import serve_config_of
        path = "solo qwen2-vl-7b"
        cfg = serve_config_of(get_config("qwen2-vl-7b"))
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev)
        params = model.init(SEED, device=self.dev)
        torch.cuda.synchronize()
        print(f"[init] qwen2-vl-7b serving config ({cfg.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.n_heads} heads of {cfg.head_dim} over {cfg.n_kv_heads} KV heads, M-RoPE "
              f"{cfg.mrope_sections}) random params in {time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
        pos = mrope_positions(64, (32, 32), 960)
        s, n_steps = pos.shape[-1], 32
        nxt = int(pos.max()) + 1
        with self.own_generators(SEED + 2):
            toks = torch.from_numpy(self.rng.integers(0, cfg.vocab_size, (1, s))
                                    .astype(np.int32)).to(self.dev)
        batch = {"tokens": toks, "positions": torch.from_numpy(pos).to(self.dev)}
        dec_pos = [torch.full((3, 1, 1), nxt + i, dtype=torch.int32, device=self.dev)
                   for i in range(n_steps)]
        print(f"[{path}] input: {s} tokens, M-RoPE planes t/h/w of the image block "
              f"{pos[:, 0, 64].tolist()} .. {pos[:, 0, 64 + 1023].tolist()}, text after it "
              f"from {pos[:, 0, 64 + 1024].tolist()}; decode steps at {nxt} ..", flush=True)
        counts, _ = self.solo_check("qwen2-vl-7b", model, params, batch, s + n_steps, n_steps,
                                    PATH_KERNELS[path], card, dec_positions=dec_pos)
        cache = {}

        def prefill():
            _, cache["c"] = model.prefill(params, batch, cache_dtype=torch.bfloat16,
                                          max_len=s + n_steps)

        def decode():
            for i in range(8, 16):
                model.decode_step(params, cache["c"], {"tokens": toks[:, :1],
                                                       "positions": dec_pos[i]}, s + i)

        prefill()
        for i in range(8):  # warm the decode path
            model.decode_step(params, cache["c"], {"tokens": toks[:, :1],
                                                   "positions": dec_pos[i]}, s + i)
        torch.cuda.reset_peak_memory_stats()
        self.profile_call("qwen2-vl-7b", card, f"prefill ({s} tokens, {cfg.n_layers} layers)",
                          prefill, 1)
        self.profile_call("qwen2-vl-7b", card, f"decode step (ctx ~{s})", decode, 8)
        print(f"[{path}] {card}: peak device memory over the profiled prefill and decode "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        del params, cache, model
        torch.cuda.empty_cache()
        return counts

    def solo_family(self, arch, card):
        """[solo <arch>]: the serving config at full width and 2 layers (2 +
        2 for whisper-base), random params from the seed, through
        ``models.api.Model``: a 256-token prefill (whisper-base on seeded
        (1500, 512) frames) and 4 decode steps, kernels against
        ``force_plain()``; the family's own kernel must launch."""
        torch, np = self.torch, self.np
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.serve.steps import serve_config_of
        cfg = serve_config_of(get_config(arch)).replace(n_layers=2)
        if cfg.family == "encdec":
            cfg = cfg.replace(n_enc_layers=2)
        model = build_model(cfg, device=self.dev)
        params = model.init(SEED, device=self.dev)
        with self.own_generators(SEED + 3):
            if cfg.family == "encdec":
                self.seeded_biases(params)
            batch = {"tokens": torch.from_numpy(self.rng.integers(0, cfg.vocab_size, (1, 256))
                                                .astype(np.int32)).to(self.dev)}
            if cfg.family == "encdec":
                batch["enc_frames"] = torch.from_numpy(self.rng.standard_normal(
                    (1, cfg.enc_len, cfg.d_model)).astype(np.float32)).to(self.dev)
        kernels = ("tt_linear", "int4_matmul") + SOLO_FAMILY_KERNELS[arch]
        self.solo_check(arch, model, params, batch, 256 + 4, 4, kernels, card)
        del params, model
        torch.cuda.empty_cache()

    def solo_engine(self, cfg, params, prompts, max_len, path, card, n=4, new=32):
        """[solo <path>]: ``n`` of the serve phase's requests one at a time
        through ``models.api.Model``, fed the Engine's tokens for them (the
        prefill, then ``new - 1`` decode steps), held step by step against
        the serving session the Engine runs (the paged kernels, the serve
        geometry, every serve prompt in its slot) fed the same tokens: every
        step's logits by ``compare_logits``' criteria, and at every step the
        Engine's token within 0.05 of max|logit| of the solo path's top
        logit (the two attention routes differ, so a bf16 near-tie may flip
        a greedy token).  Prints how many steps of each request the solo
        path's greedy token is the Engine's."""
        torch = self.torch
        from repro_torch.models import build_model
        served = self.served[path]
        t0 = time.perf_counter()
        lens, chunks = self._prefill_tiles(prompts)
        sess, state = self.session(cfg, max_len)
        ref = [None] * new
        for tok, pos in chunks:
            real = pos >= 0
            lg, state = sess.prefill_chunk(params, state, tok, pos,
                                           logit_cols=(real.sum(1) - 1).clamp(min=0))
            ref[0] = lg if ref[0] is None else torch.where(real.any(1)[:, None], lg, ref[0])
        dec_pos = torch.from_numpy(lens.astype(self.np.int32)).to(self.dev)
        for j in range(new - 1):
            tok = torch.tensor([[r[j]] for r in served], dtype=torch.int32, device=self.dev)
            ref[j + 1], state = sess.decode_step(params, state, tok, dec_pos + j)
        del state
        ref = torch.stack(ref, 1)[:n]                                 # (n, new, V)
        model = build_model(cfg, device=self.dev)
        solo, rows = [], []
        for i in range(n):
            batch = {"tokens": torch.tensor([prompts[i]], dtype=torch.int32, device=self.dev)}
            forced = [torch.tensor([[t]], dtype=torch.int32, device=self.dev)
                      for t in served[i][:new - 1]]
            logits, _ = self.solo_generate(model, params, batch, len(prompts[i]) + new, new - 1,
                                           forced=forced)
            lg = torch.cat(logits)                                    # (new, V)
            theirs = torch.tensor(served[i][:new], device=self.dev)[:, None]
            gap = (lg.amax(-1) - lg.gather(-1, theirs)[:, 0]) / lg.abs().amax(-1)
            agree = (lg.argmax(-1) == theirs[:, 0]).sum().item()
            rows.append((len(prompts[i]), agree, round(gap.max().item(), 5)))
            solo.append(lg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = self.compare_logits(f"solo {path}", torch.cat(solo), ref.reshape(n * new, -1),
                                 f"solo path against the serving session, both fed the "
                                 f"Engine's tokens ({n} requests, the prefill and {new - 1} "
                                 f"decode steps each, {cfg.compute_dtype} through {cfg.n_layers} layers)")
        near = all(g <= 0.05 for _, _, g in rows)
        if not ok:
            self.failures.append(f"solo {path}: logits against the serving session")
        if not near:
            self.failures.append(f"solo {path}: an Engine token more than 0.05 of max|logit| "
                                 f"under the solo path's top logit")
        print(f"[solo {path}] {card}: {n} requests one at a time fed the Engine's {new} tokens "
              f"each, with the serving session fed the same, in {wall:.2f} s; (prompt length, "
              f"steps whose solo greedy token is the Engine's, the widest gap of an Engine "
              f"token under the solo top logit as a share of max|logit| (tol 0.05)): {rows} "
              f"{'ok' if near else 'FAIL'}", flush=True)
        del ref, solo
        torch.cuda.empty_cache()

    # -- the compressed path: compress, checkpoint, reload ----------------------
    def compressed_params(self, cfg, prompts, card):
        """[compress] and [checkpoint]: plant a TT + int4 ChatGLM3-6B (random
        bf16 cores and int4 weights from the seed), make it a dense bf16 tree
        on the card (TT linears reconstructed, int4 dequantized), free it, and
        run the port's ``compress_model`` there.  Each TT linear's recovered
        weight must sit within (1 + sqrt(d - 1)) ||bf16(W) - W|| of the
        planted W (tests/test_torch_compress.py derives the factor); sampled
        int4 leaves must equal the CPU's ``quantize_int4`` bitwise.  Then the
        tree goes through ``save_compressed`` and ``load_compressed`` and every
        leaf must come back bitwise.  Returns the loaded params and the
        planted tree's logits of the first prefill chunk of ``prompts``."""
        import shutil
        import tempfile
        torch = self.torch
        from repro_torch.checkpoint.store import _flatten_with_paths
        from repro_torch.configs import get_config
        from repro_torch.core import compress, quant, ttd
        from repro_torch.models import transformer
        path = "chatglm3-6b-compressed"
        sync = torch.cuda.synchronize
        t0 = time.perf_counter()
        planted = transformer.init_lm(cfg, seed=SEED, device=self.dev)
        tok, pos = self._check_inputs(cfg, prompts, 0)[1][0]
        sess, state = self.session(cfg, 2048)
        lg, state = sess.prefill_chunk(planted, state, tok, pos)
        planted_logits = lg[pos >= 0]
        del sess, state, lg
        specs = transformer.specs_tree(cfg)
        dense_cfg = cfg.replace(ttd=dataclasses.replace(cfg.ttd, enabled=False),
                                quant=dataclasses.replace(cfg.quant, enabled=False))
        tt_cores, rounding, layers = {}, {}, []
        for seg, seg_specs in zip(planted["segments"], specs["segments"]):
            for p, sp in zip(seg, seg_specs):
                li = len(layers)
                layer = {"ln1": p["ln1"], "ln2": p["ln2"], "attn": {}, "mlp": {}}
                for group in ("attn", "mlp"):
                    for nm, lsp in sp[group].items():
                        lin = p[group][nm]
                        if lsp.kind == "tt":
                            tt_cores[li, nm] = lin["cores"]
                            w = ttd.tt_reconstruct(ttd.matrices_to_cores(
                                [c.double() for c in lin["cores"]], lsp.tt), lsp.tt)
                            w16 = w.to(torch.bfloat16)
                            rounding[li, nm] = (torch.linalg.norm(w16.double() - w)
                                                / torch.linalg.norm(w)).item()
                        else:
                            w16 = quant.dequantize_int4(lin, torch.float32).to(torch.bfloat16)
                        layer[group][nm] = {"w": w16.T.contiguous(),
                                            **({"b": lin["b"]} if "b" in lin else {})}
                        del w16
                layers.append(layer)
        dense = {k: v for k, v in planted.items() if k != "segments"}
        dense["segments"] = [layers]
        del planted, layers
        torch.cuda.empty_cache()
        sync()
        dense_bytes = sum(t.numel() * t.element_size() for _, t in _flatten_with_paths(dense))
        print(f"[compress] {path}: planted {cfg.n_layers}-layer tree (TT rank {cfg.ttd.rank} on "
              f"blocks "
              f"{cfg.ttd.first_tt_block}-{cfg.n_layers - 1}, int4 g128 elsewhere) made dense in "
              f"bf16 on the card in {time.perf_counter() - t0:.1f} s: {dense_bytes} bytes; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)

        times = {"tt": 0.0, "int4": 0.0, "dense": 0.0}
        calls = {"tt": 0, "int4": 0, "dense": 0}
        convert = compress._convert_linear

        def timed(p, spec, method):
            sync()
            t = time.perf_counter()
            out = convert(p, spec, method)
            sync()
            times[spec.kind] += time.perf_counter() - t
            calls[spec.kind] += 1
            return out

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        compress._convert_linear = timed
        try:
            t0 = time.perf_counter()
            tree = compress.compress_model(dense, dense_cfg, cfg)
            sync()
            wall = time.perf_counter() - t0
        finally:
            compress._convert_linear = convert
        print(f"[compress] {path}: {card}: compress_model on the card in {wall:.2f} s: TT-SVD "
              f"{times['tt']:.2f} s for {calls['tt']} linears, int4 {times['int4']:.3f} s for "
              f"{calls['int4']} linears; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the dense "
              "tree)", flush=True)

        ftb = cfg.ttd.first_tt_block
        worst = (-1.0, None)
        for (li, nm), cores in tt_cores.items():
            group = "attn" if nm == "wo" else "mlp"
            lsp = specs["segments"][1][0][group][nm].tt
            got = tree["segments"][1][li - ftb][group][nm]["cores"]
            if any(c.dtype != torch.float32 for c in got):
                self.failures.append(f"compress {path}: layer {li} {nm} cores not f32")
            w = ttd.tt_reconstruct(ttd.matrices_to_cores([c.double() for c in cores], lsp), lsp)
            rec = ttd.tt_reconstruct(ttd.matrices_to_cores([c.double() for c in got], lsp), lsp)
            err = (torch.linalg.norm(rec - w) / torch.linalg.norm(w)).item()
            factor = 1 + math.sqrt(lsp.d - 1)
            ratio = err / rounding[li, nm]
            if not ratio <= factor:
                self.failures.append(f"compress {path}: layer {li} {nm} recovered at {err:.3e}, "
                                     f"bound {factor * rounding[li, nm]:.3e}")
            if ratio > worst[0]:
                worst = (ratio, (li, nm, err, rounding[li, nm], factor))
            del w, rec
        li, nm, err, rnd, factor = worst[1]
        print(f"[compress] {path}: {len(tt_cores)} TT linears recovered from their bf16 dense "
              f"weights; worst layer {li} {nm}: ||W_rec - W||/||W|| {err:.3e} against "
              f"||bf16(W) - W||/||W|| {rnd:.3e} (ratio {worst[0]:.3f}, bound "
              f"{factor:.3f} = 1 + sqrt(d - 1)) {'ok' if worst[0] <= factor else 'FAIL'}",
              flush=True)
        same, sampled = 0, ((0, "attn", "wq"), (0, "attn", "wk"), (ftb // 2, "mlp", "gate"),
                            (ftb - 1, "mlp", "down"), (cfg.n_layers - 1, "attn", "wv"))
        for li, group, nm in sampled:
            seg, off = (0, li) if li < ftb else (1, li - ftb)
            got = tree["segments"][seg][off][group][nm]
            want = quant.quantize_int4(dense["segments"][0][li][group][nm]["w"].cpu().float().T,
                                       cfg.quant.group_size)
            for leaf in ("qweight", "scales"):
                if torch.equal(got[leaf].cpu(), want[leaf]):
                    same += 1
                else:
                    self.failures.append(f"compress {path}: layer {li} {nm} {leaf} differs "
                                         "from the CPU's quantize_int4")
        print(f"[compress] {path}: int4 leaves of {len(sampled)} sampled linears (layers "
              f"{sorted({li for li, _, _ in sampled})}) bitwise equal to quantize_int4 on the "
              f"CPU: {same} of {2 * len(sampled)} {'ok' if same == 2 * len(sampled) else 'FAIL'}",
              flush=True)
        del dense, tt_cores
        torch.cuda.empty_cache()

        ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
        try:
            t0 = time.perf_counter()
            out = compress.save_compressed(ckpt, tree, cfg)
            save_s = time.perf_counter() - t0
            disk = sum(f.stat().st_size for f in out.iterdir())
            t0 = time.perf_counter()
            params, cfg2 = compress.load_compressed(ckpt, device=self.dev)
            sync()
            load_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        pairs = list(zip(_flatten_with_paths(params), _flatten_with_paths(tree)))
        bad = [na for (na, a), (nb, b) in pairs
               if na != nb or a.device != b.device or a.dtype != b.dtype
               or not torch.equal(a, b)]
        ok = not bad and cfg2 == cfg and len(pairs) == len(_flatten_with_paths(tree))
        if not ok:
            self.failures.append(f"checkpoint {path}: {len(bad)} leaves differ ({bad[:3]}), "
                                 f"config equal {cfg2 == cfg}")
        print(f"[checkpoint] {path}: {card}: save_compressed {save_s:.2f} s, {disk} bytes on "
              f"disk; load_compressed onto the card {load_s:.2f} s; {len(pairs)} leaves bitwise "
              f"equal, config equal: {'ok' if ok else 'FAIL'}", flush=True)
        rep = compress.compression_report(get_config("chatglm3-6b"))
        deploy = compress.compression_report(cfg, param_bits=16).network_cr_bits
        pins = abs(rep.block_cr - 10.72) < 0.01 and abs(rep.network_cr - 1.94) < 0.005 \
            and abs(deploy - 2.09) < 0.005
        if not pins:
            self.failures.append(f"checkpoint {path}: compression_report off Table I")
        print(f"[checkpoint] {path}: compression_report: block CR {rep.block_cr:.2f}, network "
              f"CR {rep.network_cr:.2f} (Table I: 10.72, 1.94), deploy bits-CR {deploy:.2f} "
              f"(pinned 2.09) {'ok' if pins else 'FAIL'}; on disk the int4 + TT checkpoint "
              f"holds {disk} bytes against {dense_bytes} bytes of the dense bf16 tree "
              f"({dense_bytes / disk:.2f}x; f32 TT cores, the bf16 embedding and head "
              "included)", flush=True)
        del tree
        torch.cuda.empty_cache()
        return params, (tok, pos, planted_logits)

    def planted_vs_loaded(self, cfg, params, planted, path):
        """The loaded tree's logits of the first prefill chunk against the
        planted tree's (a number to record: compression changed the weights
        by the bf16 rounding and the rank-16 truncation of it)."""
        tok, pos, want = planted
        sess, state = self.session(cfg, 2048)
        lg, state = sess.prefill_chunk(params, state, tok, pos)
        got = lg[pos >= 0]
        d = (got - want).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        print(f"[logits {path}] first prefill chunk ({got.shape[0]} positions), loaded against "
              f"planted tree: max|d| {d:.4f} of max|planted| {want.abs().max().item():.4f}; "
              f"top-1 agreement {agree:.4f}", flush=True)
        del sess, state, lg

    # -- decode-step and prefill-chunk profile ----------------------------------
    def profile(self, cfg, params, card, max_len, path, steps: int = 5, frames=None):
        """Wall time vs device kernel time of full-width decode steps (8 slots
        at ~1 K context, ~0.5 K where ``max_len`` is 1024) and of one
        256-token prefill chunk for all 8 slots: the device's busy share, the
        top kernels and each hand kernel's device time; for an enc-dec
        session also one begin step on ``frames`` (no device-to-host copy
        allowed)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        sess, state = self.session(cfg, max_len)
        n_ctx = min(4, (max_len - 256 - steps - 2) // 256)  # chunks before the profiled calls
        ctx_text = f"ctx ~{n_ctx / 4:g} K"
        toks = torch.randint(0, cfg.vocab_size, (8, 256), device=self.dev,
                             dtype=torch.int32, generator=self.gen)
        pos = torch.arange(256, device=self.dev, dtype=torch.int32)[None].repeat(8, 1)
        cols = torch.full((8,), 255, device=self.dev)
        for c in range(n_ctx):
            _, state = sess.prefill_chunk(params, state, toks, pos + 256 * c, logit_cols=cols)
        dtok = toks[:, :1].contiguous()
        dpos = torch.full((8,), 256 * n_ctx, device=self.dev, dtype=torch.int32)
        for i in range(2):
            _, state = sess.decode_step(params, state, dtok, dpos + i)
        torch.cuda.synchronize()

        def report(what, run, n):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            clock = sm_clock()
            events = kernel_events(prof)
            device_s = sum(e.self_device_time_total for e in events) / 1e6
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
            hand = [e for e in events if hand_kernel(e.key)]
            hand_s = sum(e.self_device_time_total for e in hand) / 1e6
            attn_s = sum(e.self_device_time_total for e in hand if "flash::" in e.key
                         or "ring_decode" in e.key or "paged_decode" in e.key) / 1e6
            print(f"[profile {path}] {card}: {what} wall {wall / n * 1e3:.2f} ms, device "
                  f"kernel time {device_s / n * 1e3:.2f} ms, device busy share "
                  f"{device_s / wall:.3f}; top kernels per call: "
                  + "; ".join(f"{e.key[:48]} {e.self_device_time_total / n / 1e3:.3f} ms"
                              for e in top), flush=True)
            print(f"[profile {path}] {what}: hand kernels {hand_s / n * 1e3:.3f} ms per call ("
                  + "; ".join(f"{e.key[:48]} {e.self_device_time_total / n / 1e3:.3f} ms"
                              for e in sorted(hand, key=lambda e: -e.self_device_time_total))
                  + f"), library and PyTorch kernels {(device_s - hand_s) / n * 1e3:.3f} ms",
                  flush=True)
            print(f"[profile {path}] {what}: attention kernels {attn_s / n * 1e3:.3f} ms "
                  f"per call", flush=True)
            n_kernels = sum(e.count for e in events if not e.key.startswith(("Memcpy", "Memset")))
            dtoh = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy DtoH"))
            print(f"[profile {path}] {what}: device kernels {n_kernels / n:.1f} per call; "
                  f"device-to-host copies {dtoh / n:.1f} per call; SM clock, power just after: "
                  f"{clock}", flush=True)
            if (cfg.family == "moe" or what.startswith("begin")) and dtoh:
                self.failures.append(f"profile {path} {what}: {dtoh} device-to-host copies")
            if cfg.family == "moe":  # the grouped tt_linear's two launches, named apart
                parts = (("operator pass", [e for e in hand if "tt_ops_mma" in e.key]),
                         ("contraction", [e for e in hand if "tt_wgmma" in e.key or (
                             "tt_fused<" in e.key and ", true>(" in e.key)]))
                print(f"[profile {path}] {what}: grouped tt_linear "
                      + "; ".join(f"{part} {sum(e.self_device_time_total for e in evs) / n / 1e3:.3f}"
                                  f" ms per call ({sum(e.count for e in evs) / n:.0f} launches: "
                                  + ", ".join(e.key.split("::", 1)[-1].split(">(")[0][:40] + ">"
                                              for e in evs) + ")" for part, evs in parts),
                      flush=True)
            for name, tag in (("wkv_scan", "wkv_"), ("rglru_scan", "rglru_"),
                              ("int4_matmul", "int4_")):
                scans = [e for e in hand if tag in e.key]
                if scans:
                    total = sum(e.self_device_time_total for e in scans)
                    print(f"[profile {path}] {what}: {name} device {total / n / 1e3:.3f} ms per "
                          f"call; a launch "
                          + "; ".join(f"{e.key[:52]} {e.self_device_time_total / e.count / 1e3:.4f} "
                                      f"ms ({e.count} launches)" for e in scans), flush=True)

        def decode():
            nonlocal state
            for i in range(steps):
                _, state = sess.decode_step(params, state, dtok, dpos + 2 + i)

        def chunk():
            nonlocal state
            _, state = sess.prefill_chunk(params, state, toks, pos + 256 * n_ctx + steps + 2,
                                          logit_cols=cols)

        def begin():
            nonlocal state
            state = sess.begin_sequence(params, state, 0, frames[0][None])

        report(f"decode step (8 slots, {ctx_text})", decode, steps)
        report(f"prefill chunk (8 slots x 256 tokens at {ctx_text})", chunk, 1)
        if frames is not None:
            begin()  # warm: the first encoder pass at 1500 rows allocates its buffers
            torch.cuda.synchronize()
            report(f"begin step (1 request x {cfg.enc_len} frames: encoder + cross K/V of "
                   f"{cfg.n_layers} layers)", begin, 1)
        del state
        torch.cuda.empty_cache()

    # -- the async front end and traffic replay ----------------------------------
    def path_checks(self, path, what, eng):
        """The pool drained, every kernel of the path launched since the last
        reset, no plain version on CUDA."""
        counts = counters()
        checks = {
            "pool drained": eng.manager is None
            or eng.num_free_blocks == eng.manager.num_blocks - 1,
            "every kernel of the path launched": all(counts[k][0] > 0 for k in PATH_KERNELS[path]),
            "no plain version on CUDA": not any(n for _, n in counts.values()),
        }
        for name, good in checks.items():
            if not good:
                self.failures.append(f"{what} {path}: {name}")
        return checks

    def frontend(self, cfg, params, card, max_len, path, window=(12, 10)):
        """[frontend <path>]: 12 requests (prompts 64-1536 tokens, 48 new
        tokens each, no eos), all submitted before the pump first runs,
        served three ways on one engine: ``Engine.run``, the ``AsyncEngine``
        without dispatch-ahead, and with it (the async arms twice, in the
        order sync, ahead, ahead, sync), each ahead dispatch (tick N's token
        copy and tick N+1's launch) under
        ``torch.cuda.set_sync_debug_mode("error")``.  The tokens must be
        bitwise the same.  Then both async arms again with a
        ``torch.profiler`` window over ``window[1]`` pump ticks from
        collection ``window[0]`` on (the device drained at its start): wall,
        device time and busy share a tick (the profiler is warm by then: the
        first window in a process carries its start-up)."""
        import asyncio

        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.serve.frontend import AsyncEngine
        with self.own_generators(SEED + 22):  # the other paths' draws stay as they were
            lens = self.rng.integers(64, 1537, 12)
            prompts = [[int(t) for t in self.rng.integers(0, cfg.vocab_size, n)] for n in lens]
        eng = self.engine(cfg, params, max_len)
        orig_admit, orig_collect = eng._admit, eng._decode_collect
        st: dict = {}

        def admit():
            t0 = time.perf_counter()
            orig_admit()
            st["admit_s"] += time.perf_counter() - t0

        def collect(plan, tok_col, toks_host=None):
            orig_collect(plan, tok_col, toks_host)
            st["ticks"] += 1
            w = st.get("window")
            if w is None:
                return
            if st["ticks"] == window[0]:
                torch.cuda.synchronize()
                w["prof"].start()
                w["t0"] = time.perf_counter()
            elif st["ticks"] == window[0] + window[1]:
                w["wall"] = time.perf_counter() - w["t0"]
                torch.cuda.synchronize()
                w["prof"].stop()

        eng._admit, eng._decode_collect = admit, collect

        def run(arm, profiled=False):
            st.update(admit_s=0.0, ticks=0, checked=0)
            if profiled:
                st["window"] = {"prof": profile(activities=[ProfilerActivity.CPU,
                                                            ProfilerActivity.CUDA])}
            fe = None
            torch.cuda.synchronize()
            reset_counters()
            t0 = time.perf_counter()
            if arm == "Engine.run":
                reqs = [eng.submit(p, max_tokens=48) for p in prompts]
                eng.run()
            else:
                fe = AsyncEngine(engine=eng, dispatch_ahead=arm == "ahead")
                if arm == "ahead" and not profiled:
                    orig_ahead = fe._dispatch_ahead

                    def checked(plan2, tok_col):
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            return orig_ahead(plan2, tok_col)
                        finally:
                            torch.cuda.set_sync_debug_mode(0)
                            st["checked"] += 1
                    fe._dispatch_ahead = checked

                async def go():
                    hs = [fe.submit(p, max_tokens=48) for p in prompts]
                    await fe.drain()
                    return [h.req for h in hs]
                reqs = asyncio.run(go())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ahead = fe.stats["ahead_ticks"] if fe is not None else 0
            w = st.pop("window", None)
            out = dict(tokens=[r.out_tokens for r in reqs], wall=wall, ticks=st["ticks"],
                       ahead=ahead, decode_tick_ms=(wall - st["admit_s"]) / st["ticks"] * 1e3,
                       checked=st["checked"])
            self.path_checks(path, f"frontend {arm}", eng)
            if not all(r.done and len(r.out_tokens) == 48 for r in reqs):
                self.failures.append(f"frontend {path} {arm}: a request ended short of 48 tokens")
            if w is not None:
                device_s = sum(e.self_device_time_total for e in kernel_events(w["prof"])) / 1e6
                out.update(prof_wall_ms=w["wall"] / window[1] * 1e3,
                           prof_device_ms=device_s / window[1] * 1e3,
                           busy=device_s / w["wall"])
            return out

        arms: dict[str, list] = {}
        # the async arms alternate (sync, ahead, ahead, sync), so their
        # difference is read against each one's own spread
        for arm in ("Engine.run", "sync", "ahead", "ahead", "sync"):
            try:
                a = run(arm)
            except RuntimeError as e:  # a sync inside an ahead dispatch raises here
                self.failures.append(f"frontend {path} {arm}: {type(e).__name__}: {e}")
                return
            arms.setdefault(arm, []).append(a)
            print(f"[frontend {path}] {card}: {arm}: {a['ticks']} decode ticks, {a['ahead']} "
                  f"dispatched ahead; run wall {a['wall']:.3f} s, decode wall per tick "
                  f"{a['decode_tick_ms']:.2f} ms (run wall less the admissions' prefill, over "
                  f"the ticks); ahead dispatches checked under sync debug mode 'error': "
                  f"{a['checked']}", flush=True)
        for arm in ("sync", "ahead"):
            a = run(arm, profiled=True)
            arms[arm].append(a)
            print(f"[frontend {path}] {card}: profile of {window[1]} pump ticks from tick "
                  f"{window[0]}, dispatch-ahead {'on' if arm == 'ahead' else 'off'}: wall "
                  f"{a['prof_wall_ms']:.2f} ms, device kernel time {a['prof_device_ms']:.2f} ms, "
                  f"device busy share {a['busy']:.3f} a tick; SM clock, power just after: "
                  f"{sm_clock()}", flush=True)
        del eng._admit, eng._decode_collect
        every = [a for runs in arms.values() for a in runs]
        for what, key, profiled in (("decode wall per tick (ms)", "decode_tick_ms", False),
                                    ("profiled wall per tick (ms)", "prof_wall_ms", True),
                                    ("profiled device busy share", "busy", True)):
            print(f"[frontend {path}] {card}: {what} by arm, in run order: " + "; ".join(
                f"{k} {', '.join(f'{a[key]:.3f}' for a in runs if ('busy' in a) == profiled)}"
                for k, runs in arms.items() if any(('busy' in a) == profiled for a in runs)),
                flush=True)
        checks = {"Engine.run, sync and ahead tokens bitwise the same (every run)":
                      all(a["tokens"] == every[0]["tokens"] for a in every),
                  "ahead_ticks > 0": all(a["ahead"] > 0 for a in arms["ahead"]),
                  "every ahead dispatch ran under sync debug mode 'error'":
                      all(a["checked"] == a["ahead"] for a in arms["ahead"] if "busy" not in a),
                  "the same ticks in every run": len({a["ticks"] for a in every}) == 1}
        for what, good in checks.items():
            if not good:
                self.failures.append(f"frontend {path}: {what}")
        print(f"[frontend {path}] prompts={[len(p) for p in prompts]}; checks: {checks}",
              flush=True)

    def traffic(self, cfg, params, card, max_len, path):
        """[traffic <path>]: 32 requests of seeded Poisson traffic at 4 per
        second (prompts 128/512/1536, 16/64/128 new tokens, TTFT SLO 2 s,
        deadline 30 s, a fifth of the clients cancelling 0.2-2 s after
        submit) replayed open-loop through ``traffic.drive`` with
        dispatch-ahead on, then off, each with an Observer streaming a JSONL
        trace (under the gitignored ``chiprun_out/``).  The rows must pass the
        traffic schema check and the traces validate; completed requests hold
        exactly their budget, cancelled ones fewer; the pool drains; no plain
        version runs on CUDA.  Speeds are printed, not gated."""
        torch = self.torch
        from repro_torch import traffic as tr
        from repro_torch.obs import ObsConfig, Observer, validate_jsonl
        from repro_torch.serve.frontend import AsyncEngine
        spec = tr.WorkloadSpec(arrival="poisson", n_requests=32, rate_rps=4.0,
                               prompt_len_buckets=(128, 512, 1536),
                               prompt_len_weights=(0.5, 0.35, 0.15),
                               out_tokens_buckets=(16, 64, 128),
                               out_tokens_weights=(0.5, 0.35, 0.15), vocab=cfg.vocab_size,
                               ttft_slo_s=2.0, deadline_s=30.0, cancel_prob=0.2,
                               cancel_window_s=(0.2, 2.0), seed=7)
        work = tr.make_workload(spec)
        rows = []
        for ahead in (True, False):
            trace = ROOT / "chiprun_out" / f"traffic_{path}_{'ahead' if ahead else 'sync'}.jsonl"
            trace.unlink(missing_ok=True)
            obs = Observer(ObsConfig(jsonl_path=str(trace)))
            fe = AsyncEngine(engine=self.engine(cfg, params, max_len, obs=obs),
                             dispatch_ahead=ahead)
            torch.cuda.synchronize()
            reset_counters()
            res = tr.drive(fe, work)
            torch.cuda.synchronize()
            obs.close()
            row = tr.traffic_row(result=res, registry=obs.registry, family=cfg.family, arch=path,
                                 scenario=f"poisson-4rps ahead={'on' if ahead else 'off'}",
                                 workload=spec.to_dict())
            row["ahead_share"] = fe.stats["ahead_ticks"] / max(fe.stats["ticks"], 1)
            rows.append(row)
            bad = [f"request {o.idx}: {o.finish_reason} with {o.n_tokens} of {w.max_tokens}"
                   for o, w in zip(res.outcomes, work)
                   if (o.n_tokens != w.max_tokens if o.completed else o.n_tokens >= w.max_tokens)]
            errors = validate_jsonl(trace)
            own = {"completed hold their budget, cancelled fewer": not bad,
                   "trace validates": not errors}
            for what, good in own.items():
                if not good:
                    self.failures.append(f"traffic {path} ahead={ahead}: {what} "
                                         f"{bad[:3] or errors[:3]}")
            checks = self.path_checks(path, f"traffic ahead={ahead}", fe.engine) | own
            ms = {k: {q: (v * 1e3 if v is not None else None) for q, v in row[k].items()
                      if q in ("p50", "p95", "p99")} for k in ("ttft_s", "inter_token_s")}
            print(f"[traffic {path}] {card}: dispatch-ahead {'on' if ahead else 'off'}: TTFT "
                  f"p50/p95/p99 {ms['ttft_s']['p50']:.1f} / {ms['ttft_s']['p95']:.1f} / "
                  f"{ms['ttft_s']['p99']:.1f} ms; inter-token p50/p99 "
                  f"{ms['inter_token_s']['p50']:.2f} / {ms['inter_token_s']['p99']:.2f} ms; "
                  f"{row['tok_per_s']:.1f} tokens/s, goodput {row['goodput_tok_per_s']:.1f} "
                  f"tokens/s; {row['n_completed']} completed, {row['n_cancelled']} cancelled, "
                  f"{row['n_deadline_missed']} deadline-missed, {row['n_slo_attained']} in SLO "
                  f"of {row['n_requests']}; {row['decode_ticks']} decode ticks, ahead share "
                  f"{row['ahead_share']:.3f}; wall {row['wall_s']:.2f} s; {len(obs.trace.events)} "
                  f"events in {trace.name}; checks: {checks}", flush=True)
            del fe
            torch.cuda.empty_cache()
        try:
            tr.check_traffic_schema({"scenarios": [r["scenario"] for r in rows],
                                     "note": "chip_smoke traffic replay", "rows": rows},
                                    diversity={"scenario": 2})
        except ValueError as e:
            self.failures.append(f"traffic {path}: schema: {e}")


    # -- training: the tt_linear backward and tinyllama-1.1b -------------------
    def tt_bwd_phase(self, role, spec, b, xdt):
        """[tt_linear_bwd]: the backward's dx (the hand kernel on the
        transposed train; its plain version is ``tt_linear_ref`` on that
        train) and the cores' GEMMs (``core_grads``) against autograd of the
        plain version, at a tinyllama-1.1b spec and ``b`` rows, f32 cores:
        bf16 x and dz take the fused route (2e-2 of max|plain|), f32 the
        staged one (1e-4).  Also times the plain forward + autograd
        backward and the library call dz @ Wᵀ on the reconstructed W."""
        torch = self.torch
        from repro_torch.kernels import tt_linear as k
        cores = [self.randn(*s, scale=1 / math.sqrt(s[0])) for s in spec.core_matrix_shapes()]
        x = self.randn(b, spec.n_in, dtype=xdt)
        du = self.randn(b, spec.n_out, dtype=xdt)
        cores_t, spec_t = k.transpose_train(cores, spec)

        def plain_autograd():
            live = [x.detach().requires_grad_(), *[c.detach().requires_grad_() for c in cores]]
            return torch.autograd.grad(k.tt_linear_ref(live[0], live[1:], spec), live, du)

        def dx():
            return k._tt_linear_cuda(du, cores_t, spec_t, None, None, None, None, role="dx")

        staged = k.staged_launches
        got = dx()
        fused = k.staged_launches == staged
        got_dc = k.core_grads(x, du, cores, spec)
        want = plain_autograd()
        tol = 2e-2 if xdt == torch.bfloat16 else 1e-4
        dc_err = max((a.to(x.dtype).float() - w.float()).abs().max().item()
                     / (w.float().abs().max().item() or 1.0) for a, w in zip(got_dc, want[1:]))
        ms = self.time_ms(lambda i: dx())
        dc_ms = self.time_ms(lambda i: k.core_grads(x, du, cores, spec), iters=5)
        plain_ms = self.time_ms(lambda i: k.tt_linear_ref(du, cores_t, spec_t), iters=5)
        autograd_ms = self.time_ms(lambda i: plain_autograd(), iters=3)
        eye = torch.eye(spec.n_in, device=self.dev)
        wt = k.tt_linear_ref(eye, cores, spec).T.contiguous().to(xdt)  # (M, N): Wᵀ
        lib_ms = self.time_ms(lambda i: torch.matmul(du, wt))
        del eye, wt
        orders = k.tt_order_flops(spec_t)
        order = min(orders, key=orders.get)
        nbytes = du.element_size() * (du.numel() + b * spec.n_in) \
            + sum(c.numel() * c.element_size() for c in cores)
        route = "fused route" if fused else "staged route"
        label = f"tinyllama {role} B={b} {str(xdt).split('.')[-1]} ({route})"
        self.record("tt_linear_bwd", label, got, want[0], tol,
                    f"dx = dz·Wᵀ through the kernel on the transposed train against autograd "
                    f"of the plain version; bound by the {order} order of Wᵀ, "
                    f"{orders[order] / 1e6:.2f} MFLOP a row",
                    ms, plain_ms, lib_ms, "torch.matmul(dz, Wᵀ), dense reconstructed W",
                    nbytes, b * orders[order],
                    BF16_FLOPS if xdt == torch.bfloat16 else F32_FLOPS)
        ok = math.isfinite(dc_err) and dc_err <= tol
        print(f"[tt_linear_bwd] {label}: d-cores GEMMs {dc_ms:.4f} ms, worst core "
              f"max|d| {dc_err:.3e} of max|plain| (tol {tol:g}) {'ok' if ok else 'FAIL'}; "
              f"plain forward + autograd backward {autograd_ms:.4f} ms", flush=True)
        self.phases["tt_linear_bwd"][-1]["d_cores_ms"] = dc_ms
        if not ok:
            self.failures.append(f"tt_linear_bwd {label}: d-cores {dc_err} > {tol}")

    def _train_setup(self, n_layers=None, **train_kw):
        """tinyllama-1.1b (full width; ``n_layers`` cut when given), its
        TrainConfig (global batch 8, seq_len 2048) and DataConfig."""
        from repro_torch.config import TrainConfig
        from repro_torch.configs import get_config
        from repro_torch.data import DataConfig
        from repro_torch.models import build_model
        cfg = get_config("tinyllama-1.1b")
        if n_layers is not None:
            cfg = cfg.replace(n_layers=n_layers)
        tc = TrainConfig(global_batch=8, seq_len=2048, **train_kw)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
                        global_batch=tc.global_batch, seed=SEED)
        return cfg, build_model(cfg, device=self.dev), tc, dc

    def _batch(self, dc, step):
        from repro_torch.data import make_source
        return {k: self.torch.from_numpy(v).to(self.dev)
                for k, v in make_source(dc).batch(step).items()}

    @staticmethod
    def _state_leaves(state):
        """(name, tensor) of a TrainState in the port's layout."""
        from repro_torch.tree import flatten_with_paths
        return flatten_with_paths([state.params, [state.opt.inner, state.opt.step], state.step])

    def train_tinyllama(self, card):
        """[train tinyllama-1.1b]: the published config at full width and
        depth (22 layers, d 2048, 32 heads of 64 over 4 KV heads, d_ff 5632,
        vocab 32000 untied; TT rank 16 d 4 on attn_o and the MLP, q/k/v
        dense; f32 params, bf16 compute), random params from the seed,
        global batch 8 x seq_len 2048, remat "full", AdamW, SyntheticLM
        seed 0.  Step 0's loss and every param leaf's gradient, hand kernels
        against ``force_plain()`` on the same batch and both against the
        plain versions computing in f32 (each leaf's |g_k - g_p| / |g_p|
        within TRAIN_GRAD_TOL and within TRAIN_GRAD_RATIO of its
        |g_p - g_f32|; the losses within TRAIN_LOSS_TOL); 4 steps through the
        Trainer with every launch counted (tt_linear's forward, its
        backward's recompute of u and its dx apart; no plain version on the
        card); a forced AsyncCheckpointer save, restored bitwise; one more
        step profiled.  Returns the run's launch counters."""
        import statistics
        import tempfile
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.checkpoint import restore_checkpoint
        from repro_torch.kernels import dispatch
        from repro_torch.kernels import tt_linear as k
        from repro_torch.models import build_model
        from repro_torch.train import Trainer, build_train_step, init_train_state, loss_and_grads
        from repro_torch.tree import flatten_with_paths
        path = "train tinyllama-1.1b"
        cfg, model, tc, dc = self._train_setup(remat="full", optimizer="adamw")
        t0 = time.perf_counter()
        state = init_train_state(model, tc, SEED, device=self.dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for _, p in flatten_with_paths(state.params))
        print(f"[{path}] {card}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
              f"{cfg.head_dim} over {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}; {n_params / 1e6:.1f} M f32 params + AdamW state in "
              f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} "
              f"GiB allocated; batch {tc.global_batch} x {tc.seq_len}, remat {tc.remat}",
              flush=True)
        batch0 = self._batch(dc, 0)
        loss_k, _, g_k = loss_and_grads(model, state.params, batch0, tc)
        with dispatch.force_plain():
            loss_p, _, g_p = loss_and_grads(model, state.params, batch0, tc)
        # the plain versions computing in f32 on the same params and batch: how far
        # each bf16 route's rounding moves the gradients
        ref_model = build_model(cfg.replace(compute_dtype="float32"), device=self.dev)
        with dispatch.force_plain():
            loss_r, _, g_r = loss_and_grads(ref_model, state.params, batch0, tc)
        rows = []  # (|g_k - g_p| / |g_p|, its ratio to |g_p - g_f32|, name, |g_p|)
        to_f32 = {"hand kernels": [], "force_plain()": []}
        for (name, a), (_, b), (_, r) in zip(flatten_with_paths(g_k), flatten_with_paths(g_p),
                                             flatten_with_paths(g_r)):
            a, b = a.float(), b.float()
            norm, r_norm = b.norm().item(), max(r.norm().item(), 1e-30)
            d_kp, d_pr = (a - b).norm().item(), (b - r).norm().item()
            to_f32["hand kernels"].append((a - r).norm().item() / r_norm)
            to_f32["force_plain()"].append(d_pr / r_norm)
            rows.append((d_kp / max(norm, 1e-30), d_kp / max(d_pr, 1e-30), name, norm))
        del g_k, g_p, g_r, ref_model
        torch.cuda.empty_cache()
        def desc(v):  # sorts the largest first, a non-finite value before all
            return -v if math.isfinite(v) else -math.inf

        rows.sort(key=lambda t: desc(t[0]))
        worst = rows[0][0]
        worst_ratio = min(rows, key=lambda t: desc(t[1]))
        grad_checks = {
            f"every leaf |g_k - g_p| / |g_p| <= {TRAIN_GRAD_TOL}":
                math.isfinite(worst) and worst <= TRAIN_GRAD_TOL,
            f"every leaf |g_k - g_p| <= {TRAIN_GRAD_RATIO} |g_p - g_f32|":
                all(math.isfinite(t[1]) and t[1] <= TRAIN_GRAD_RATIO for t in rows),
            f"|loss_k - loss_p| <= {TRAIN_LOSS_TOL:g}":
                abs(float(loss_k) - float(loss_p)) <= TRAIN_LOSS_TOL,
        }
        by_kind = {}
        for rel, ratio, name, _ in rows:
            by_kind.setdefault(name.split("/")[-2] if "/cores/" not in name else "tt cores",
                               []).append((rel, ratio))
        ratios = sorted(t[1] for t in rows)
        print(f"[{path}] step 0, hand kernels vs force_plain(): loss {float(loss_k):.5f} vs "
              f"{float(loss_p):.5f}; worst of {len(rows)} gradient leaves |g_k - g_p| / |g_p| "
              f"= {worst:.3e} at {rows[0][2]} (bound {TRAIN_GRAD_TOL}); median "
              f"{rows[len(rows) // 2][0]:.3e}; |g_k - g_p| / |g_p - g_f32| worst "
              f"{worst_ratio[1]:.3f} at {worst_ratio[2]}, median {ratios[len(ratios) // 2]:.3f} "
              f"(bound {TRAIN_GRAD_RATIO}); next worst "
              + ", ".join(f"{n} {r:.2e} (|g| {g:.2e})" for r, _, n, g in rows[:6])
              + "; worst by kind (rel, ratio): "
              + ", ".join(f"{k_} {max(r for r, _ in v):.2e} {max(q for _, q in v):.3f}"
                          for k_, v in sorted(by_kind.items()))
              + f"; checks: {grad_checks}", flush=True)
        for what, losses in (("hand kernels", loss_k), ("force_plain()", loss_p)):
            dist = sorted(to_f32[what])
            print(f"[{path}] step 0, {what} (bf16) against the f32 reference: loss "
                  f"{float(losses):.5f} vs {float(loss_r):.5f}; gradient leaves "
                  f"|g - g_f32| / |g_f32| worst {dist[-1]:.3e}, median "
                  f"{dist[len(dist) // 2]:.3e}", flush=True)
        for what, good in grad_checks.items():
            if not good:
                self.failures.append(f"{path}: step 0 gradients: {what}")

        step_fn = build_train_step(model, tc)
        with tempfile.TemporaryDirectory() as ckpt_dir:
            tr = Trainer(step_fn, state, dc, ckpt_dir=ckpt_dir, ckpt_every=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            rep = tr.run(4, log_every=0)
            torch.cuda.synchronize()
            counts = counters()
            tt = {"forward": k.launches - k.bwd_launches - k.recompute_launches,
                  "recompute": k.recompute_launches, "backward dx": k.bwd_launches}
            peak = torch.cuda.max_memory_allocated() / 2**30
            t_ckpt = time.perf_counter()
            restored, _ = restore_checkpoint(ckpt_dir, tr.current_step(), tr.state)
            t_ckpt = time.perf_counter() - t_ckpt
            live = self._state_leaves(tr.state)
            back = self._state_leaves(restored)
            differ = [n for (n, a), (m, b) in zip(live, back)
                      if n != m or a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
            ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*") if f.is_file())
        del restored
        per_step = {what: n / len(rep.losses) for what, n in tt.items()}
        f_layer, rec_layer = self._tt_launches_a_layer(cfg)
        want = {"forward": 2 * cfg.n_layers * f_layer, "recompute": cfg.n_layers * rec_layer,
                "backward dx": cfg.n_layers * f_layer}
        ln_v = math.log(cfg.vocab_size)
        checks = {
            "4 steps, losses finite": rep.steps_done == 4 and rep.restarts == 0
            and all(math.isfinite(v) for v in rep.losses),
            "step 0 within 0.5 of ln V": abs(rep.losses[0] - ln_v) <= 0.5,
            f"step 0 within {TRAIN_INIT_LOSS_TOL} of ln V + 1/2":
                abs(rep.losses[0] - ln_v - 0.5) <= TRAIN_INIT_LOSS_TOL,
            "tt_linear launches a step as predicted": per_step == want,
            "no plain version on the card": all(p == 0 for _, p in counts.values()),
            "every kernel of the path launched": all(counts[k][0] > 0
                                                     for k in PATH_KERNELS[path]),
            "checkpoint restored bitwise": not differ and len(live) == len(back),
        }
        times = rep.step_times
        print(f"[{path}] {card}: losses {[round(v, 4) for v in rep.losses]} (ln V {ln_v:.4f}); "
              f"step wall {[round(t * 1e3, 1) for t in times]} ms, tokens/s "
              f"{tc.global_batch * tc.seq_len / statistics.mean(times[1:]):.0f} (steps 1-3); "
              f"peak {peak:.2f} GiB; tt_linear launches {tt} ({per_step} a step, predicted "
              f"{want}), tt_linear.plain_cuda_calls {counts['tt_linear'][1]}; checkpoint of step {tr.current_step()}: {ckpt_bytes / 2**30:.2f} GiB "
              f"restored in {t_ckpt:.1f} s, {len(live)} leaves, {len(differ)} differ; checks: "
              f"{checks}", flush=True)
        for what, good in checks.items():
            if not good:
                self.failures.append(f"{path}: {what}")

        batch = self._batch(dc, tr.current_step())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, metrics = step_fn(tr.state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = kernel_events(prof)
        device_s = sum(e.self_device_time_total for e in events) / 1e6
        hand_s = sum(e.self_device_time_total for e in events if hand_kernel(e.key)) / 1e6
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        print(f"[{path}] {card}: one step profiled: wall {wall * 1e3:.1f} ms, device kernel "
              f"time {device_s * 1e3:.1f} ms, device busy share {device_s / wall:.3f}; hand "
              f"kernels {hand_s * 1e3:.1f} ms; {sum(e.count for e in events)} device kernels; "
              f"top: " + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms"
                                  for e in top), flush=True)
        del tr, state, model
        torch.cuda.empty_cache()
        return {k: n for k, (n, _) in counts.items()}

    @staticmethod
    def _tt_launches_a_layer(cfg):
        """(a block's tt_linear launches in one forward, its launches
        recomputing u in one backward): 2 a TT linear (the fused route), and
        the TT linears with an activation (tinyllama: the gate's silu)."""
        from repro_torch.models.transformer import make_block_specs
        sp = make_block_specs(cfg, True)
        tt = [nm for nm, s in (*sp.attn, *sp.mlp) if s.kind == "tt"]
        return 2 * len(tt), 2 * ("gate" in tt)

    def train_remat(self, card):
        """[train remat]: tinyllama-1.1b at full width and 2 layers, one
        batch (8 x 2048) through ``loss_and_grads`` under remat "none",
        "dots" and "full": loss and grads equal across the three (bitwise,
        or within 1e-6 of each leaf's norm where an op is not
        deterministic), peak memory none > dots > full, tt_linear forward
        launches F, F and 2F (F = one forward's), the backward's on top."""
        torch = self.torch
        from repro_torch.kernels import tt_linear as k
        from repro_torch.train import loss_and_grads
        from repro_torch.tree import flatten_with_paths
        path = "train remat"
        cfg, model, tc, dc = self._train_setup(n_layers=2)
        params = model.init(SEED, device=self.dev)
        batch = self._batch(dc, 0)
        out = {}
        for policy in ("none", "dots", "full"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.perf_counter()
            loss, _, grads = loss_and_grads(model, params, batch,
                                            dataclasses.replace(tc, remat=policy))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            fwd = k.launches - k.bwd_launches - k.recompute_launches
            out[policy] = (loss, flatten_with_paths(grads), peak, fwd, k.bwd_launches,
                           k.recompute_launches, wall)
            del grads
        f = self._tt_launches_a_layer(cfg)[0] * cfg.n_layers
        worst, bitwise = 0.0, True
        for policy in ("dots", "full"):
            bitwise &= torch.equal(out[policy][0], out["none"][0])
            for (_, a), (_, b) in zip(out[policy][1], out["none"][1]):
                if not torch.equal(a, b):
                    bitwise = False
                    worst = max(worst, ((a - b).float().norm()
                                        / b.float().norm().clamp(min=1e-30)).item())
        checks = {
            "loss and grads equal": bitwise or worst <= 1e-6,
            "peak none > dots > full": out["none"][2] > out["dots"][2] > out["full"][2],
            "forward launches F, F, 2F": (out["none"][3], out["dots"][3], out["full"][3])
            == (f, f, 2 * f),
        }
        for policy, (loss, _, peak, fwd, bwd, rec, wall) in out.items():
            print(f"[{path}] {card}: remat {policy}: loss {float(loss):.6f}, peak {peak:.2f} GiB "
                  f"above the params, tt_linear launches forward {fwd} (F = {f}), backward dx "
                  f"{bwd}, recompute {rec}; wall {wall * 1e3:.1f} ms", flush=True)
        print(f"[{path}] grads across policies: "
              f"{'bitwise equal' if bitwise else f'worst leaf {worst:.3e} of its norm'}; "
              f"checks: {checks}", flush=True)
        for what, good in checks.items():
            if not good:
                self.failures.append(f"{path}: {what}")
        del out, params, model
        torch.cuda.empty_cache()

    def train_trainer(self, card):
        """[train trainer]: tinyllama-1.1b at full width and 2 layers, 30
        steps through the Trainer at lr 3e-3 (warmup 5, remat none, AdamW),
        an AsyncCheckpointer every 10 steps, a fault injected at step 12:
        one restart from the step-10 checkpoint, all 30 steps done, and the
        mean of the last 5 losses at least 0.2 below the first 5's."""
        import statistics
        import tempfile
        torch = self.torch
        from repro_torch.obs import ObsConfig
        from repro_torch.train import Trainer, build_train_step, init_train_state
        path = "train trainer"
        cfg, model, tc, dc = self._train_setup(n_layers=2, lr=3e-3, warmup_steps=5,
                                               total_steps=30, remat="none")
        state = init_train_state(model, tc, SEED, device=self.dev)
        boom = {"armed": True}

        def injector(step):
            if step == 12 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected fault")

        with tempfile.TemporaryDirectory() as ckpt_dir:
            tr = Trainer(build_train_step(model, tc), state, dc, ckpt_dir=ckpt_dir,
                         ckpt_every=10, obs=ObsConfig())
            t0 = time.perf_counter()
            rep = tr.run(30, log_every=0, fault_injector=injector)
            wall = time.perf_counter() - t0
            saved = list(tr.ckpt.saved_steps)
        first, last = statistics.mean(rep.losses[:5]), statistics.mean(rep.losses[-5:])
        reg = tr.obs.registry
        checks = {"loss falls by >= 0.2": last <= first - 0.2,
                  "one restart, 30 steps done": rep.restarts == 1 and rep.steps_done == 30,
                  "restored from the step-10 checkpoint": 10 in saved
                  and tr.current_step() == 28,
                  "obs counters": reg.counter("train_steps_total").value == 30
                  and reg.counter("train_restarts_total").value == 1}
        print(f"[{path}] {card}: losses {[round(v, 3) for v in rep.losses]}; first 5 mean "
              f"{first:.4f}, last 5 mean {last:.4f} (fell {first - last:.4f}); restarts "
              f"{rep.restarts}, checkpoints {saved}; step wall median "
              f"{statistics.median(rep.step_times) * 1e3:.1f} ms, tokens/s gauge "
              f"{reg.gauge('train_tokens_per_second').value:.0f}; run {wall:.1f} s; checks: "
              f"{checks}", flush=True)
        for what, good in checks.items():
            if not good:
                self.failures.append(f"{path}: {what}")
        del tr, state, model
        self.torch.cuda.empty_cache()

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import griffin, rwkv, transformer, whisper
    from repro_torch.models.modules import embed_spec, init_embed, linear_spec
    from repro_torch.serve.steps import serve_config_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(card, flush=True)
    _build.lib()
    print(f"[build] kernels built/loaded in {_build.build_seconds:.1f} s "
          f"(nvcc sm_90a, {len(list(_build.CSRC.glob('*.cu')))} sources)", flush=True)

    s = Smoke()
    t_phase = time.perf_counter()
    for arch in ("llama2-7b", "chatglm3-6b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        roles = {"llama2-7b": ("attn_o", "mlp_gate", "mlp_up", "mlp_down")}.get(
            arch, ("attn_o", "mlp_gate", "mlp_down"))  # gate and up share a spec
        for role in roles:
            n_in, n_out = {"attn_o": (cfg.q_dim, cfg.d_model),
                           "mlp_down": (cfg.d_ff, cfg.d_model)}.get(role, (cfg.d_model, cfg.d_ff))
            spec = linear_spec(cfg, role, n_in, n_out).tt
            for b in (8, 2048):
                s.tt_phase(arch, role.replace("mlp_", ""), spec, b)
                if arch == "chatglm3-6b" and role == "mlp_gate":  # compress_model's cores
                    s.tt_phase(arch, "gate", spec, b, core_dtype=torch.float32)
    rw = serve_config_of(get_config("rwkv6-7b"))
    for role, n_in, n_out, epi in (("tm_out", 4096, 4096, None),
                                   ("cm_key", 4096, rw.d_ff, dict(activation="relu2")),
                                   ("cm_value", rw.d_ff, 4096, {})):
        for b in (8, 2048):
            s.tt_phase("rwkv6-7b", role, linear_spec(rw, role, n_in, n_out).tt, b, epi)
    for k_in, m in ((4096, 4096), (4096, 11008), (11008, 4096), (2560, 2560), (2560, 256)):
        for b in (8, 2048):
            s.int4_phase(k_in, m, b)
    for b in (17, 300):  # 17: the GEMV since its crossover moved to 24; 300: a ragged third GEMM tile
        s.int4_phase(4096, 4096, b)
    for k_in, m in ((4096, 4096), (11008, 4096)):  # the decode GEMV at one and 16 slots
        for b in (1, 16):
            s.int4_phase(k_in, m, b)
    for k_in, m in ((4096, 4096), (4096, 11008)):  # the crossover: both routes, one card
        for b in (16, 17, 24, 32, 48):
            s.int4_phase(k_in, m, b, routes=("gemv", "gemm"))
    for decode in (True, False):
        for hkv in (32, 2):
            for int8 in (False, True):
                s.attn_phase(decode, hkv, int8)
        for int8 in (False, True):  # the paged layout at head_dim 256 (griffin's heads)
            s.attn_phase(decode, 1, int8, h=10, dh=256)
    # recurrentgemma-2b's rings: window 2048 + chunk 256; contexts past one wrap
    rg_ctx = (3000, 2400, 1500, 256, 3900, 700, 0, 2304)
    for sq in (1, 256):
        for int8 in (False, True):
            s.ring_phase("recurrentgemma-2b", sq, 10, 1, 256, 2048, 2304, int8, rg_ctx)
    s.ring_phase("llama2-7b-shaped", 256, 32, 32, 128, 0, 2048, False,
                 (1500, 600, 2048, 256, 0, 1000, 64, 1800))
    # short contexts: most of each ring is empty and its tiles are skipped
    s.ring_phase("recurrentgemma-2b short", 256, 10, 1, 256, 2048, 2304, False,
                 (300, 512, 64, 256, 0, 700, 128, 400))
    for steps in (1, 256):
        s.rglru_phase(steps)
    for steps in (1, 256):
        s.rglru_gated_phase(steps)
    llama_embed = serve_config_of(get_config("llama2-7b"))
    llama_embed = llama_embed.replace(ttd=dataclasses.replace(llama_embed.ttd, embed=True))
    for t in (8, 2048):
        s.tt_embed_phase(embed_spec(llama_embed).tt, t)
    for steps in (1, 256):
        for int8 in (False, True):
            s.wkv_phase(steps, int8)
    # MoE: the experts' grouped TT linears (rows sorted by expert), the routers'
    # int4 linears on f32 activations, one full-width kimi-k2 MoE layer
    for arch, cases in (("mixtral-8x22b", {"gate": ((8, "router"), (2048, "router"),
                                                    (2048, "one expert"), (2048, "most empty")),
                                           "down": ((8, "router"), (2048, "router"))}),
                        ("kimi-k2-1t-a32b", {"gate": ((8, "router"), (2048, "router"),
                                                      (2048, "most empty")),
                                             "down": ((8, "router"), (2048, "router"))})):
        mcfg = serve_config_of(get_config(arch))
        for role, role_cases in cases.items():
            n_in, n_out = (mcfg.d_model, mcfg.d_ff_expert) if role == "gate" else \
                (mcfg.d_ff_expert, mcfg.d_model)
            s.tt_grouped_phases(arch, role, linear_spec(mcfg, f"expert_{role}", n_in, n_out).tt,
                                mcfg.n_experts, mcfg.experts_per_token, role_cases)
        for b in (8, 2048):
            s.int4_f32_phase(arch, mcfg.d_model, mcfg.n_experts, b)
    for t in (8, 2048):
        s.moe_layer_phase(t)
    s.kimi_layer = None
    torch.cuda.empty_cache()
    # head_dim 112 (kimi-k2-1t-a32b: H64/Hkv8): paged decode and prefill over
    # bf16 and int8 pools, and the ring layout's decode and prefill over
    # wrapped rings (window 2048 + chunk 256, recurrentgemma-2b's contexts).
    # Their draws come from generators of their own, so every other phase
    # and path sees the inputs it saw before these phases were added.
    with s.own_generators(SEED + 112):
        for decode in (True, False):
            for int8 in (False, True):
                s.attn_phase(decode, 8, int8, h=64, dh=112)
        for sq in (1, 256):
            s.ring_phase("kimi-k2-shaped", sq, 64, 8, 112, 2048, 2304, False, rg_ctx)
    # whisper-base: paged decode and prefill at H8/Hkv8/Dh64, its d = 3 TT
    # specs (a one-core half) with their biased epilogues, its biased int4
    # q/v at a decode tick and past the encoder's 1500 rows
    with s.own_generators(SEED + 64):
        for decode in (True, False):
            for int8 in (False, True):
                s.attn_phase(decode, 8, int8, h=8, dh=64)
        wcfg = serve_config_of(get_config("whisper-base"))
        for role, n_in, n_out in (("attn_o", 512, 512), ("mlp_up", 512, 2048),
                                  ("mlp_down", 2048, 512)):
            spec = linear_spec(wcfg, role, n_in, n_out).tt
            for b in (8, 2048):
                epi = dict(bias=s.randn(n_out, scale=0.1))
                if role == "mlp_up":
                    epi["activation"] = "gelu"
                else:
                    epi["residual"] = s.randn(b, n_out, dtype=torch.bfloat16)
                s.tt_phase("whisper-base", role.replace("mlp_", ""), spec, b, epi)
        for b in (8, 1536):
            s.int4_phase(512, 512, b, bias=True)
    # qwen2-vl-7b (the single-sequence path): its TT specs (modes 8,8,8,7 and
    # 37,8,8,8) and its int4 q and k/v at a decode token and a 2048-token prefill
    with s.own_generators(SEED + 7):
        qcfg = serve_config_of(get_config("qwen2-vl-7b"))
        for role, n_in, n_out in (("attn_o", 3584, 3584), ("mlp_gate", 3584, 18944),
                                  ("mlp_down", 18944, 3584)):
            for b in (1, 2048):
                s.tt_phase("qwen2-vl-7b", role.replace("mlp_", ""),
                           linear_spec(qcfg, role, n_in, n_out).tt, b)
        for m in (3584, 512):
            for b in (1, 2048):
                s.int4_phase(3584, m, b)
    print(f"[phases] kernel phases took {time.perf_counter() - t_phase:.1f} s", flush=True)

    launches = {}
    models = {"dense": transformer, "moe": transformer, "griffin": griffin, "rwkv": rwkv,
              "encdec": whisper}
    params = None
    # (path, arch, max_len, prompt lengths in [lo, hi)); the TT-embed path
    # reuses llama2-7b's params with TT embedding cores in place of the table;
    # the compressed path serves what the port's compress_model made and
    # load_compressed read back
    for path, arch, max_len, lo, hi in (("llama2-7b", "llama2-7b", 2048, 64, 1537),
                                        ("llama2-7b-tt-embed", "llama2-7b", 2048, 64, 1537),
                                        ("recurrentgemma-2b", "recurrentgemma-2b", 4096, 64,
                                         3073),
                                        ("rwkv6-7b", "rwkv6-7b", 2048, 64, 1537),
                                        ("chatglm3-6b-compressed", "chatglm3-6b", 2048, 64,
                                         1537),
                                        ("mixtral-8x22b", "mixtral-8x22b", 2048, 64, 1025),
                                        ("kimi-k2-1t-a32b", "kimi-k2-1t-a32b", 2048, 64,
                                         1025),
                                        ("whisper-base", "whisper-base", 1024, 4, 449)):
        cfg = serve_config_of(get_config(arch))
        lens = s.rng.integers(lo, hi, 8)
        # one prompt wraps its ring where the prompts may pass the window
        if cfg.window and cfg.window + 257 < hi and lens.max() <= cfg.window + 256:
            lens[int(lens.argmax())] = s.rng.integers(cfg.window + 257, hi)
        prompts = [[int(t) for t in s.rng.integers(0, cfg.vocab_size, n)] for n in lens]
        t0 = time.perf_counter()
        planted = None
        if path == "chatglm3-6b-compressed":
            params = None
            torch.cuda.empty_cache()
            params, planted = s.compressed_params(cfg, prompts, card)
        elif path == "llama2-7b-tt-embed":
            cfg = llama_embed
            dense_bytes = params["embed"]["table"].numel() * params["embed"]["table"].element_size()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            params["embed"] = init_embed(cfg, torch.bfloat16, generator=gen, device="cuda")
            tt_bytes = sum(c.numel() * c.element_size() for c in params["embed"]["cores"])
            torch.cuda.empty_cache()
            print(f"[init] {path}: embedding table {list(embed_spec(cfg).tt.out_modes)} x "
                  f"{list(embed_spec(cfg).tt.in_modes)} rank 16 TT cores, {tt_bytes} bytes "
                  f"against {dense_bytes} bytes of the dense bf16 table ({dense_bytes - tt_bytes} "
                  f"bytes saved, {dense_bytes / tt_bytes:.0f}x); "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
        else:
            params = None
            torch.cuda.empty_cache()
            params = models[cfg.family].init_lm(cfg, seed=SEED, device="cuda")
            if cfg.family == "encdec":
                s.seeded_biases(params)
            torch.cuda.synchronize()
            print(f"[init] {arch} serving config ({cfg.n_layers} layers, int4 g128 + TT, bf16) "
                  f"random params in {time.perf_counter() - t0:.1f} s; "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
        frames = host_frames = None
        if cfg.family == "encdec":  # a request's (1500, 512) stub-frontend frames each
            host_frames = [s.rng.standard_normal((cfg.enc_len, cfg.d_model)).astype(np.float32)
                           for _ in prompts]
            frames = [torch.from_numpy(f).to(s.dev) for f in host_frames]
        if cfg.family == "rwkv":
            s.layerwise_check(cfg, params, prompts, path)
        elif cfg.family == "moe":
            t_check = time.perf_counter()
            s.moe_layerwise_check(cfg, params, prompts, max_len, path)
            print(f"[layers {path}] the layer-by-layer check took "
                  f"{time.perf_counter() - t_check:.1f} s", flush=True)
        else:
            s.logits_check(cfg, params, prompts, max_len,
                           every_position=cfg.vocab_size <= 65536, path=path, frames=frames)
        if planted is not None:
            s.planted_vs_loaded(cfg, params, planted, path)
            planted = None
        torch.cuda.reset_peak_memory_stats()
        counts = s.serve(cfg, params, card, prompts, max_len, path, frames=host_frames)
        launches.update({k: counts[k] for k in PATH_KERNELS[path] if k not in launches})
        launches[path] = counts
        s.profile(cfg, params, card, max_len, path, frames=frames)
        if path == "llama2-7b":  # the single-sequence reference against the Engine
            s.solo_engine(cfg, params, prompts, max_len, path, card)
        if path == "llama2-7b":  # the serving front end on the paper's main path
            t_front = time.perf_counter()
            s.frontend(cfg, params, card, max_len, path)
            t_traffic = time.perf_counter()
            s.traffic(cfg, params, card, max_len, path)
            print(f"[frontend {path}] took {t_traffic - t_front:.1f} s; [traffic {path}] "
                  f"{time.perf_counter() - t_traffic:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()
    t_solo = time.perf_counter()
    for arch in SOLO_FAMILY_KERNELS:
        s.solo_family(arch, card)
    launches["solo qwen2-vl-7b"] = s.solo_qwen(card)
    print(f"[solo] the single-sequence phases took {time.perf_counter() - t_solo:.1f} s",
          flush=True)
    # training: the tt_linear backward at tinyllama-1.1b's specs, then
    # tinyllama-1.1b trained at full width and depth, the remat policies and
    # the Trainer's fault tolerance at 2 layers
    t_train = time.perf_counter()
    with s.own_generators(SEED + 28):
        tcfg = get_config("tinyllama-1.1b")
        for role, n_in, n_out in (("attn_o", 2048, 2048), ("mlp_gate", 2048, tcfg.d_ff),
                                  ("mlp_down", tcfg.d_ff, 2048)):
            spec = linear_spec(tcfg, role, n_in, n_out).tt
            for b in (2048, 16384):
                s.tt_bwd_phase(role.replace("mlp_", ""), spec, b, torch.bfloat16)
            s.tt_bwd_phase(role.replace("mlp_", ""), spec, 2048, torch.float32)
    torch.cuda.empty_cache()
    launches["train tinyllama-1.1b"] = s.train_tinyllama(card)
    launches["tt_linear_bwd"] = launches["train tinyllama-1.1b"]["tt_linear_bwd"]
    s.train_remat(card)
    s.train_trainer(card)
    print(f"[train] the training phases took {time.perf_counter() - t_train:.1f} s", flush=True)

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        main = s.phases[name][0]  # the first phase of each kernel is its decode shape
        kernels.append({"name": DISPLAY_NAMES.get(name, name), "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[name], "max_abs_err": main["max_abs_err"],
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"], "shape": main["label"],
                        "launches_by_path": {path: launches[path][name]
                                             for path in PATH_KERNELS}})
    if s.failures:
        print("FAILED: " + "; ".join(s.failures), flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
