#!/usr/bin/env python3
"""On-card smoke run of the repro_torch port (PyTorch + hand-written Hopper kernels).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the four CUDA kernels from ``src/repro_torch/csrc`` (first use),
then:

1. kernel phases — each kernel against its plain PyTorch version at the
   serving path's shapes, with its time, the plain version's time, one
   PyTorch library call's time as a yardstick, and the card's bound;
2. a logits check at the serve phase's geometry — the full-width llama2-7b
   session with 8 slots prefilling the serve phase's 8 prompts (up to 1536
   tokens, several 256-token chunks) and then taking 4 decode steps, through
   the kernels against the same steps through the plain versions
   (``dispatch.force_plain()``) on the card;
3. the serve phase — the paged continuous-batching ``Engine`` serving those
   8 requests on the full-width llama2-7b serving config (random weights from
   a seed), with every kernel's launch counter reset just before and read
   just after;
4. a profile of full-width decode steps: wall time against device kernel
   time (``torch.profiler``), the device's busy share and the top kernels.

It prints the card's name and power limit, a ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.  It exits
non-zero, without the last line, when there is no CUDA device, when the
package is missing, or when any phase fails.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
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
SEED = 0
# Attention outputs are held element by element: |got - want| <= ATTN_ATOL *
# max|want| of the element's own (query, head) row + ATTN_RTOL * |want|, each
# 2-4 bf16 ulps (an ulp of m is 2^-8..2^-7 of m).  Both sides round the output
# to bf16, and the prefill kernel rounds P (and, from int8 pools, the
# dequantized K and V) to bf16 for its mma products, so its error follows the
# size of the values a row averages, which the row's max reflects: with the
# atol at one ulp (2^-8) the int8 prefill phases reached 1.4 of it.
ATTN_ATOL, ATTN_RTOL = 2.0 ** -6, 2.0 ** -6

SOURCES = {
    "tt_linear": ("src/repro_torch/csrc/tt_linear.cu", "src/repro/kernels/tt_linear.py:91"),
    "int4_matmul": ("src/repro_torch/csrc/int4_matmul.cu", "src/repro/kernels/int4_matmul.py:57"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:78"),
    "prefill_attention": ("src/repro_torch/csrc/prefill_attention.cu",
                          "src/repro/kernels/prefill_attention.py:118"),
}


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
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

    # -- helpers --------------------------------------------------------------
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

    def row_ratio(self, got, want) -> float:
        """Worst |got - want| / (ATTN_ATOL * row max|want| + ATTN_RTOL * |want|)
        over all elements, rows along the last axis; <= 1 passes."""
        torch = self.torch
        got, want = got.float(), want.float()
        d = (got - want).abs()
        lim = ATTN_ATOL * want.abs().amax(-1, keepdim=True) + ATTN_RTOL * want.abs()
        ratio = torch.where(d == 0, torch.zeros_like(d), d / lim)  # lim 0, d > 0 -> inf
        return ratio.max().item()

    def record(self, kernel, label, got, want, rel_tol, why, ms, plain_ms, lib_ms, lib_what,
               nbytes, flops):
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
        b_ms, b_by = bound(nbytes, flops)
        print(f"[{kernel}] {label}: max|d|={err:.3e} {tol_text} ({why}) "
              f"{'ok' if ok else 'FAIL'} | kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={'none' if lib_ms is None else f'{lib_ms:.4f}'} ({lib_what}) "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not ok:
            self.failures.append(f"{kernel} {label}: max|d| {err}, {tol_text}")
        self.phases[kernel].append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))

    # -- kernel phases --------------------------------------------------------
    def tt_phase(self, arch, role, spec, b):
        torch = self.torch
        from repro_torch.kernels import tt_linear as k
        cores = [self.randn(*s, dtype=torch.bfloat16, scale=1 / math.sqrt(s[0]))
                 for s in spec.core_matrix_shapes()]
        x = self.randn(b, spec.n_in, dtype=torch.bfloat16)
        epi = {"gate": dict(activation="silu"), "up": {}}.get(
            role, dict(residual=self.randn(b, spec.n_out, dtype=torch.bfloat16)))
        got = k.tt_linear(x, cores, spec, **epi)
        want = k.tt_linear_ref(x, cores, spec, **epi)
        ms = self.time_ms(lambda i: k.tt_linear(x, cores, spec, **epi))
        plain_ms = self.time_ms(lambda i: k.tt_linear_ref(x, cores, spec, **epi), iters=5)
        eye = torch.eye(spec.n_in, device=self.dev)
        w = k.tt_linear_ref(eye, [c.float() for c in cores], spec).to(torch.bfloat16)
        lib_ms = self.time_ms(lambda i: torch.matmul(x, w))
        del eye, w
        nbytes = 2 * (x.numel() + b * spec.n_out + sum(c.numel() for c in cores)
                      + (b * spec.n_out if "residual" in epi else 0))
        self.record("tt_linear", f"{arch} {role} B={b}", got, want, 3e-2,
                    "bf16: both round each of the 4 stages to bf16, summing in different orders",
                    ms, plain_ms, lib_ms, "torch.matmul, dense reconstructed W",
                    nbytes, b * spec.flops_per_token())

    def int4_phase(self, k_in, m, b):
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
        got = k.int4_matmul(x, ws[0]["qweight"], ws[0]["scales"], 128, **epi)
        want = k.int4_matmul_ref(x, ws[0]["qweight"], ws[0]["scales"], 128, **epi)

        def run(i, fn=k.int4_matmul):
            w = ws[i % copies]
            return fn(x, w["qweight"], w["scales"], 128, **epi)

        ms = self.time_ms(run)
        plain_ms = self.time_ms(lambda i: run(i, k.int4_matmul_ref), iters=5)
        dq = [dequantize_int4(w).T.contiguous() for w in ws[:max(1, math.ceil(copies / 4))]]
        lib_ms = self.time_ms(lambda i: torch.matmul(x, dq[i % len(dq)]))
        del dq
        nbytes = 2 * x.numel() + wbytes + 2 * m * (k_in // 128) + 2 * b * m \
            + (2 * b * m if "residual" in epi else 0)
        self.record("int4_matmul", f"{k_in}->{m} B={b}", got, want, 1e-2,
                    "bf16 output rounding; products are exact and summed in f32 in both",
                    ms, plain_ms, lib_ms, "torch.matmul, dequantized bf16 W",
                    nbytes, 2.0 * b * k_in * m)

    def _pool(self, nb, hkv, int8):
        torch = self.torch
        shape = (nb, 16, hkv, 128)
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

    def attn_phase(self, decode, hkv, int8, h=32, w=128, sq=256):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.kernels import prefill_attention as pf
        np = self.np
        b, dh, bs = 8, 128, 16
        nb = 1 + b * w
        cache = self._pool(nb, hkv, int8)
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
        label = f"{'decode B=8' if decode else f'prefill B=8 Sq={sq}'} H{h}/Hkv{hkv}/Dh128 " \
                f"{'int8' if int8 else 'bf16'} pool"
        self.record(name, label, got, want, "rows",
                    "bf16 output rounding; both read the same pool values", ms, plain_ms,
                    lib_ms, "scaled_dot_product_attention on the gathered context",
                    nbytes, flops)
        # The criterion must see a kernel that skips the last block of a long
        # row: the longest row's 16 newest keys dropped has to fail it.
        row = int(np.argmax(ctx))
        short = self.drop_newest_keys(q, cache, bt, qpos, row, bs)
        want_row = want[row:row + 1] if not decode else want[row][None, None]
        ratio = self.row_ratio(short, want_row)
        print(f"[{name}] {label}: the longest row ({int(ctx[row])} keys) with its newest "
              f"{bs} keys dropped sits at {ratio:.2f} of the tolerance (must exceed 1)",
              flush=True)
        if not ratio > 1.0:
            self.failures.append(f"{name} {label}: tolerance blind to a dropped last block")

    def drop_newest_keys(self, q, cache, bt, qpos, row, n):
        """Plain f32 attention of sequence ``row`` with the ``n`` newest keys
        of its context left out: what a kernel that stops one block early
        would return."""
        torch = self.torch
        from repro_torch.kernels import paged_attention as pa
        k, v = pa.gather_paged_kv(cache, bt[row:row + 1])
        _, sq, h, dh = q.shape
        hkv = k.shape[2]
        qr, pr = q[row:row + 1].float(), qpos[row:row + 1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qr.reshape(1, sq, hkv, h // hkv, dh),
                         k) / math.sqrt(dh)
        kpos = torch.arange(k.shape[1], device=self.dev)
        cut = int(pr.max().item()) + 1 - n
        mask = (kpos <= pr[..., None]) & (pr >= 0)[..., None] & (kpos < cut)
        s = s.masked_fill(~mask[:, None, None], float("-inf"))
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # fully masked rows give 0
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, v)
        return o.permute(0, 3, 1, 2, 4).reshape(1, sq, h, dh).to(q.dtype)

    # -- logits check ---------------------------------------------------------
    def logits_check(self, cfg, params, prompts, decode_steps: int = 4):
        """The serve phase's geometry (8 slots, its prompts in 256-token
        chunks, then ``decode_steps`` decode steps on fixed random tokens)
        through the kernels and through the plain versions: the logits of
        every prompt position and every decode step are compared."""
        torch, np = self.torch, self.np
        from repro_torch.kernels import dispatch
        from repro_torch.models.sessions import SessionSpec, make_session
        slots, chunk, max_len = len(prompts), 256, 2048
        spec = SessionSpec(slots=slots, max_len=max_len, prefill_chunk=chunk, block_size=16,
                           cache_dtype="bfloat16")
        width = max_len // 16
        bt = np.arange(1, 1 + slots * width, dtype=np.int32).reshape(slots, width)
        lens = np.array([len(p) for p in prompts])
        n_chunks = -(-int(lens.max()) // chunk)
        toks = np.zeros((slots, n_chunks * chunk), np.int32)
        pos = np.full((slots, n_chunks * chunk), -1, np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)], pos[i, :len(p)] = p, np.arange(len(p))
        toks, pos = (torch.from_numpy(a).to(self.dev) for a in (toks, pos))
        dec_toks = torch.from_numpy(self.rng.integers(0, cfg.vocab_size, (decode_steps, slots))
                                    .astype(np.int32)).to(self.dev)
        dec_pos = torch.from_numpy(lens.astype(np.int32)).to(self.dev)
        out = {}
        for plain in (False, True):
            sess = make_session(cfg, spec, device=self.dev)
            state = sess.with_tables(sess.init_state(), bt)
            pre, dec = [], []
            with dispatch.force_plain() if plain else contextlib.nullcontext():
                for c in range(n_chunks):
                    sl = slice(c * chunk, (c + 1) * chunk)
                    lg, state = sess.prefill_chunk(params, state, toks[:, sl], pos[:, sl])
                    pre.append(lg[pos[:, sl] >= 0])
                for i in range(decode_steps):
                    lg, state = sess.decode_step(params, state, dec_toks[i][:, None].contiguous(),
                                                 dec_pos + i)
                    dec.append(lg)
            out[plain] = (torch.cat(pre), torch.cat(dec))
            del state, pre, dec
            torch.cuda.empty_cache()
        ok = True
        for k, name in enumerate(("prefill", "decode")):
            a, b = out[False][k], out[True][k]
            scale = b.abs().max().item()
            rel = (a - b).abs().max().item() / scale
            mean_rel = (a - b).abs().mean().item() / b.abs().mean().item()
            # the kernel path's greedy token must be a top token of the plain path up to
            # the numerical tolerance: random weights give near-ties that may flip
            pick = a.argmax(-1, keepdim=True)
            gap = ((b.max(-1).values - b.gather(-1, pick)[:, 0]).max().item()) / scale
            agree = (pick[:, 0] == b.argmax(-1)).float().mean().item()
            good = all(map(math.isfinite, (rel, mean_rel, gap))) and rel <= 0.1 and \
                mean_rel <= 0.05 and gap <= 0.05
            ok &= good
            print(f"[logits] {name} ({a.shape[0]} rows: prompts {lens.tolist()} in {n_chunks} "
                  f"chunks of {chunk}, {decode_steps} decode steps x {slots} slots): "
                  f"max|d|/max|ref|={rel:.4f} (tol 0.1) "
                  f"mean|d|/mean|ref|={mean_rel:.4f} (tol 0.05) greedy-token logit gap "
                  f"{gap:.4f} of max|ref| (tol 0.05; argmax agreement {agree:.3f}) "
                  f"{'ok' if good else 'FAIL'} -- bf16 through 32 layers: kernels and plain "
                  "versions sum in different orders, so their bf16 roundings differ and the "
                  "differences compound layer by layer", flush=True)
        del out
        torch.cuda.empty_cache()
        if not ok:
            self.failures.append("full-width logits check")

    # -- serve phase (the main path) -----------------------------------------
    def serve(self, cfg, params, card, prompts):
        torch = self.torch
        np = self.np
        from repro_torch.kernels import int4_matmul, paged_attention, prefill_attention, tt_linear
        from repro_torch.serve.engine import Engine
        mods = {"tt_linear": tt_linear, "int4_matmul": int4_matmul,
                "paged_attention": paged_attention, "prefill_attention": prefill_attention}
        eng = Engine(cfg, params, slots=8, max_len=2048, block_size=16, prefill_chunk=256,
                     prefill_batch=4, cache_dtype="bfloat16", device=self.dev)
        dec = {"t": 0.0, "tokens": 0}
        orig_dispatch, orig_collect = eng._decode_dispatch, eng._decode_collect

        def dispatch(active):
            dec["t0"] = time.perf_counter()
            return orig_dispatch(active)

        def collect(active, toks):
            orig_collect(active, toks)
            dec["t"] += time.perf_counter() - dec["t0"]
            dec["tokens"] += len(active)

        eng._decode_dispatch, eng._decode_collect = dispatch, collect
        torch.cuda.synchronize()
        for m in mods.values():
            m.launches = 0
            m.plain_cuda_calls = 0
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_tokens=32) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: m.launches for k, m in mods.items()}
        plain = {k: m.plain_cuda_calls for k, m in mods.items()}
        ttft = np.array([r.t_first - r.t_submit for r in reqs])
        print(f"[serve] prompts={[len(p) for p in prompts]} launches={launches} "
              f"plain_calls_on_cuda={plain}", flush=True)
        print(f"[serve] {card}: TTFT p50={np.median(ttft) * 1e3:.1f} ms "
              f"max={ttft.max() * 1e3:.1f} ms; decode {dec['tokens']} tokens in "
              f"{dec['t']:.3f} s = {dec['tokens'] / dec['t']:.1f} tokens/s; "
              f"run wall {wall:.2f} s", flush=True)
        checks = {
            "every request finished with 32 tokens": all(
                r.done and len(r.out_tokens) == 32 for r in reqs),
            "pool drained": eng.num_free_blocks == eng.manager.num_blocks - 1,
            "every kernel launched": all(v > 0 for v in launches.values()),
            "no plain version on CUDA": not any(plain.values()),
            "tokens in vocab": all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
        }
        for what, good in checks.items():
            if not good:
                self.failures.append(f"serve: {what}")
        print(f"[serve] checks: {checks}", flush=True)
        return launches


    # -- decode-step profile ---------------------------------------------------
    def profile_decode(self, cfg, params, card, steps: int = 5):
        """Wall time vs device kernel time of full-width decode steps (8 slots
        at ~1 K context): the device's busy share and the top kernels."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.models.sessions import SessionSpec, make_session
        sess = make_session(cfg, SessionSpec(slots=8, max_len=2048, prefill_chunk=256,
                                             block_size=16, cache_dtype="bfloat16"),
                            device=self.dev)
        bt = self.np.arange(1, 1 + 8 * 128, dtype=self.np.int32).reshape(8, 128)
        state = sess.with_tables(sess.init_state(), bt)
        toks = torch.randint(0, cfg.vocab_size, (8, 256), device=self.dev,
                             dtype=torch.int32, generator=self.gen)
        pos = torch.arange(256, device=self.dev, dtype=torch.int32)[None].repeat(8, 1)
        for c in range(4):
            _, state = sess.prefill_chunk(params, state, toks, pos + 256 * c)
        dtok = toks[:, :1].contiguous()
        dpos = torch.full((8,), 1024, device=self.dev, dtype=torch.int32)
        for i in range(2):
            _, state = sess.decode_step(params, state, dtok, dpos + i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                _, state = sess.decode_step(params, state, dtok, dpos + 2 + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_time_total > 0
                  and not e.key.startswith(("aten::", "cuda"))]
        device_s = sum(e.self_device_time_total for e in events) / 1e6
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        print(f"[profile] {card}: decode step (8 slots, ctx ~1 K) wall "
              f"{wall / steps * 1e3:.2f} ms, device kernel time {device_s / steps * 1e3:.2f} ms, "
              f"device busy share {device_s / wall:.3f}; top kernels per step: "
              + "; ".join(f"{e.key[:48]} {e.self_device_time_total / steps / 1e3:.2f} ms"
                          for e in top), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np  # noqa: F401
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.modules import linear_spec
    from repro_torch.models.transformer import init_lm
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
    for arch in ("llama2-7b", "chatglm3-6b"):
        cfg = get_config(arch)
        roles = ("attn_o", "mlp_gate", "mlp_up", "mlp_down") if arch == "llama2-7b" \
            else ("attn_o", "mlp_gate", "mlp_down")  # chatglm3 gate and up share a spec
        for role in roles:
            n_in, n_out = {"attn_o": (cfg.q_dim, cfg.d_model),
                           "mlp_down": (cfg.d_ff, cfg.d_model)}.get(role, (cfg.d_model, cfg.d_ff))
            spec = linear_spec(cfg, role, n_in, n_out).tt
            for b in (8, 2048):
                s.tt_phase(arch, role.replace("mlp_", ""), spec, b)
    for k_in, m in ((4096, 4096), (4096, 11008), (11008, 4096)):
        for b in (8, 2048):
            s.int4_phase(k_in, m, b)
    for decode in (True, False):
        for hkv in (32, 2):
            for int8 in (False, True):
                s.attn_phase(decode, hkv, int8)
    print(f"[phases] kernel phases took {time.perf_counter() - t_phase:.1f} s", flush=True)

    cfg = serve_config_of(get_config("llama2-7b"))
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[init] llama2-7b serving config (32 layers, int4 g128 + TT blocks 13-31, bf16) "
          f"random params in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    prompts = [[int(t) for t in s.rng.integers(0, cfg.vocab_size, n)]
               for n in s.rng.integers(64, 1537, 8)]
    s.logits_check(cfg, params, prompts)
    launches = s.serve(cfg, params, card, prompts)
    s.profile_decode(cfg, params, card)

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        ph = s.phases[name]
        main = ph[0]  # the first phase of each kernel is its decode / main-path shape
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": main["max_abs_err"],
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"], "shape": main["label"]})
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
