#!/usr/bin/env python3
"""Device-time probes of the port's decode attention, wkv and RG-LRU kernels
on one NVIDIA H100, beside what ``chip_smoke.py`` measures.

``chip_smoke.py`` times a kernel by CUDA events over back-to-back calls;
under ~0.05 ms a call that figure carries the wrapper's host time.  These
probes read each call's device time from ``torch.profiler`` instead.  Run
from the repository root on a machine with the card:

    python3 tools/port_probe.py device-times [TREE]   # decode attention (Dh 112 too), wkv, RG-LRU
    python3 tools/port_probe.py griffin [TREE]        # recurrentgemma-2b tick and chunk
    python3 tools/port_probe.py splits 128 256 384    # paged decode by entries a split
    python3 tools/port_probe.py wkv-phases            # wkv prefill, one phase switched off
    python3 tools/port_probe.py rglru-variants        # RG-LRU prefill, design variants
    python3 tools/port_probe.py tt-svd                # ChatGLM3-6B's TT-SVD unfoldings
    python3 tools/port_probe.py int4 [TREE]           # int4 GEMV, crossover, f32 router
    python3 tools/port_probe.py int4-variants         # int4 GEMV, design variants
    python3 tools/port_probe.py int4-plans            # int4 GEMV, grid plans swept
    python3 tools/port_probe.py int4-host [TREE]      # int4 wrapper's host time a call
    python3 tools/port_probe.py tt-grouped [TREE]     # grouped tt_linear, each launch alone
    python3 tools/port_probe.py tt-grouped-routes     # grouped tt_linear, both routes by rows
    python3 tools/port_probe.py tt-grouped-shapes     # grouped wgmma contraction, CTA shapes

``device-times`` runs the decode attention, wkv and RG-LRU phases of
``chip_smoke.py`` from TREE (default: this checkout; another checkout, e.g.
an earlier commit unpacked with ``git archive``, gives a comparison on the
same card) and prints the kernel's, the plain version's and the library
call's device time a call.  ``griffin`` serves recurrentgemma-2b at full
width from TREE and profiles decode ticks and a prefill chunk: device
kernels a call, device time, wall time and the RG-LRU kernel's device time
a launch.  ``splits`` runs the paged decode phases with the
split length forced.  ``wkv-phases`` builds copies of ``csrc/wkv_scan.cu``
with one phase of the chunk loop switched off (their outputs are wrong by
design) into a temporary directory and times each at rwkv6-7b's prefill
shape, to show where a chunk's time goes.  ``rglru-variants`` likewise
builds ``csrc/rglru_scan.cu`` as committed, with one design choice undone
(torch's exact sigmoid and tanh in the gated entry; the pair's arithmetic,
which leaves wrong output) and with other CTA shapes, and times both entries
at griffin's prefill shape.  ``tt-svd`` times, in f64 on the card, the
factorization of every unfolding TT-SVD meets in ChatGLM3-6B's three TT
specs, by each route that retains the same subspace (``torch.linalg.svd``
as ``core.ttd`` calls it; on a wide unfolding, the SVD through the QR of its
transpose; the Gram route; cuSOLVER's drivers), and ``tt_svd`` of each whole
spec.  ``int4`` times, from TREE's wrapper, the int4 kernels' device time a
call at every served decode shape (B 1, 8 and 16; weights rotated past the
L2 as ``chip_smoke.py`` does), both bf16 routes at B 16-48 (where TREE's
wrapper can force one: ``GEMV_MAX_B``), and the f32 route at the routers'
shapes, beside the bytes bound and the library call (``torch.matmul`` on
the dequantized weights).  ``int4-variants`` builds ``csrc/int4_matmul.cu``
with one part of the GEMV changed or switched off (outputs wrong by design
where a part is off) and times each at the serve shapes, to show what
bounds it.  ``int4-plans`` times the GEMV as committed under other grids
(K slices x warps a CTA) than ``gemv_plan`` picks, and the f32 route under
other tiles and slices than ``f32_plan`` picks, at the serve shapes.
``int4-host`` times the host side of TREE's int4 wrapper: the mean wall
time a call over 400 calls issued without synchronizing, at decode shapes.
``tt-grouped`` runs TREE's grouped tt_linear (the MoE experts' route) at
every grouped shape of ``chip_smoke.py``'s MoE phases and at one token, and
prints the device time of the whole call, of each of its two launches (the
operator pass and the contraction), of ``torch._grouped_mm`` on the
reconstructed experts, and the route the contraction took; it also prints
what ``ptxas -v`` said of TREE's grouped kernels (registers, spills).
``tt-grouped-routes`` times this checkout's grouped call with each
contraction route forced (decode tiles, wgmma) at 1-256 rows an expert (up
to 4096 tokens), to place the threshold between them.  ``tt-grouped-shapes``
times the wgmma contraction at T 2048 under every (rows a warpgroup, ring
stages) whose shared memory fits, beside the one ``grouped_plan`` picks.
Every line carries the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: n/a"


def sm_clock() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "n/a"


def device_ms(fn, iters: int = 20) -> float:
    """Device time a call of ``fn(i)``: the profiler's kernel time over
    ``iters`` calls, after two warm-up calls; nan when the profiler recorded
    no kernel (it sometimes drops a window's events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_time_total > 0)
    return total / iters / 1e3 if total > 0 else float("nan")  # nan: no event recorded


def smoke(tree: Path):
    """``chip_smoke.Smoke`` of ``tree`` whose timings also record device time."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.lib()
    events = cs.Smoke.time_ms

    def time_ms(self, fn, iters=20):
        ms = events(self, fn, iters)
        self.devs.append(device_ms(fn, iters))
        return ms

    cs.Smoke.time_ms = time_ms
    s = cs.Smoke()
    s.devs = []
    return cs, s


def report(s, tag: str, what: str) -> None:
    d = s.devs + [float("nan")] * 3
    print(f"[{tag}] {card()}: {what}: device ms a call kernel {d[0]:.4f} plain {d[1]:.4f} "
          f"library {d[2]:.4f}", flush=True)
    s.devs = []


def device_times(tree: Path) -> None:
    _, s = smoke(tree)
    from repro_torch.kernels import paged_attention as pa
    tag = tree.name
    for hkv in (32, 2):
        for int8 in (False, True):
            s.attn_phase(True, hkv, int8)
            report(s, tag, f"paged decode H32/Hkv{hkv} {'int8' if int8 else 'bf16'}")
    if 256 in pa.HEAD_DIMS:
        for int8 in (False, True):
            s.attn_phase(True, 1, int8, h=10, dh=256)
            report(s, tag, f"paged decode H10/Hkv1/Dh256 {'int8' if int8 else 'bf16'}")
    if 112 in pa.HEAD_DIMS:  # kimi-k2-1t-a32b's heads; trees before it lack them
        for int8 in (False, True):
            s.attn_phase(True, 8, int8, h=64, dh=112)
            report(s, tag, f"paged decode H64/Hkv8/Dh112 {'int8' if int8 else 'bf16'}")
    for int8 in (False, True):
        s.ring_phase("recurrentgemma-2b", 1, 10, 1, 256, 2048, 2304, int8,
                     (3000, 2400, 1500, 256, 3900, 700, 0, 2304))
        report(s, tag, f"ring decode {'int8' if int8 else 'bf16'}")
    for steps in (1, 256):
        for int8 in (False, True):
            s.wkv_phase(steps, int8)
            report(s, tag, f"wkv S={steps} {'int8' if int8 else 'f32'} state")
    for steps in (1, 256):
        s.rglru_phase(steps)
        report(s, tag, f"rglru_scan S={steps} f32 in, bf16 h")
        if hasattr(s, "rglru_gated_phase"):  # trees before the fused entry lack it
            s.rglru_gated_phase(steps)
            report(s, tag, f"rglru_scan gated S={steps} bf16 in, bf16 y")
    print(f"[{tag}] failures: {s.failures}", flush=True)


def griffin(tree: Path, steps: int = 5) -> None:
    """recurrentgemma-2b at full width from ``tree``, 8 slots at ~1 K context
    (``chip_smoke``'s profile geometry): ``steps`` decode ticks and one
    256-token prefill chunk, each profiled twice."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    cs, s = smoke(tree)
    from repro_torch.configs import get_config
    from repro_torch.models import griffin as gm
    from repro_torch.serve.steps import serve_config_of
    cfg = serve_config_of(get_config("recurrentgemma-2b"))
    params = gm.init_lm(cfg, seed=cs.SEED, device="cuda")
    sess, state = s.session(cfg, 4096)
    dev = torch.device("cuda")
    toks = torch.randint(0, cfg.vocab_size, (8, 256), device=dev, dtype=torch.int32,
                         generator=s.gen)
    pos = torch.arange(256, device=dev, dtype=torch.int32)[None].repeat(8, 1)
    cols = torch.full((8,), 255, device=dev)
    for c in range(4):
        _, state = sess.prefill_chunk(params, state, toks, pos + 256 * c, logit_cols=cols)
    dtok = toks[:, :1].contiguous()
    at = 1024

    def decode():
        nonlocal state, at
        for _ in range(steps):
            _, state = sess.decode_step(params, state, dtok, torch.full(
                (8,), at, device=dev, dtype=torch.int32))
            at += 1

    def chunk():
        nonlocal state, at
        _, state = sess.prefill_chunk(params, state, toks, pos + at, logit_cols=cols)
        at += 256

    decode()
    torch.cuda.synchronize()
    for rep in range(2):
        for what, run, n in (("decode tick", decode, steps), ("prefill chunk", chunk, 1)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            clock = sm_clock()
            events = [e for e in prof.key_averages() if e.device_time_total > 0]
            kern = [e for e in events if not e.key.startswith(("Memcpy", "Memset"))]
            dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
            rg = [e for e in kern if "rglru_" in e.key]
            rg_text = "; ".join(f"{e.key[:40]} {e.self_device_time_total / e.count / 1e3:.4f} ms"
                                f" ({e.count / n:.0f} a call)" for e in rg)
            print(f"[{tree.name} griffin] {card()}: {what} (pass {rep + 1}): device kernels "
                  f"{sum(e.count for e in kern) / n:.1f} a call, device {dev_ms:.3f} ms, wall "
                  f"{wall / n * 1e3:.3f} ms; RG-LRU device time a launch: {rg_text}; SM clock, "
                  f"power just after: {clock}", flush=True)


def splits(lengths: list[int]) -> None:
    cs, _ = smoke(ROOT)
    from repro_torch.kernels import paged_attention as pa
    plan = pa.decode_plan
    for kps in lengths:
        pa.decode_plan = lambda n, kps=kps: (-(-n // kps), kps)
        s = cs.Smoke()  # the same seed: the same contexts for every length
        s.devs = []
        for hkv, h, dh in ((32, 32, 128), (2, 32, 128), (1, 10, 256)):
            for int8 in (False, True):
                s.attn_phase(True, hkv, int8, h=h, dh=dh)
                report(s, f"{kps} entries a split",
                       f"paged decode H{h}/Hkv{hkv}/Dh{dh} {'int8' if int8 else 'bf16'}")
        print(f"[{kps} entries a split] failures: {s.failures}", flush=True)
    pa.decode_plan = plan


# the chunk loop's phases, each switched off by turning its guard false
WKV_PHASES = {
    "all phases": [],
    "no (a) log decays": [("if (tid < HD) {\n      float la = 0.f;",
                           "if (false) {\n      float la = 0.f;")],
    "no (b) r~ k~ k_end": [("    {\n      const int i = tid % HD",
                            "    if (false) {\n      const int i = tid % HD")],
    "no (c) A and bonus": [("if (warp < 2) {\n      float acc[2][4] = {};",
                            "if (false) {\n      float acc[2][4] = {};"),
                           ("    } else {\n#pragma unroll\n      for (int q = 0;",
                            "    } else if (false) {\n#pragma unroll\n      for (int q = 0;")],
    "no (d) y and state": [("    if (owner) {\n      saw_real |= sm.any_real != 0;",
                            "    if (false) {\n      saw_real |= sm.any_real != 0;")],
}


def wkv_phases() -> None:
    import torch
    libs = build_variants("wkv_scan.cu", WKV_PHASES)
    from repro_torch.kernels import _build
    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, hd = 8, 256, 64, 64
    r, k, v = (torch.randn(b, s, h, hd, generator=g, device="cuda").bfloat16() for _ in range(3))
    w = 0.5 + 0.499 * torch.rand(b, s, h, hd, generator=g, device="cuda")
    u = 0.5 * torch.randn(h, hd, generator=g, device="cuda")
    s0 = torch.randn(b, h, hd, hd, generator=g, device="cuda")
    y, s1 = torch.empty(b, s, h, hd, device="cuda"), torch.empty_like(s0)
    for rep in range(2):
        for name, lib in libs.items():
            fn = lib.rt_wkv_scan
            fn.argtypes = _build.SIGNATURES["rt_wkv_scan"]

            def call(i, fn=fn):
                err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                         None, s0.data_ptr(), None, y.data_ptr(), s1.data_ptr(), None, b, s, h,
                         hd, 1, 0, _build.stream(r))
                _build.check(err, "wkv_scan")

            print(f"[wkv-phases] {card()}: prefill B={b} S={s} H={h} hd={hd}, bf16 r/k/v, f32 "
                  f"state, {name}: device ms a call {device_ms(call):.4f} (pass {rep + 1})",
                  flush=True)


# design choices of csrc/rglru_scan.cu, each undone by a text patch
RGLRU_VARIANTS = {
    "as committed": [],
    "exact sigmoid and tanh": [
        ("return __fdividef(1.0f, 1.0f + __expf(-x));", "return 1.0f / (1.0f + expf(-x));"),
        ("return __fdividef(x, 1.0f + __expf(-2.0f * z));",
         "return 0.5f * x * (1.0f + tanhf(z));")],
    "unit-major grid": [("const int p = blockIdx.x / units, unit = blockIdx.x % units;",
                         "const int p = blockIdx.x % np, unit = blockIdx.x / np;")],
    # wrong output by design: the pair's arithmetic taken out, the bytes kept
    "no exp or sqrt in the pair": [("  a = expf(la);\n  b = __fmul_rn(sqrtf(fmaxf(1.0f - expf(2.0f "
                                    "* la), 1e-12f)), gx);", "  a = la;\n  b = gx;")],
}
# CTA shapes: channels a CTA x sub-chunks a panel
for _cw, _sub, _nsub in ((64, 16, 4), (128, 16, 1), (256, 16, 1), (32, 8, 8), (32, 8, 4),
                         (32, 4, 16)):
    RGLRU_VARIANTS[f"{_cw} channels x {_nsub} sub-chunks of {_sub} steps a CTA"] = [
        ("constexpr int CW = 32;", f"constexpr int CW = {_cw};"),
        ("constexpr int SUB = 16;", f"constexpr int SUB = {_sub};"),
        ("constexpr int NSUB = 4;", f"constexpr int NSUB = {_nsub};")]


def build_variants(source: str, variants: dict) -> dict:
    """``{name: ctypes library}`` of ``csrc/<source>`` with each variant's
    patches applied, built by parallel nvcc calls into a temporary directory."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    src = (csrc / source).read_text()
    tmp = Path(tempfile.mkdtemp(prefix="variants-"))
    libs, procs = {}, []
    for i, (name, patches) in enumerate(variants.items()):
        d = tmp / str(i)
        d.mkdir()
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"variant '{name}': '{old}' is not in {source}")
            text = text.replace(old, new)
        (d / source).write_text(text)
        (d / "common.cuh").write_text((csrc / "common.cuh").read_text())
        libs[name] = d / "lib.so"
        procs.append(subprocess.Popen([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                                       "-Xcompiler", "-fPIC", "-shared", "-o", str(libs[name]),
                                       str(d / source)]))
    if any([p.wait() for p in procs]):  # wait for every build before judging
        raise SystemExit(f"variants of {source}: nvcc failed")
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def rglru_variants() -> None:
    import torch
    libs = build_variants("rglru_scan.cu", RGLRU_VARIANTS)
    from repro_torch.kernels import _build
    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, w = 8, 256, 2560
    bf16 = torch.bfloat16
    la = -8.0 * torch.rand(b, s, w, generator=g, device="cuda") * 0.5
    gx = torch.randn(b, s, w, generator=g, device="cuda")
    ga, gxp, u, gg = (torch.randn(b, s, w, generator=g, device="cuda").to(bf16)
                      for _ in range(4))
    lam = (0.7 + torch.randn(w, generator=g, device="cuda")).to(bf16)
    h0 = torch.randn(b, w, generator=g, device="cuda")
    pos = torch.arange(s, device="cuda", dtype=torch.int32)[None].repeat(b, 1)
    h, y = torch.empty(b, s, w, device="cuda", dtype=bf16), torch.empty_like(ga)
    h_last = torch.empty_like(h0)
    h0x, hlx = torch.randn(b * s // 8, w, device="cuda"), torch.empty(b * s // 8, w, device="cuda")
    st = _build.stream(h0)
    epoch = 0
    for rep in range(2):
        for name, lib in libs.items():
            scan, gated = lib.rt_rglru_scan, lib.rt_rglru_gated
            scan.argtypes = _build.SIGNATURES["rt_rglru_scan"]
            gated.argtypes = _build.SIGNATURES["rt_rglru_gated"]
            lib.rt_rglru_workspace_bytes.restype = ctypes.c_long
            nbytes = lib.rt_rglru_workspace_bytes(b, s, w)  # the variant's own panels
            ws = torch.zeros(max(nbytes, 1), dtype=torch.uint8, device="cuda")

            def carry(ws=ws, nbytes=nbytes):
                nonlocal epoch
                epoch += 1
                return ws.data_ptr(), nbytes, epoch

            def call_scan(i, fn=scan, carry=carry):
                _build.check(fn(la.data_ptr(), gx.data_ptr(), h0.data_ptr(), pos.data_ptr(),
                                h.data_ptr(), h_last.data_ptr(), *carry(), b, s, w, 1, st),
                             "rglru_scan")

            def call_gated(i, fn=gated, carry=carry):
                _build.check(fn(ga.data_ptr(), gxp.data_ptr(), u.data_ptr(), gg.data_ptr(),
                                lam.data_ptr(), h0.data_ptr(), pos.data_ptr(), y.data_ptr(),
                                h_last.data_ptr(), *carry(), b, s, w, 1, 1, st),
                             "rglru_scan (gated)")

            # the same bytes as slots of one panel each: no carry
            s1 = max(n for n in (8, 16, 32, 64, 128, 256)
                     if lib.rt_rglru_workspace_bytes(b * s // n, n, w) == 0)

            def call_one(i, fn=scan, s1=s1):
                _build.check(fn(la.data_ptr(), gx.data_ptr(), h0x.data_ptr(), None, h.data_ptr(),
                                hlx.data_ptr(), None, 0, 0, b * s // s1, s1, w, 1, st),
                             "rglru_scan")

            print(f"[rglru-variants] {card()}: prefill B={b} S={s} W={w}, {name}: device ms a "
                  f"call, f32 in and bf16 h {device_ms(call_scan):.4f}, gated bf16 "
                  f"{device_ms(call_gated):.4f}; f32 in as {b * s // s1} x {s1} steps (no "
                  f"carry) {device_ms(call_one):.4f} (pass {rep + 1})", flush=True)
    # yardsticks of the card's rate: the gated entry without a carry, two PyTorch kernels
    lib = libs["as committed"]
    lib.rt_rglru_gated.argtypes = _build.SIGNATURES["rt_rglru_gated"]
    ga4, gxp4, u4, gg4, y4 = (t.view(32, 64, w) for t in (ga, gxp, u, gg, y))
    one_gated = device_ms(lambda i: _build.check(lib.rt_rglru_gated(
        ga4.data_ptr(), gxp4.data_ptr(), u4.data_ptr(), gg4.data_ptr(), lam.data_ptr(),
        h0x.data_ptr(), None, y4.data_ptr(), hlx.data_ptr(), None, 0, 0, 32, 64, w, 1, 1, st),
        "rglru_scan (gated)"))
    o32 = torch.empty_like(la)
    mul = device_ms(lambda i: torch.mul(la, gx, out=o32))
    cast = device_ms(lambda i: h.copy_(la))
    n = la.numel()
    print(f"[rglru-variants] {card()}: as committed, gated bf16 as 32 x 64 steps (no carry, "
          f"{n * 10e-6:.1f} MB) {one_gated:.4f} ms; torch.mul f32 ({n * 12e-6:.1f} MB) "
          f"{mul:.4f} ms; f32 -> bf16 copy_ ({n * 6e-6:.1f} MB) {cast:.4f} ms", flush=True)


def tt_svd_routes() -> None:
    import time

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import ttd
    from repro_torch.models.transformer import make_block_specs
    dev = torch.device("cuda")
    tag = card()

    def secs(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    specs = make_block_specs(get_config("chatglm3-6b"), True)
    g = torch.Generator(device=dev).manual_seed(0)
    for role, sp in (("attn_o", specs.attn_d()["wo"]), ("gate", specs.mlp_d()["gate"]),
                     ("down", specs.mlp_d()["down"])):
        spec = sp.tt
        mats = [torch.randn(shp, generator=g, device=dev, dtype=torch.float64)
                for shp in spec.core_matrix_shapes()]
        w = ttd.tt_reconstruct(ttd.matrices_to_cores(mats, spec), spec)
        c = ttd.tensorize_weight(w, spec).reshape(spec.mode_sizes[0], -1)
        for k in range(spec.d - 1):
            rows, cols = c.shape
            def qr_route(c=c):  # a wide c: the SVD of R^T from the QR of c^T
                q, tri = torch.linalg.qr(c.T)
                u, s, vt = torch.linalg.svd(tri.T)
                return u, s, vt @ q.T

            routes = {"torch.linalg.svd (core.ttd)":
                      lambda c=c: torch.linalg.svd(c, full_matrices=False),
                      "gram (eigh of c c^T)": lambda c=c: torch.linalg.eigh(c @ c.T)}
            if rows < cols:
                routes["QR of c^T, then SVD of R^T"] = qr_route
            for drv in ("gesvd", "gesvdj", "gesvda"):
                routes[f"svd driver={drv}"] = lambda c=c, drv=drv: torch.linalg.svd(
                    c if rows >= cols else c.T, full_matrices=False, driver=drv)
            auto = "gram" if cols > 4 * rows and rows > 64 else "svd"
            for name, fn in routes.items():
                try:
                    t = f"{secs(fn) * 1e3:.1f} ms"
                except RuntimeError as e:  # a driver that refuses the shape
                    t = f"refused ({str(e).splitlines()[0][:60]})"
                print(f"[tt-svd] {tag}: {role} unfolding {k} ({rows} x {cols} f64, auto takes "
                      f"{auto}): {name} {t}", flush=True)
            u, rest = ttd._truncated_left_factor(c, spec.ranks[k + 1], "auto")
            c = rest.reshape(u.shape[1] * spec.mode_sizes[k + 1], -1)
        for method in ("auto", "svd", "gram"):
            t = secs(lambda: ttd.tt_svd(w, spec, method=method), reps=2)
            print(f"[tt-svd] {tag}: {role} tt_svd(method={method!r}) whole spec "
                  f"{t * 1e3:.1f} ms", flush=True)


# (K, M) of the int4 linears the served paths run at decode: llama2-7b /
# rwkv6-7b, chatglm3-6b, recurrentgemma-2b, mixtral-8x22b, kimi-k2-1t-a32b
INT4_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 256), (4096, 13696),
               (13696, 4096), (2560, 2560), (2560, 256), (6144, 6144), (6144, 1024),
               (7168, 7168), (7168, 896)]


def int4(tree: Path) -> None:
    import math

    import torch
    sys.path[:0] = [str(tree / "src")]
    from repro_torch.core.quant import dequantize_int4, quantize_int4
    from repro_torch.kernels import _build
    from repro_torch.kernels import int4_matmul as k
    _build.lib()
    g = torch.Generator(device="cuda").manual_seed(0)
    tag = f"{tree.name} int4"

    def weights(kk, m, rotate=True):
        copies = max(1, math.ceil(128e6 / (m * kk // 2))) if rotate else 1
        return [quantize_int4(torch.randn(m, kk, generator=g, device="cuda") / math.sqrt(kk), 128)
                for _ in range(copies)]

    def bf16_line(kk, m, b, route=None):
        ws = weights(kk, m)
        x = torch.randn(b, kk, generator=g, device="cuda").to(torch.bfloat16)
        epi = dict(residual=torch.randn(b, m, generator=g, device="cuda").to(torch.bfloat16)) \
            if m < kk else (dict(activation="silu") if m > kk else {})
        default = getattr(k, "GEMV_MAX_B", None)
        if route is not None:
            k.GEMV_MAX_B = 8 * k.GEMV_MAX_NT if route == "gemv" else 0
        try:
            dev = device_ms(lambda i: k.int4_matmul(x, ws[i % len(ws)]["qweight"],
                                                    ws[i % len(ws)]["scales"], 128, **epi))
        finally:
            if default is not None:
                k.GEMV_MAX_B = default
        dq = [dequantize_int4(w).T.contiguous() for w in ws[:max(1, math.ceil(len(ws) / 4))]]
        lib = device_ms(lambda i: torch.matmul(x, dq[i % len(dq)]))
        nbytes = 2 * b * kk + m * kk // 2 + 2 * m * (kk // 128) + 2 * b * m \
            + (2 * b * m if m < kk else 0)
        bound = nbytes / 3.35e12 * 1e3
        print(f"[{tag}] {card()}: bf16 {kk}->{m} B={b}{f' route {route}' if route else ''}: "
              f"device ms a call {dev:.4f}, bytes bound {bound:.4f} ({bound / dev:.0%}), "
              f"library {lib:.4f}", flush=True)

    for kk, m in INT4_SHAPES:
        for b in (1, 8, 16):
            bf16_line(kk, m, b)
    for kk, m in ((4096, 4096), (4096, 11008)):
        for b in (16, 17, 24, 32, 48):
            for route in (("gemv", "gemm") if hasattr(k, "GEMV_MAX_B") else (None,)):
                bf16_line(kk, m, b, route)
    for kk, m in ((6144, 8), (7168, 384)):
        q = weights(kk, m, rotate=False)[0]
        wt = dequantize_int4(q, torch.float32).T.contiguous()
        for b in (8, 2048):
            x = torch.randn(b, kk, generator=g, device="cuda")
            dev = device_ms(lambda i: k.int4_matmul(x, q["qweight"], q["scales"], 128))
            lib = device_ms(lambda i: torch.matmul(x, wt))
            nbytes = 4 * b * kk + m * kk // 2 + 2 * m * (kk // 128) + 4 * b * m
            ops = 2.0 * b * kk * m
            f32_bound = max(nbytes / 3.35e12, ops / 67e12) * 1e3
            tf32_bound = max(nbytes / 3.35e12, 2 * ops / 495e12) * 1e3
            print(f"[{tag}] {card()}: f32 router {kk}->{m} B={b}: device ms a call {dev:.4f}, "
                  f"f32 FMA bound {f32_bound:.4f}, two-TF32-pass bound {tf32_bound:.4f}, "
                  f"library {lib:.4f}", flush=True)


# chip_smoke's grouped MoE shapes (arch, role, [(tokens, routing)]) plus one token
TT_GROUPED_CASES = (
    ("mixtral-8x22b", "gate", ((1, "router"), (8, "router"), (2048, "router"),
                               (2048, "one expert"), (2048, "most empty"))),
    ("mixtral-8x22b", "down", ((1, "router"), (8, "router"), (2048, "router"))),
    ("kimi-k2-1t-a32b", "gate", ((1, "router"), (8, "router"), (2048, "router"),
                                 (2048, "most empty"))),
    ("kimi-k2-1t-a32b", "down", ((1, "router"), (8, "router"), (2048, "router"))),
)


def launch_device_ms(fn, iters: int = 20) -> dict:
    """{kernel name: device ms a call} of ``fn(i)`` from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
            if e.device_time_total > 0}


def _grouped_inputs(s, arch, role, cases):
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.modules import linear_spec
    from repro_torch.models.moe import sort_by_expert
    from repro_torch.serve.steps import serve_config_of
    cfg = serve_config_of(get_config(arch))
    n_in, n_out = (cfg.d_model, cfg.d_ff_expert) if role == "gate" else \
        (cfg.d_ff_expert, cfg.d_model)
    spec = linear_spec(cfg, f"expert_{role}", n_in, n_out).tt
    e, k = cfg.n_experts, cfg.experts_per_token
    cores = [s.randn(e, *shp, dtype=torch.bfloat16, scale=1 / math.sqrt(shp[0]))
             for shp in spec.core_matrix_shapes()]
    out = []
    for t, how in cases:
        _, offsets = sort_by_expert(s._expert_ids(t, e, k, how), e)
        out.append((t, how, offsets, s.randn(t * k, spec.n_in, dtype=torch.bfloat16)))
    return spec, e, k, cores, out


def tt_grouped(tree: Path) -> None:
    import torch
    cs, s = smoke(tree)
    from repro_torch.kernels import _build
    from repro_torch.kernels import tt_linear as kt
    tag = f"{tree.name} tt-grouped"
    log = _build.BUILD_ROOT / _build.source_hash() / "libreprotorch.log"
    if log.exists():  # ptxas -v of the grouped kernels: registers, spills, shared memory
        lines = log.read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(
                    n in line for n in ("tt_operators", "tt_ops_mma", "tt_wgmma")):
                info = [ln.strip() for ln in lines[i + 1:i + 4]
                        if "Compiling" not in ln]
                print(f"[{tag}] ptxas {line.split('entry function')[1].strip()[:70]}: "
                      + " | ".join(info), flush=True)
    gm = getattr(torch, "_grouped_mm", None)
    for arch, role, cases in TT_GROUPED_CASES:
        spec, e, k, cores, inputs = _grouped_inputs(s, arch, role, cases)
        w = s.dense_experts(cores, spec)
        act = "silu" if role == "gate" else None
        for t, how, offsets, x in inputs:
            def run(i):
                return kt.tt_linear_grouped(x, offsets, cores, spec, activation=act)

            want = kt.tt_linear_grouped_ref(x, offsets, cores, spec, activation=act)
            err = (run(0).float() - want.float()).abs().max().item()
            per = launch_device_ms(run)
            ops = sum(v for n, v in per.items() if "tt_op" in n)
            con = sum(v for n, v in per.items() if "tt_fused" in n or "tt_wgmma" in n)
            lib = float("nan")
            if gm is not None:
                offs = offsets[1:].contiguous()
                lib = device_ms(lambda i: gm(x, w.transpose(1, 2), offs=offs))
            plan = kt.grouped_plan(spec, t * k, e) if hasattr(kt, "grouped_plan") else None
            route = plan.route if plan is not None else "decode tiles"
            counts = (offsets[1:] - offsets[:-1]).tolist()
            print(f"[{tag}] {card()}: {arch} {role} E={e} top-{k} T={t} ({t * k} rows, {how}: "
                  f"{sum(c > 0 for c in counts)} experts with rows): device ms a call "
                  f"{ops + con:.4f} = operator pass {ops:.4f} + contraction {con:.4f} "
                  f"({route}); torch._grouped_mm {lib:.4f}; max abs err vs plain {err:.3g}; "
                  + "; ".join(f"{n[:60]} {v:.4f}" for n, v in per.items()), flush=True)
        del w
        torch.cuda.empty_cache()
    print(f"[{tag}] failures: {s.failures}; SM clock, power: {sm_clock()}", flush=True)


def tt_grouped_routes() -> None:
    import torch
    _, s = smoke(ROOT)
    from repro_torch.kernels import tt_linear as kt
    default = kt.GROUPED_WGMMA_MIN_ROWS
    for arch, role, _ in TT_GROUPED_CASES:
        cfg_e = {"mixtral-8x22b": 8, "kimi-k2-1t-a32b": 384}[arch]
        k = {"mixtral-8x22b": 2, "kimi-k2-1t-a32b": 8}[arch]
        ts = sorted({max(1, n * cfg_e // k) for n in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                     if n * cfg_e // k <= 4096})
        spec, e, k, cores, inputs = _grouped_inputs(s, arch, role, [(t, "router") for t in ts])
        act = "silu" if role == "gate" else None
        for t, _, offsets, x in inputs:
            line = []
            for route, rows in (("decode tiles", 1 << 30), ("wgmma", 0)):
                kt.GROUPED_WGMMA_MIN_ROWS = rows
                try:
                    if kt.grouped_plan(spec, t * k, e).route != route:
                        continue
                    ms = device_ms(lambda i: kt.tt_linear_grouped(x, offsets, cores, spec,
                                                                  activation=act))
                finally:
                    kt.GROUPED_WGMMA_MIN_ROWS = default
                line.append(f"{route} {ms:.4f}")
            print(f"[tt-grouped-routes] {card()}: {arch} {role} T={t} ({t * k} rows, "
                  f"{t * k / e:.1f} an expert): device ms a call " + ", ".join(line), flush=True)


def tt_grouped_shapes() -> None:
    _, s = smoke(ROOT)
    from repro_torch.kernels import tt_linear as kt
    pick = kt._wgmma_shape
    for arch, role, _ in TT_GROUPED_CASES:
        spec, e, k, cores, inputs = _grouped_inputs(s, arch, role, [(2048, "router")])
        _, _, offsets, x = inputs[0]
        act = "silu" if role == "gate" else None
        planned = pick(spec)
        p = kt._split(spec, kt.contraction_plan(spec).h, True)
        ns, kp, bms = kt._pad16(p.nr), -(-kt._pad16(p.nl) // 64), planned[1]
        for iw in (2, 4):
            for stages in (2, 3, 4):
                x_bytes, epi = kp * ns * 128, 64 * (bms + 4) * 4
                end = 2 * iw * x_bytes + stages * (kp * 8192 + -(-ns // 64) * bms * 128)
                smem = 1024 + end + (2 * epi if iw * x_bytes < epi else 0) + 2 * stages * 8
                if smem > kt.SMEM_MAX:
                    continue
                kt._wgmma_shape = lambda sp, shape=(iw, bms, stages, smem): shape
                kt._grouped_plan.cache_clear()
                try:
                    per = launch_device_ms(lambda i: kt.tt_linear_grouped(
                        x, offsets, cores, spec, activation=act))
                finally:
                    kt._wgmma_shape = pick
                    kt._grouped_plan.cache_clear()
                ms = sum(v for n, v in per.items() if "tt_wgmma" in n)
                mark = " <- grouped_plan" if (iw, stages) == (planned[0], planned[2]) else ""
                print(f"[tt-grouped-shapes] {card()}: {arch} {role} T=2048: {iw} rows a "
                      f"warpgroup, {stages} stages, {smem} bytes: contraction device ms a call "
                      f"{ms:.4f}{mark}", flush=True)


# parts of csrc/int4_matmul.cu's GEMV, each changed or switched off by a text patch
INT4_VARIANTS = {
    "as committed": [],
    "no mma (the stream, x staging and reduce only)": [
        ("      mma_bf16(part[0][n], ae, be);\n      mma_bf16(part[1][n], ao, bo);", "")],
    "no weight loads (compute on made-up words; wrong sums)": [
        ("        buf[d][0] = ld_stream(w0 + 64 * d + 16 * tig);\n"
         "        buf[d][1] = ld_stream(w1 + 64 * d + 16 * tig);",
         "        buf[d][0] = make_uint4(lane, d, 7 * lane, 3);\n"
         "        buf[d][1] = make_uint4(d, lane, 5, 9 * lane);"),
        ("          buf[d][0] = ld_stream(w0 + 64 * (b + GV_DEPTH) + 16 * tig);\n"
         "          buf[d][1] = ld_stream(w1 + 64 * (b + GV_DEPTH) + 16 * tig);",
         "          buf[d][0].x += b;\n          buf[d][1].y ^= b;")],
    "half the mma (the odd steps' products dropped; wrong sums)": [
        ("      mma_bf16(part[0][n], ae, be);\n      mma_bf16(part[1][n], ao, bo);",
         "      mma_bf16(part[0][n], ae, be);\n      if (bo[0] == 0x12345u) mma_bf16(part[1][n], ao, bo);")],
    "no nibble conversion (raw words as fragments; wrong sums)": [
        ("    const uint32_t ae[4] = {halves_to_bf16(u0), halves_to_bf16(u1), halves_to_bf16(u0 >> 4),\n"
         "                            halves_to_bf16(u1 >> 4)};\n"
         "    const uint32_t ao[4] = {halves_to_bf16(u0 >> 8), halves_to_bf16(u1 >> 8),\n"
         "                            halves_to_bf16(u0 >> 12), halves_to_bf16(u1 >> 12)};",
         "    const uint32_t ae[4] = {u0, u1, u0 >> 4, u1 >> 4};\n"
         "    const uint32_t ao[4] = {u0 >> 8, u1 >> 8, u0 >> 12, u1 >> 12};")],
    "k16 steps of contiguous k (the path for groups under 128)": [
        ("  if (WHOLE) {\n    // block b:", "  if (false) {\n    // block b:")],
    "each slice stores its partials itself (no cluster reduce; wrong sums)": [
        ("      red.push(acc[n][e], 8 * n + 2 * tig + (e & 1), warp * 16 + gid + (e >= 2 ? 8 : 0));\n"
         "  red.finish();",
         "      if (8 * n + 2 * tig + (e & 1) < a.B && rb + gid + (e >= 2 ? 8 : 0) < a.M)\n"
         "        a.out[(long)(8 * n + 2 * tig + (e & 1)) * a.M + rb + gid + (e >= 2 ? 8 : 0)] =\n"
         "            __float2bfloat16(acc[n][e]);")],
    "the reduce without its remote stores (wrong sums)": [
        ("    *dst = v;", "    if (v == 12345.f) *dst = v;")],
    "x left in its own order (no permute pass; wrong sums)": [
        ("    *q = p;\n  }\n  __syncthreads();",
         "    if (p.x == 0x12345u) *q = p;\n  }\n  __syncthreads();")],
    "4 blocks in flight a warp": [("constexpr int GV_DEPTH = 2;", "constexpr int GV_DEPTH = 4;")],
    "8 blocks in flight a warp": [("constexpr int GV_DEPTH = 2;", "constexpr int GV_DEPTH = 8;")],
}


def int4_variants() -> None:
    import math

    import torch
    libs = build_variants("int4_matmul.cu", INT4_VARIANTS)
    from repro_torch.core.quant import quantize_int4
    from repro_torch.kernels import _build
    from repro_torch.kernels import int4_matmul as k
    g = torch.Generator(device="cuda").manual_seed(0)
    for kk, m in ((4096, 4096), (4096, 11008), (11008, 4096), (2560, 256)):
        copies = max(1, math.ceil(128e6 / (m * kk // 2)))
        ws = [quantize_int4(torch.randn(m, kk, generator=g, device="cuda") / math.sqrt(kk), 128)
              for _ in range(copies)]
        b = 8
        x = torch.randn(b, kk, generator=g, device="cuda").to(torch.bfloat16)
        out = torch.empty(b, m, device="cuda", dtype=torch.bfloat16)
        plan = k.gemv_plan(b, kk, m, 128)
        for name, lib in libs.items():
            fn = lib.rt_int4_matmul
            fn.argtypes = _build.SIGNATURES["rt_int4_matmul"]

            def call(i, fn=fn):
                w = ws[i % copies]
                _build.check(fn(x.data_ptr(), w["qweight"].data_ptr(), w["scales"].data_ptr(),
                                None, None, None, out.data_ptr(), b, kk, m, 128, 0, plan.warps,
                                plan.split.splits, plan.split.per_k, plan.split.ngs,
                                _build.stream(x)), "int4_matmul")

            print(f"[int4-variants] {card()}: {kk}->{m} B={b} ({plan.ctas} CTAs of "
                  f"{plan.warps} warps, {plan.split.splits} slices of {plan.split.per_k}), "
                  f"{name}: device ms a call {device_ms(call):.4f}", flush=True)


def int4_plans() -> None:
    import math

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.quant import quantize_int4
    from repro_torch.kernels import _build
    from repro_torch.kernels import int4_matmul as k
    lib = _build.lib()
    g = torch.Generator(device="cuda").manual_seed(0)
    for kk, m, b in ((4096, 4096, 8), (4096, 11008, 8), (11008, 4096, 8), (2560, 2560, 8),
                     (2560, 256, 8), (4096, 4096, 1), (4096, 4096, 16), (11008, 4096, 16)):
        copies = max(1, math.ceil(128e6 / (m * kk // 2)))
        ws = [quantize_int4(torch.randn(m, kk, generator=g, device="cuda") / math.sqrt(kk), 128)
              for _ in range(copies)]
        x = torch.randn(b, kk, generator=g, device="cuda").to(torch.bfloat16)
        out = torch.empty(b, m, device="cuda", dtype=torch.bfloat16)
        pick = k.gemv_plan(b, kk, m, 128)
        units = kk // 128
        cap = k.GEMV_X_BYTES // (2 * 8 * -(-b // 8)) // 128
        pers = sorted({max(1, min(cap, -(-units // s))) for s in (1, 2, 3, 4, 6, 8, 11, 16)
                       if -(-units // max(1, min(cap, -(-units // s)))) <= k.MAX_SPLITS})
        results = []
        for per in pers:
            sp = k._split(kk, 128, 128, per)
            for warps in (8, 4, 2, 1):
                rt = -(-(-(-m // 16)) // warps)

                def call(i, warps=warps, sp=sp):
                    w = ws[i % copies]
                    _build.check(lib.rt_int4_matmul(
                        x.data_ptr(), w["qweight"].data_ptr(), w["scales"].data_ptr(), None,
                        None, None, out.data_ptr(), b, kk, m, 128, 0, warps, sp.splits, sp.per_k,
                        sp.ngs, _build.stream(x)), "int4_matmul")

                results.append((device_ms(call), warps, sp.splits, sp.per_k, rt * sp.splits))
        for ms, warps, splits, per_k, ctas in sorted(results):
            mark = " <- gemv_plan" if (warps, splits, per_k) == (pick.warps, pick.split.splits,
                                                                 pick.split.per_k) else ""
            print(f"[int4-plans] {card()}: {kk}->{m} B={b}: {splits} slices of {per_k} x {warps} "
                  f"warps ({ctas} CTAs): device ms a call {ms:.4f}{mark}", flush=True)
    for kk, m, b in ((7168, 384, 2048), (6144, 8, 2048), (7168, 384, 8), (6144, 8, 8)):
        q = quantize_int4(torch.randn(m, kk, generator=g, device="cuda") / math.sqrt(kk), 128)
        x = torch.randn(b, kk, generator=g, device="cuda")
        out = torch.empty(b, m, device="cuda")
        pick = k.f32_plan(b, kk, m, 128)
        tiles = [(pick.fm, pick.fn, pick.wm)] + ([(2, 8, 4), (1, 2, 1), (1, 2, 2)]
                                                 if b > 16 else [(1, 1, 4)])
        results = []
        for fm, fn, wm in dict.fromkeys(tiles):
            tm, tn = 16 * fm * wm, 8 * fn * (8 // wm)
            for splits in (1, 2, 3, 4, 6, 8, 12, 16):
                per = -(-(kk // 128) // splits)
                sp = k._split(kk, 128, 128, per)
                if sp.splits > k.MAX_SPLITS or tm * sp.ngs * 2 > k.F32_SC_BYTES:
                    continue

                def call(i, fm=fm, fn=fn, wm=wm, sp=sp):
                    _build.check(lib.rt_int4_matmul_f32(
                        x.data_ptr(), q["qweight"].data_ptr(), q["scales"].data_ptr(), None,
                        None, None, out.data_ptr(), b, kk, m, 128, 0, fm, fn, wm, sp.splits,
                        sp.per_k, sp.ngs, _build.stream(x)), "int4_matmul (f32)")

                ctas = -(-m // tm) * -(-b // tn) * sp.splits
                results.append((device_ms(call), fm, fn, wm, sp.splits, sp.per_k, ctas))
        for ms, fm, fn, wm, splits, per_k, ctas in sorted(results):
            mark = " <- f32_plan" if (fm, fn, wm, splits) == (pick.fm, pick.fn, pick.wm,
                                                              pick.split.splits) else ""
            print(f"[int4-plans] {card()}: f32 {kk}->{m} B={b}: tile {16 * fm * wm} rows x "
                  f"{8 * fn * (8 // wm)} tokens (fm {fm}, fn {fn}, wm {wm}), {splits} slices of "
                  f"{per_k} ({ctas} CTAs): device ms a call {ms:.4f}{mark}", flush=True)


def int4_host(tree: Path) -> None:
    import math
    import time

    import torch
    sys.path[:0] = [str(tree / "src")]
    from repro_torch.core.quant import quantize_int4
    from repro_torch.kernels import _build
    from repro_torch.kernels import int4_matmul as k
    _build.lib()
    g = torch.Generator(device="cuda").manual_seed(0)
    for kk, m, b, dt in ((4096, 4096, 8, torch.bfloat16), (4096, 256, 8, torch.bfloat16),
                         (6144, 8, 8, torch.float32), (7168, 384, 8, torch.float32),
                         (4096, 4096, 64, torch.bfloat16)):
        q = quantize_int4(torch.randn(m, kk, generator=g, device="cuda") / math.sqrt(kk), 128)
        x = torch.randn(b, kk, generator=g, device="cuda").to(dt)
        for _ in range(20):
            k.int4_matmul(x, q["qweight"], q["scales"], 128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(400):
            k.int4_matmul(x, q["qweight"], q["scales"], 128)
        host = (time.perf_counter() - t0) / 400 * 1e6
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(400):
            torch.add(x, x)
        add = (time.perf_counter() - t1) / 400 * 1e6
        torch.cuda.synchronize()
        print(f"[{tree.name} int4-host] {card()}: {kk}->{m} B={b} {str(dt)[6:]}: host us a call "
              f"{host:.1f} (torch.add on x: {add:.1f})", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("port_probe: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    what, args = (sys.argv[1], sys.argv[2:]) if len(sys.argv) > 1 else ("", [])
    if what == "device-times":
        device_times(Path(args[0]).resolve() if args else ROOT)
    elif what == "griffin":
        griffin(Path(args[0]).resolve() if args else ROOT)
    elif what == "splits":
        splits([int(a) for a in args] or [128, 256, 384, 512])
    elif what == "wkv-phases":
        wkv_phases()
    elif what == "rglru-variants":
        rglru_variants()
    elif what == "tt-svd":
        tt_svd_routes()
    elif what == "int4":
        int4(Path(args[0]).resolve() if args else ROOT)
    elif what == "int4-variants":
        int4_variants()
    elif what == "int4-plans":
        int4_plans()
    elif what == "int4-host":
        int4_host(Path(args[0]).resolve() if args else ROOT)
    elif what == "tt-grouped":
        tt_grouped(Path(args[0]).resolve() if args else ROOT)
    elif what == "tt-grouped-routes":
        tt_grouped_routes()
    elif what == "tt-grouped-shapes":
        tt_grouped_shapes()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
