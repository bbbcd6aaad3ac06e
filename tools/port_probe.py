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
spec.  Every line carries the card's name and power limit.
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
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
