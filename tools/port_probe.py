#!/usr/bin/env python3
"""Device-time probes of the port's decode attention and wkv kernels on one
NVIDIA H100, beside what ``chip_smoke.py`` measures.

``chip_smoke.py`` times a kernel by CUDA events over back-to-back calls;
under ~0.05 ms a call that figure carries the wrapper's host time.  These
probes read each call's device time from ``torch.profiler`` instead.  Run
from the repository root on a machine with the card:

    python3 tools/port_probe.py device-times [TREE]   # decode attention + wkv phases
    python3 tools/port_probe.py splits 128 256 384    # paged decode by entries a split
    python3 tools/port_probe.py wkv-phases            # wkv prefill, one phase switched off

``device-times`` runs the decode attention and wkv phases of
``chip_smoke.py`` from TREE (default: this checkout; another checkout, e.g.
an earlier commit unpacked with ``git archive``, gives a comparison on the
same card) and prints the kernel's, the plain version's and the library
call's device time a call.  ``splits`` runs the paged decode phases with the
split length forced.  ``wkv-phases`` builds copies of ``csrc/wkv_scan.cu``
with one phase of the chunk loop switched off (their outputs are wrong by
design) into a temporary directory and times each at rwkv6-7b's prefill
shape, to show where a chunk's time goes.  Every line carries the card's
name and power limit.
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
    for int8 in (False, True):
        s.ring_phase("recurrentgemma-2b", 1, 10, 1, 256, 2048, 2304, int8,
                     (3000, 2400, 1500, 256, 3900, 700, 0, 2304))
        report(s, tag, f"ring decode {'int8' if int8 else 'bf16'}")
    for steps in (1, 256):
        for int8 in (False, True):
            s.wkv_phase(steps, int8)
            report(s, tag, f"wkv S={steps} {'int8' if int8 else 'f32'} state")
    print(f"[{tag}] failures: {s.failures}", flush=True)


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
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    src = (csrc / "wkv_scan.cu").read_text()
    tmp = Path(tempfile.mkdtemp(prefix="wkv_phases-"))
    libs, procs = {}, []
    for i, (name, patches) in enumerate(WKV_PHASES.items()):
        d = tmp / str(i)
        d.mkdir()
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"wkv-phases: the guard of '{name}' is not in wkv_scan.cu")
            text = text.replace(old, new)
        (d / "wkv_scan.cu").write_text(text)
        (d / "common.cuh").write_text((csrc / "common.cuh").read_text())
        libs[name] = d / "lib.so"
        procs.append(subprocess.Popen([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                                       "-Xcompiler", "-fPIC", "-shared", "-o", str(libs[name]),
                                       str(d / "wkv_scan.cu")]))
    if any([p.wait() for p in procs]):  # wait for every build before judging
        raise SystemExit("wkv-phases: nvcc failed")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, hd = 8, 256, 64, 64
    r, k, v = (torch.randn(b, s, h, hd, generator=g, device="cuda").bfloat16() for _ in range(3))
    w = 0.5 + 0.499 * torch.rand(b, s, h, hd, generator=g, device="cuda")
    u = 0.5 * torch.randn(h, hd, generator=g, device="cuda")
    s0 = torch.randn(b, h, hd, hd, generator=g, device="cuda")
    y, s1 = torch.empty(b, s, h, hd, device="cuda"), torch.empty_like(s0)
    for rep in range(2):
        for name, path in libs.items():
            fn = ctypes.CDLL(str(path)).rt_wkv_scan
            fn.argtypes = _build.SIGNATURES["rt_wkv_scan"]

            def call(i, fn=fn):
                err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                         None, s0.data_ptr(), None, y.data_ptr(), s1.data_ptr(), None, b, s, h,
                         hd, 1, 0, _build.stream(r))
                _build.check(err, "wkv_scan")

            print(f"[wkv-phases] {card()}: prefill B={b} S={s} H={h} hd={hd}, bf16 r/k/v, f32 "
                  f"state, {name}: device ms a call {device_ms(call):.4f} (pass {rep + 1})",
                  flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("port_probe: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    what, args = (sys.argv[1], sys.argv[2:]) if len(sys.argv) > 1 else ("", [])
    if what == "device-times":
        device_times(Path(args[0]).resolve() if args else ROOT)
    elif what == "splits":
        splits([int(a) for a in args] or [128, 256, 384, 512])
    elif what == "wkv-phases":
        wkv_phases()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
