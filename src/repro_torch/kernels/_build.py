"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` (all started
together) for ``sm_90a`` into an object file, and the objects are linked
into one shared library with a plain C interface that ``ctypes`` loads.
The build happens at first use, goes into ``repro_torch/_build/<hash>/``
(listed in ``.gitignore``) and is redone whenever the sources' hash
changes.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_long

# C entry points and their argument types (see each .cu file's extern "C").
SIGNATURES = {
    "rt_tt_linear": [P, I, P, P, P, P, P, P, P, P, I, I, P, P, P, I, P],
    "rt_tt_linear_fused": [P] * 7 + [I, I, P, P, P, I, I, I, I, P],
    "rt_int4_matmul": [P] * 7 + [I] * 5 + [P],
    "rt_int4_unpack": [P, P, I, P],
    "rt_paged_decode_attention": [P] * 10 + [I] * 6 + [F, I, I, I, I, P],
    "rt_paged_prefill_attention": [P] * 8 + [I] * 8 + [F, I, I, P],
    "rt_ring_prefill_attention": [P] * 8 + [I] * 7 + [F, I, I, P],
    "rt_ring_decode_attention": [P] * 9 + [I] * 6 + [F, I, I, I, P],
    "rt_rglru_scan": [P] * 7 + [L] + [I] * 5 + [P],
    "rt_rglru_gated": [P] * 10 + [L] + [I] * 6 + [P],
    "rt_rglru_workspace_bytes": [I] * 3,
    "rt_tt_embed": [P, I, P, I, P, I, I, P, P, P, P, I, P],
    "rt_wkv_scan": [P] * 11 + [I] * 6 + [P],
}

RESTYPE_LONG = {"rt_rglru_workspace_bytes"}

_LIB = None
build_seconds = None  # wall time of the build (or load) done in this process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=out.parent))
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        for src, _, pr in procs:
            text, _ = pr.communicate()
            log.append(f"== {src.name}\n{text}")
            if pr.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        lib = tmp / "libreprotorch.so"
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                               *[str(o) for _, o, _ in procs]],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (tmp / "build.log").write_text("\n".join(log))  # ptxas -v: registers, spills
        os.replace(lib, out)
        os.replace(tmp / "build.log", out.with_suffix(".log"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libreprotorch.so"
    if not so.exists():
        _build(so)
    handle = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = L if name in RESTYPE_LONG else ctypes.c_int
    _LIB = handle
    build_seconds = time.perf_counter() - t0
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def int_array(vals):
    """A ctypes int array of ``vals`` (mode and rank lists for the C side)."""
    return (ctypes.c_int * len(vals))(*vals)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream(t) -> int:
    """Raw handle of the current CUDA stream on ``t``'s device."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def dtype_code(t) -> int:
    """The C side's dtype code (csrc/common.cuh: RT_F32, RT_BF16, RT_I8)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    if t.dtype not in codes:
        raise TypeError(f"no kernel dtype code for {t.dtype}")
    return codes[t.dtype]


def epilogue_vector(v, n: int, name: str):
    """An epilogue scale/bias as the contiguous f32 (n,) CUDA vector the C side reads."""
    import torch
    if v is None:
        return None
    if v.shape != (n,) or not v.is_cuda:
        raise ValueError(f"{name} must be a CUDA ({n},) vector; got {tuple(v.shape)}")
    return v.to(torch.float32).contiguous()
