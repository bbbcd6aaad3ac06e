"""RWKV6 wkv recurrence over a per-(slot, head) matrix state S (hd x hd):

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t;   y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

``wkv_scan`` runs the CUDA kernel (``csrc/wkv_scan.cu``: one CTA per (slot,
head), the state in registers for the whole call) on a CUDA tensor and the
plain PyTorch version on a CPU tensor.  Replaces
``repro/kernels/scan_wkv.py::wkv_scan_pallas``.

The contract is ``repro.kernels.ref.wkv_scan``'s.  S > 1 is the chunked form
(``WKV_CHUNK``-step chunks, ragged tails padded with identity steps), whose
per-step log-decay is clipped at ``WKV_LOG_DECAY_FLOOR``: it equals the
sequential recurrence run with ``w' = exp(clip(log max(w, 1e-38), floor,
0))``, which is what the kernel walks.  S == 1 is the exact step with the raw
``w``.  A padding step (``pos`` -1) has k = 0 and w = 1, so an f32 state
passes it bitwise.  int8 state carries per-(slot, head) f32 scales: it is
dequantized at entry and requantized at exit with amax/127 (round half to
even); a row with no real step returns its stored payload and scale bitwise.
"""
from __future__ import annotations

import torch

from . import _build

WKV_CHUNK = 16
WKV_LOG_DECAY_FLOOR = -4.9
KERNEL_HEAD_DIMS = (16, 32, 64)

launches = 0
plain_cuda_calls = 0


def check_shapes(r, k, v, w, u, state0, pos, state_scale):
    if r.ndim != 4 or not r.shape == k.shape == v.shape == w.shape:
        raise ValueError("r/k/v/w must share one (B, S, H, hd) shape; got "
                         f"{tuple(r.shape)}/{tuple(k.shape)}/{tuple(v.shape)}/{tuple(w.shape)}")
    b, s, h, hd = r.shape
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"u must be (H, hd) = {(h, hd)}; got {tuple(u.shape)}")
    if tuple(state0.shape) != (b, h, hd, hd):
        raise ValueError(f"state0 must be (B, H, hd, hd); got {tuple(state0.shape)}")
    if (state_scale is None) != (state0.dtype != torch.int8):
        raise ValueError("int8 state0 requires state_scale (and vice versa); got state0 "
                         f"{state0.dtype} with state_scale "
                         f"{'set' if state_scale is not None else 'None'}")
    if state_scale is not None and tuple(state_scale.shape) != (b, h):
        raise ValueError(f"state_scale must be (B, H) = {(b, h)}; got "
                         f"{tuple(state_scale.shape)}")
    if pos is not None and tuple(pos.shape) != (b, s):
        raise ValueError(f"pos must be (B, S) = {(b, s)}; got {tuple(pos.shape)}")


def _sequential(r, k, v, w, u, s):
    """The exact recurrence step by step in f32; returns (y, final state)."""
    ys = []
    u4 = u[None, :, :, None]
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u4 * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _chunked(r, k, v, w, u, s, chunk):
    """``repro.kernels.ref.wkv_chunked``: per chunk of C steps, with the
    clipped cumulative log-decay la, an intra-chunk score matrix, the
    diagonal bonus term and one state product; S must be a multiple of C."""
    b, sl, h, hd = r.shape
    nc = sl // chunk

    def cshape(t):
        return t.reshape(b, nc, chunk, h, hd)

    rc, kc, vc = cshape(r), cshape(k), cshape(v)
    lw = torch.clamp(torch.log(torch.clamp(cshape(w), min=1e-38)), WKV_LOG_DECAY_FLOOR, 0.0)
    la_inc = torch.cumsum(lw, dim=2)   # includes step τ's decay
    la_exc = la_inc - lw               # decay before step t
    la_end = la_inc[:, :, -1]          # (b, nc, h, hd)
    r_tld = rc * torch.exp(la_exc)
    k_tld = kc * torch.exp(-la_inc)
    k_end = kc * torch.exp(la_end[:, :, None] - la_inc)
    scores = torch.einsum("bnthd,bnshd->bnhts", r_tld, k_tld)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    diag = torch.einsum("bnthd,hd,bnthd->bnth", rc, u, kc)
    intra = torch.einsum("bnhts,bnshd->bnthd", scores, vc) + diag[..., None] * vc
    ys = []
    for c in range(nc):
        ys.append(torch.einsum("bthk,bhkv->bthv", r_tld[:, c], s))
        s = s * torch.exp(la_end[:, c])[..., None] \
            + torch.einsum("bthk,bthv->bhkv", k_end[:, c], vc[:, c])
    y = intra + torch.stack(ys, dim=1)
    return y.reshape(b, sl, h, hd), s


def wkv_scan_plain(r, k, v, w, u, state0, pos=None, *, state_scale=None,
                   chunk: int = WKV_CHUNK):
    """r/k/v/w (B, S, H, hd), u (H, hd), state0 (B, H, hd, hd) f32 or int8
    with ``state_scale`` (B, H) f32, pos (B, S) int (-1 = padding) or None.
    Returns (y (B, S, H, hd) f32, new state, new scale or None)."""
    check_shapes(r, k, v, w, u, state0, pos, state_scale)
    f32 = torch.float32
    b, s, h, hd = r.shape
    r, k, v, w, u = (t.to(f32) for t in (r, k, v, w, u))
    if pos is not None:
        m = (pos >= 0)[:, :, None, None]
        k = torch.where(m, k, 0.0)   # a pad step writes nothing into the state
        w = torch.where(m, w, 1.0)   # ...and decays nothing away
    s0 = state0.to(f32)
    if state_scale is not None:
        s0 = s0 * state_scale[..., None, None]
    if s == 1:
        y, st = _sequential(r, k, v, w, u, s0)
    else:
        pad = (-s) % chunk
        if pad:  # identity steps: k = 0, w = 1
            r, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
            w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        y, st = _chunked(r, k, v, w, u, s0, chunk)
        y = y[:, :s]
    if state_scale is None:
        return y, st, None
    sc = st.abs().amax(dim=(-2, -1)).clamp(min=1e-8) / 127.0
    q = torch.round(st / sc[..., None, None]).to(torch.int8)
    if pos is not None:
        idle = (pos < 0).all(dim=1)
        q = torch.where(idle[:, None, None, None], state0, q)
        sc = torch.where(idle[:, None], state_scale, sc)
    return y, q, sc


def wkv_scan_ref(r, k, v, w, u, state0, pos=None, *, state_scale=None):
    """The plain version; it counts the calls handed CUDA tensors."""
    global plain_cuda_calls
    plain_cuda_calls += r.is_cuda
    return wkv_scan_plain(r, k, v, w, u, state0, pos, state_scale=state_scale)


def _wkv_scan_cuda(r, k, v, w, u, state0, pos, state_scale):
    global launches
    check_shapes(r, k, v, w, u, state0, pos, state_scale)
    b, s, h, hd = r.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"wkv_scan kernel takes head dims {KERNEL_HEAD_DIMS}, got {hd}")
    if r.dtype not in (torch.float32, torch.bfloat16) or not r.dtype == k.dtype == v.dtype:
        raise TypeError(f"r/k/v must share one dtype, f32 or bf16; got "
                        f"{r.dtype}/{k.dtype}/{v.dtype}")
    f32_args = [("w", w), ("u", u)] + ([("state_scale", state_scale)] if state_scale is not None
                                       else [])
    for nm, t in [("r", r), ("k", k), ("v", v)] + f32_args:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{nm} must be a contiguous CUDA tensor")
    for nm, t in f32_args:
        if t.dtype != torch.float32:
            raise TypeError(f"{nm} must be f32, got {t.dtype}")
    if state0.dtype not in (torch.float32, torch.int8) or not state0.is_contiguous() \
            or not state0.is_cuda:
        raise ValueError("state0 must be a contiguous CUDA f32 or int8 tensor")
    if pos is not None and (pos.dtype != torch.int32 or not pos.is_contiguous()
                            or not pos.is_cuda):
        raise ValueError("pos must be a contiguous CUDA int32 tensor")
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    st = torch.empty_like(state0)
    sc = None if state_scale is None else torch.empty_like(state_scale)
    err = _build.lib().rt_wkv_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), _build.ptr(pos),
        state0.data_ptr(), _build.ptr(state_scale), y.data_ptr(), st.data_ptr(), _build.ptr(sc),
        b, s, h, hd, _build.dtype_code(r), _build.dtype_code(state0),
        int(s > 1), _build.stream(r))
    _build.check(err, "wkv_scan")
    launches += 1
    return y, st, sc


def wkv_scan(r, k, v, w, u, state0, pos=None, *, state_scale=None):
    """(y (B, S, H, hd) f32, new state, new scale or None): the kernel on a
    CUDA tensor (r/k/v f32 or bf16; w, u, state_scale f32; state f32 or
    int8; pos int32), the plain version on a CPU tensor."""
    if not r.is_cuda:
        return wkv_scan_ref(r, k, v, w, u, state0, pos, state_scale=state_scale)
    return _wkv_scan_cuda(r, k, v, w, u, state0, pos, state_scale)
