"""RWKV6 wkv recurrence over a per-(slot, head) matrix state S (hd x hd):

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t;   y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

``wkv_scan`` runs the CUDA kernel (``csrc/wkv_scan.cu``: one CTA per (slot,
head), the state on chip for the whole call) on a CUDA tensor and the plain
PyTorch version on a CPU tensor.  Replaces
``repro/kernels/scan_wkv.py::wkv_scan_pallas``.

The contract is ``repro.kernels.ref.wkv_scan``'s.  S > 1 is the chunked form
(``WKV_CHUNK``-step chunks, ragged tails padded with identity steps), whose
per-step log-decay is clipped at ``WKV_LOG_DECAY_FLOOR``; the kernel computes
that form too, its four products per chunk on the tensor cores in 3xTF32
(``wkv_chunk_plan`` emulates it, TF32 rounding and all).  S == 1 is the exact
step with the raw ``w``.  A padding step (``pos`` -1) has k = 0 and w = 1, so
an f32 state passes it bitwise.  int8 state carries per-(slot, head) f32 scales: it is
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: the low 13
    of the 23 mantissa bits rounded off, ties away from zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the 3xTF32 split the kernel's mma.sync runs: a_hi b_hi +
    a_hi b_lo + a_lo b_hi, with hi = tf32(x) and lo = tf32(x - hi)."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def wkv_chunk_plan(r, k, v, w, u, state0, pos=None, *, state_scale=None):
    """The chunked kernel's plan emulated in float32 (S > 1): per chunk of
    ``WKV_CHUNK`` steps the clipped log-decays and their sums, r~, k~ and
    k_end, A = tril_{-1}(r~ k~^T), y = A v + diag v + r~ S and, when the
    chunk holds a real step, S <- e^{la_end} S + k_end^T v, each product in
    3xTF32; ragged tails and padding steps are identity steps.  Returns (y,
    new state, new scale or None) like ``wkv_scan_plain``."""
    check_shapes(r, k, v, w, u, state0, pos, state_scale)
    f32 = torch.float32
    b, s, h, hd = r.shape
    c_len = WKV_CHUNK
    n = -(-s // c_len) * c_len
    pad = (0, 0, 0, 0, 0, n - s)
    r, k, v, w = (torch.nn.functional.pad(t.to(f32), pad) for t in (r, k, v, w))
    real = torch.arange(n)[None] < s
    if pos is not None:
        real = real & (torch.nn.functional.pad(pos, (0, n - s), value=-1) >= 0)
    u = u.to(f32)
    st = state0.to(f32)
    if state_scale is not None:
        st = st * state_scale[..., None, None]
    to_bh = lambda t: t.permute(0, 2, 1, 3)  # noqa: E731  (B, H, C, hd)
    ys = []
    tri = torch.tril(torch.ones(c_len, c_len, dtype=torch.bool), diagonal=-1)
    for c0 in range(0, n, c_len):
        sl = slice(c0, c0 + c_len)
        live = real[:, sl][:, None, :, None]  # (B, 1, C, 1)
        rc, vc = to_bh(r[:, sl]), to_bh(v[:, sl])
        kc = torch.where(live, to_bh(k[:, sl]), 0.0)
        lw = torch.where(live, torch.clamp(torch.log(torch.clamp(to_bh(w[:, sl]), min=1e-38)),
                                           WKV_LOG_DECAY_FLOOR, 0.0), 0.0)
        la = torch.cumsum(lw, dim=2)
        lx = torch.nn.functional.pad(la[:, :, :-1], (0, 0, 1, 0))
        le = la[:, :, -1:]
        rt, kt, ke = rc * torch.exp(lx), kc * torch.exp(-la), kc * torch.exp(le - la)
        a = torch.where(tri, mm_3xtf32(rt, kt.transpose(-1, -2)), 0.0)
        dg = (rc * u[None, :, None, :] * kc).sum(-1, keepdim=True)
        y = mm_3xtf32(a, vc) + dg * vc + mm_3xtf32(rt, st)
        any_real = real[:, sl].any(dim=1)[:, None, None, None]
        upd = st * torch.exp(le).transpose(-1, -2) + mm_3xtf32(ke.transpose(-1, -2), vc)
        st = torch.where(any_real, upd, st)
        ys.append(y.permute(0, 2, 1, 3))
    y = torch.cat(ys, dim=1)[:, :s]
    if state_scale is None:
        return y, st, None
    sc = st.abs().amax(dim=(-2, -1)).clamp(min=1e-8) / 127.0
    q = torch.round(st / sc[..., None, None]).to(torch.int8)
    idle = ~real.any(dim=1)
    q = torch.where(idle[:, None, None, None], state0, q)
    sc = torch.where(idle[:, None], state_scale, sc)
    return y, q, sc


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
    if s > 1 and any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("the chunked wkv kernel takes r/k/v/w at 16-byte aligned addresses")
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    st = torch.empty_like(state0)
    sc = None if state_scale is None else torch.empty_like(state_scale)
    err = _build.lib().rt_wkv_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), _build.ptr(pos),
        state0.data_ptr(), _build.ptr(state_scale), y.data_ptr(), st.data_ptr(), _build.ptr(sc),
        b, s, h, hd, _build.dtype_code(r), _build.dtype_code(state0), _build.stream(r))
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
