"""RG-LRU recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t²) gx_t`` (griffin).

Two entries on one CUDA kernel body (``csrc/rglru_scan.cu``), each running the
kernel on a CUDA tensor and its plain PyTorch version on a CPU tensor:

* ``rglru_scan(log_a, gx, h0, pos)`` — the contract of both bodies of
  ``repro/kernels/scan_rglru.py::rglru_scan_pallas``;
* ``rg_lru_gated(ga, gxp, u, lam, g, h0, pos)`` — griffin's recurrent block
  around the scan in the same launch: the gates from the gate linears'
  outputs (``r = σ(ga)``, ``i = σ(gxp)``, ``log a = -8·softplus(Λ)·r``,
  ``gx = i·u``), the scan, and the output gate ``y = h·gelu_tanh(g)``.
  ``models/griffin.py`` calls it; its final state may be written into
  ``h0``'s own storage.

For S > 1 the kernel is a chunked scan over S: a CTA takes one slot, 32
channels and a panel of ``PANEL`` steps staged in shared memory, one thread a
sub-chunk of ``SUB`` steps and a channel; the panels of one (slot, tile) pass
their sub-chunks' end pairs on through a workspace (``_carry``), and
``rglru_chunk_plan`` is that plan in plain ops.  At S == 1 one step for every
slot.  Both carry
the state in f32 and return the f32 final state, as the Pallas kernel does.
A padding step (``pos`` -1) is the identity pair (a = 1, b = 0): the state
passes through bitwise, so a row with no real step returns ``h0`` bitwise
and a padded tail repeats the last real ``h``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

C_RGLRU = 8.0  # log a = -C softplus(Λ) r
SUB = 16       # steps a thread of the kernel (csrc/rglru_scan.cu)
PANEL = 64     # steps a CTA: 4 sub-chunks

launches = 0
plain_cuda_calls = 0
_workspace: dict = {}
_epoch = 0


def _check_shapes(log_a, gx, h0, pos):
    if log_a.ndim != 3 or log_a.shape != gx.shape:
        raise ValueError(f"log_a/gx must both be (B, S, W); got {tuple(log_a.shape)} vs "
                         f"{tuple(gx.shape)}")
    b, s, w = log_a.shape
    if tuple(h0.shape) != (b, w):
        raise ValueError(f"h0 must be (B, W) = {(b, w)}; got {tuple(h0.shape)}")
    if pos is not None and tuple(pos.shape) != (b, s):
        raise ValueError(f"pos must be (B, S) = {(b, s)}; got {tuple(pos.shape)}")


def _pairs(log_a, gx):
    """(a, b) of every step in f32, as both versions form them."""
    log_a, gx = log_a.to(torch.float32), gx.to(torch.float32)
    a = torch.exp(log_a)
    return a, torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gx


def rglru_scan_plain(log_a, gx, h0, pos=None, *, scan_dtype=None):
    """The recurrence step by step in f32: log_a, gx (B, S, W), h0 (B, W),
    pos (B, S) int (``-1`` = padding step) or None (every step real).
    Returns (h (B, S, W) in ``scan_dtype`` (default f32), h_last (B, W) f32)."""
    _check_shapes(log_a, gx, h0, pos)
    a, b = _pairs(log_a, gx)
    real = None if pos is None else (pos >= 0)[:, :, None]
    h = h0.to(torch.float32, copy=True)  # h0 may be the caller's h_out, written after
    hs = []
    for t in range(log_a.shape[1]):
        step = a[:, t] * h + b[:, t]
        h = step if real is None else torch.where(real[:, t], step, h)
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else a.new_empty(log_a.shape)
    return out.to(scan_dtype or torch.float32), h


def rglru_chunk_plan(log_a, gx, h0, pos=None, *, sub=SUB, panel=PANEL):
    """The kernel's plan for the recurrence, in plain f32 ops rounded one by
    one as the kernel rounds them (no fused multiply-add).  Steps are cut into
    sub-chunks of ``sub``; a padding step and a step past S are the identity
    pair (1, 0).  (1) Each sub-chunk's prefix pairs h_t = A_t h_in + B_t, from
    (a, b) ∘ (A, B) = (a·A, a·B + b); (2) the walk of the sub-chunks' end pairs
    from h0 gives each sub-chunk's h_in: the kernel's CTA of panel p (``panel``
    steps) walks the earlier panels' end pairs, then its own, in this order;
    (3) h_t = A_t h_in + B_t.  Returns (h (B, S, W) f32, h_last (B, W) f32),
    h_last being h's last step."""
    _check_shapes(log_a, gx, h0, pos)
    if panel % sub:
        raise ValueError(f"panel ({panel}) must be a multiple of sub ({sub})")
    a, b = _pairs(log_a, gx)
    nb, s, w = a.shape
    if pos is not None:
        real = (pos >= 0)[:, :, None]
        a, b = torch.where(real, a, 1.0), torch.where(real, b, 0.0)
    sp = -(-s // panel) * panel
    a = F.pad(a, (0, 0, 0, sp - s), value=1.0).view(nb, sp // sub, sub, w)
    b = F.pad(b, (0, 0, 0, sp - s), value=0.0).view(nb, sp // sub, sub, w)
    pa, pb = torch.empty_like(a), torch.empty_like(b)
    ra, rb = torch.ones_like(a[:, :, 0]), torch.zeros_like(b[:, :, 0])
    for t in range(sub):                       # (1)
        ra = a[:, :, t] * ra
        rb = a[:, :, t] * rb + b[:, :, t]
        pa[:, :, t], pb[:, :, t] = ra, rb
    carry = h0.to(torch.float32)
    h_in = torch.empty_like(ra)
    per_panel = panel // sub
    for p in range(sp // panel):               # (2)
        for k in range(p * per_panel, (p + 1) * per_panel):
            h_in[:, k] = carry
            carry = pa[:, k, -1] * carry + pb[:, k, -1]
    h = (pa * h_in[:, :, None] + pb).view(nb, sp, w)[:, :s]   # (3)
    return h, h[:, -1].clone() if s else h0.to(torch.float32).clone()


def rglru_scan_ref(log_a, gx, h0, pos=None, *, scan_dtype=None):
    """The plain version; it counts the calls handed CUDA tensors."""
    global plain_cuda_calls
    plain_cuda_calls += log_a.is_cuda
    return rglru_scan_plain(log_a, gx, h0, pos, scan_dtype=scan_dtype)


def _check_cuda(name, t, dtypes):
    if t.dtype not in dtypes or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{name} must be a contiguous CUDA tensor of "
                         f"{' or '.join(map(str, dtypes))}; got {t.dtype}")


def _check_pos(pos):
    if pos is not None:
        _check_cuda("pos", pos, (torch.int32,))


def _carry(device, b, s, w):
    """(workspace, its bytes, epoch) of the cross-CTA carry a launch at (B, S,
    W) needs, (None, 0, 0) when one panel covers S.  One zero-filled buffer a
    device, replaced by a larger one when a call needs more; a launch marks
    its flags with an epoch no earlier launch used, so no launch zero-fills
    it."""
    global _epoch
    need = _build.lib().rt_rglru_workspace_bytes(b, s, w)
    if need == 0:
        return None, 0, 0
    ws = _workspace.get(device.index)
    if ws is None or ws.numel() < need:
        ws = _workspace[device.index] = torch.zeros(need, dtype=torch.uint8, device=device)
    _epoch = _epoch % (2 ** 31 - 1) + 1
    return ws.data_ptr(), ws.numel(), _epoch


def _rglru_scan_cuda(log_a, gx, h0, pos, scan_dtype):
    _build.refuse_grad("rglru_scan", log_a, gx, h0)
    global launches
    _check_shapes(log_a, gx, h0, pos)
    for nm, t in (("log_a", log_a), ("gx", gx), ("h0", h0)):
        _check_cuda(nm, t, (torch.float32,))
    _check_pos(pos)
    out_dtype = scan_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scan_dtype must be f32 or bf16, got {out_dtype}")
    b, s, w = log_a.shape
    h = torch.empty((b, s, w), dtype=out_dtype, device=log_a.device)
    h_last = torch.empty((b, w), dtype=torch.float32, device=log_a.device)
    if s == 0:
        return h, h_last.copy_(h0)
    err = _build.lib().rt_rglru_scan(
        log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(), _build.ptr(pos), h.data_ptr(),
        h_last.data_ptr(), *_carry(log_a.device, b, s, w), b, s, w, _build.dtype_code(h),
        _build.stream(log_a))
    _build.check(err, "rglru_scan")
    launches += 1
    return h, h_last


def rglru_scan(log_a, gx, h0, pos=None, *, scan_dtype=None):
    """(h (B, S, W) scan_dtype, h_last (B, W) f32): the kernel on a CUDA
    tensor (S == 1 takes one step for every slot), the plain version on a
    CPU tensor."""
    if not log_a.is_cuda:
        return rglru_scan_ref(log_a, gx, h0, pos, scan_dtype=scan_dtype)
    return _rglru_scan_cuda(log_a, gx, h0, pos, scan_dtype)


# ---------------------------------------------------------------------------
# griffin's block around the scan
# ---------------------------------------------------------------------------
def _check_gated(ga, gxp, u, lam, g, h0, pos, h_out):
    if not (ga.shape == gxp.shape == u.shape == g.shape) or u.ndim != 3:
        raise ValueError(f"ga/gxp/u/g must all be (B, S, W); got {tuple(ga.shape)}, "
                         f"{tuple(gxp.shape)}, {tuple(u.shape)}, {tuple(g.shape)}")
    b, s, w = u.shape
    if tuple(lam.shape) != (w,):
        raise ValueError(f"lam must be (W,) = {(w,)}; got {tuple(lam.shape)}")
    _check_shapes(u, u, h0, pos)
    if h_out is not None and tuple(h_out.shape) != (b, w):
        raise ValueError(f"h_out must be (B, W) = {(b, w)}; got {tuple(h_out.shape)}")


def rg_lru_gated_plain(ga, gxp, u, lam, g, h0, pos=None, *, h_out=None):
    """Griffin's ops around the scan, as the model wrote them: the gates in
    f32, ``rglru_scan_plain`` with h in u's dtype, then ``y = h · gelu_tanh(g)``
    rounded to g's dtype.  Returns (y (B, S, W), h_last (B, W) f32), h_last
    copied into ``h_out`` when given."""
    _check_gated(ga, gxp, u, lam, g, h0, pos, h_out)
    f32 = torch.float32
    r = torch.sigmoid(ga.to(f32))
    i = torch.sigmoid(gxp.to(f32))
    log_a = -C_RGLRU * F.softplus(lam.to(f32)) * r
    gx = i * u.to(f32)
    h, h_last = rglru_scan_plain(log_a, gx, h0, pos, scan_dtype=u.dtype)
    y = h.to(g.dtype) * F.gelu(g.to(f32), approximate="tanh").to(g.dtype)
    return y, h_last if h_out is None else h_out.copy_(h_last)


def rg_lru_gated_ref(ga, gxp, u, lam, g, h0, pos=None, *, h_out=None):
    """The plain version; it counts the calls handed CUDA tensors."""
    global plain_cuda_calls
    plain_cuda_calls += u.is_cuda
    return rg_lru_gated_plain(ga, gxp, u, lam, g, h0, pos, h_out=h_out)


def _rg_lru_gated_cuda(ga, gxp, u, lam, g, h0, pos, h_out):
    _build.refuse_grad("rglru_scan (gated)", ga, gxp, u, lam, g, h0)
    global launches
    _check_gated(ga, gxp, u, lam, g, h0, pos, h_out)
    dtypes = (torch.float32, torch.bfloat16)
    _check_cuda("u", u, dtypes)
    for nm, t in (("ga", ga), ("gxp", gxp), ("g", g)):
        _check_cuda(nm, t, (u.dtype,))
    _check_cuda("lam", lam, dtypes)
    _check_cuda("h0", h0, (torch.float32,))
    _check_pos(pos)
    b, s, w = u.shape
    h_last = h_out
    if h_last is None:
        h_last = torch.empty((b, w), dtype=torch.float32, device=u.device)
    else:
        _check_cuda("h_out", h_last, (torch.float32,))
    y = torch.empty_like(u)
    if s == 0:
        return y, h_last.copy_(h0)
    err = _build.lib().rt_rglru_gated(
        ga.data_ptr(), gxp.data_ptr(), u.data_ptr(), g.data_ptr(), lam.data_ptr(),
        h0.data_ptr(), _build.ptr(pos), y.data_ptr(), h_last.data_ptr(),
        *_carry(u.device, b, s, w), b, s, w, _build.dtype_code(u), _build.dtype_code(lam),
        _build.stream(u))
    _build.check(err, "rglru_scan (gated)")
    launches += 1
    return y, h_last


def rg_lru_gated(ga, gxp, u, lam, g, h0, pos=None, *, h_out=None):
    """Griffin's RG-LRU with its gates and output gate: ga, gxp (the gate
    linears' outputs), u (the conv output) and g (the ``in_g`` linear's
    output), all (B, S, W) of one dtype, lam (W,), h0 (B, W) f32, pos (B, S)
    (-1 = padding step) or None.  Returns (y = h·gelu_tanh(g) (B, S, W) in
    u's dtype, h_last (B, W) f32); with ``h_out`` (which may be ``h0``
    itself) h_last is written there.  One kernel launch on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not u.is_cuda:
        return rg_lru_gated_ref(ga, gxp, u, lam, g, h0, pos, h_out=h_out)
    return _rg_lru_gated_cuda(ga, gxp, u, lam, g, h0, pos, h_out)
