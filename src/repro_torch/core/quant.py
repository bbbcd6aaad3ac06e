"""INT4 weight quantization (paper: "Wt: INT4, Act: FP16", w4a16).

Symmetric per-group quantization along the input dimension: packed uint8
``qweight`` (out, in//2) with the low nibble holding the even index, values
in [-8, 7], and ``scales`` (out, in//group) — the layout the int4 kernel reads.
"""
from __future__ import annotations

import torch

QMAX = 7  # symmetric int4: [-8, 7], scale on |max| -> 7


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(…, K) int8 in [-8,7] -> (…, K//2) uint8, low nibble = even index."""
    if q.shape[-1] % 2:
        raise ValueError("last dim must be even to pack int4 pairs")
    q = q.to(torch.int16)
    lo = q[..., 0::2] & 0x0F
    hi = q[..., 1::2] & 0x0F
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """(…, K//2) uint8 -> (…, K) int8 in [-8, 7]."""
    p = p.to(torch.int16)
    lo = p & 0x0F
    hi = (p >> 4) & 0x0F
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2).to(torch.int8)


def quantize_int4(w: torch.Tensor, group_size: int = 128,
                  scale_dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """(out, in) weight -> {"qweight": (out, in//2) uint8, "scales":
    (out, in//group_size)}, symmetric per group."""
    w = w.to(torch.float32)
    out_f, in_f = w.shape
    if in_f % group_size:
        raise ValueError(f"in_features {in_f} not divisible by group {group_size}")
    g = w.reshape(out_f, in_f // group_size, group_size)
    amax = g.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor, not the Python scalar: CUDA turns division by a
    # host scalar into a multiply by its reciprocal, which can differ by an
    # ulp, and the scales must equal the CPU's (and repro's) bitwise
    scale = torch.where(amax > 0, amax / torch.full_like(amax, QMAX), torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale), -8, 7).to(torch.int8)
    return {"qweight": pack_int4(q.reshape(out_f, in_f)),
            "scales": scale[..., 0].to(scale_dtype)}


def dequantize_int4(qparams: dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """Packed int4 -> dense (out, in) weight."""
    q = unpack_int4(qparams["qweight"])
    out_f, in_f = q.shape
    scales = qparams["scales"].to(torch.float32)
    group = in_f // scales.shape[1]
    w = q.reshape(out_f, scales.shape[1], group).to(torch.float32) * scales[..., None]
    return w.reshape(out_f, in_f).to(dtype)
