"""repro_torch's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where there is no CUDA
device or no ``nvcc``, decided inside the test.  On a machine with an H100:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: the linear kernels take 1e-4 (f32 inputs: summation order only)
or 2e-2 / 1e-2 (bf16 inputs: bf16 output rounding, and the TT kernel rounds
its operators and its one intermediate to bf16 where the f32 reference keeps
f32) of max|want| over
the output, whose rows all share one scale.  Attention rows do not (a row
at position 0 returns one value row, a row over many keys an average far
smaller), so attention is held element by element against its own row:
|d| <= atol * row max|want| + rtol * |want|, with atol = rtol = 1e-4 for f32
and atol = rtol = 2^-6 (2-4 bf16 ulps of the row max and of the element) for
bf16: the prefill kernel rounds P, and the K and V it dequantizes from int8
pools, to bf16 for its mma products.
"""
import contextlib
import math
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_card_cases import REFUSALS, refused_config

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not (shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists()):
        pytest.skip("needs nvcc to build the kernels")
    from repro_torch.kernels import _build
    _build.lib()
    return torch.device("cuda")


def _close(got, want, rel):
    want = want.float()
    scale = want.abs().max().item() or 1.0
    err = (got.float() - want).abs().max().item()
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def _close_rows(got, want, atol, rtol):
    want = want.float()
    d = (got.float() - want).abs()
    lim = atol * want.abs().amax(-1, keepdim=True) + rtol * want.abs()
    bad = d > lim
    assert not bad.any(), (f"{int(bad.sum())} elements out of tolerance; worst |diff| "
                           f"{d[bad].max().item()} against {lim[bad][d[bad].argmax()].item()}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("modes", [
    ((16, 8, 8, 4), (4, 8, 8, 16), 16),     # llama2 attn_o
    ((16, 8, 8, 4), (4, 4, 16, 43), 16),    # llama2 gate/up
    ((107, 8, 4, 4), (8, 8, 8, 8), 16),     # chatglm3 down
    ((8, 8, 8, 5), (12, 10, 8, 8), 16),     # recurrentgemma-2b gate/up (left first)
    ((12, 10, 8, 8), (8, 8, 8, 5), 16),     # recurrentgemma-2b down (right first)
    ((8, 8, 8, 8), (16, 14, 8, 8), 16),     # rwkv6-7b cm_key (right first, Ms 224)
    ((8, 4, 2), (3, 5, 7), 4),
    ((24,), (10,), 1),
])
@pytest.mark.parametrize("b", [1, 7, 130])
def test_tt_linear_kernel(dev, modes, dtype, b):
    """bf16 takes the fused route (the operator pass and the two-half
    contraction: 2 launches), f32 the staged one (a launch per core); the
    bf16 d = 3 case also runs whisper-base's three specs at its epilogues."""
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import tt_linear as k
    spec = TTSpec.make(0, 0, modes[2], d=len(modes[0]), in_modes=modes[0], out_modes=modes[1])
    g = torch.Generator(device=dev).manual_seed(b)
    cores = [(torch.randn(s, generator=g, device=dev) / math.sqrt(s[0])).to(dtype)
             for s in spec.core_matrix_shapes()]
    x = torch.randn(b, spec.n_in, generator=g, device=dev).to(dtype)
    bias = torch.randn(spec.n_out, generator=g, device=dev)
    res = torch.randn(b, spec.n_out, generator=g, device=dev).to(dtype)
    cases = [(spec, cores, x, kw) for kw in (
        {}, dict(bias=bias, activation="silu"), dict(scale=bias, residual=res),
        dict(activation="gelu", residual=res))]
    if len(modes[0]) == 3 and dtype == torch.bfloat16:
        # whisper-base's d = 3 specs (one-core halves) at its call sites: up
        # with bias and GELU, attn_o and down with bias and the residual, at
        # B 8 (a decode tick), 1500 (the encoder) and 2048 rows by b
        rows = {1: 8, 7: 1500, 130: 2048}[b]
        for n_in, n_out in ((512, 512), (512, 2048), (2048, 512)):
            ws = TTSpec.make(n_in, n_out, 16, d=3)
            wc = [(torch.randn(s, generator=g, device=dev) / math.sqrt(s[0])).to(dtype)
                  for s in ws.core_matrix_shapes()]
            wx = torch.randn(rows, n_in, generator=g, device=dev).to(dtype)
            wb = torch.randn(n_out, generator=g, device=dev)
            epi = dict(bias=wb, activation="gelu") if n_out > n_in else dict(
                bias=wb, residual=torch.randn(rows, n_out, generator=g, device=dev).to(dtype))
            cases.append((ws, wc, wx, epi))
    for spec, cores, x, kw in cases:
        n0 = k.launches
        got = k.tt_linear(x, cores, spec, **kw)
        assert k.launches == n0 + (2 if dtype == torch.bfloat16 else spec.d)
        want = k.tt_linear_ref(x.float(), [c.float() for c in cores], spec,
                               **{a: (v.float() if torch.is_tensor(v) else v)
                                  for a, v in kw.items()})
        _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("b,k_in,m,group", [
    (1, 256, 96, 128), (8, 4096, 4096, 128), (8, 11008, 4096, 128),
    (33, 512, 200, 64), (300, 4096, 11008, 128), (2048, 256, 64, 32),
    (17, 4096, 4096, 128), (2047, 4096, 4096, 128), (2048, 2560, 256, 128),
    (2048, 11008, 4096, 128),
    # the decode GEMV at the serve widths, B 1-16
    (1, 4096, 11008, 128), (2, 4096, 11008, 128), (8, 4096, 11008, 128), (16, 4096, 11008, 128),
    (1, 2560, 256, 128), (2, 2560, 256, 128), (8, 2560, 256, 128), (16, 2560, 256, 128),
    # both sides of the crossover (GEMV_MAX_B) and the GEMV's widest token tiles
    (16, 4096, 4096, 128), (24, 4096, 4096, 128), (32, 4096, 4096, 128),
    (48, 4096, 4096, 128), (49, 4096, 4096, 128),
    # every group size, M not a multiple of 16, a group deeper than a slice
    (8, 4096, 4096, 16), (8, 4096, 4096, 32), (8, 512, 200, 64), (3, 4096, 1000, 128),
    (5, 1024, 37, 16), (8, 4096, 512, 4096)])
def test_int4_matmul_kernel(dev, b, k_in, m, group):
    """One launch a call: B <= GEMV_MAX_B (24) takes the split-K GEMV, above
    it the wgmma GEMM (a partial token tile at 33, 49, 300, 2047); M not a
    multiple of the 128-row tile or of 16 (96, 200, 64, 1000, 37), K = 11008
    (172 steps of 64), groups of 16, 32, 64, 128 and one group for all of K;
    the (33, 512, 200, 64) case also runs whisper-base's biased 512 -> 512."""
    from repro_torch.core.quant import quantize_int4
    from repro_torch.kernels import int4_matmul as k
    g = torch.Generator(device=dev).manual_seed(b)
    q = quantize_int4(torch.randn(m, k_in, generator=g, device=dev) / math.sqrt(k_in), group)
    x = torch.randn(b, k_in, generator=g, device=dev).to(torch.bfloat16)
    res = torch.randn(b, m, generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn(m, generator=g, device=dev)
    cases = [(x, q, group, kw) for kw in (
        {}, dict(bias=bias, activation="silu"), dict(residual=res, scale=bias))]
    if (b, k_in, m, group) == (33, 512, 200, 64):
        # whisper-base's q/k/v (512 -> 512, g128) with its bias: the decode
        # GEMV at B 8, the GEMM at the encoder's 1500 rows and at 1536
        wq = quantize_int4(torch.randn(512, 512, generator=g, device=dev) / math.sqrt(512), 128)
        wb = torch.randn(512, generator=g, device=dev)
        for rows in (8, 1500, 1536):
            wx = torch.randn(rows, 512, generator=g, device=dev).to(torch.bfloat16)
            cases += [(wx, wq, 128, {}), (wx, wq, 128, dict(bias=wb))]
    for x, q, group, kw in cases:
        n0 = k.launches
        got = k.int4_matmul(x, q["qweight"], q["scales"], group, **kw)
        assert k.launches == n0 + 1
        want = k.int4_matmul_ref(x.float(), q["qweight"], q["scales"], group,
                                 **{a: (v.float() if torch.is_tensor(v) else v)
                                    for a, v in kw.items()})
        _close(got, want, 1e-2)


@pytest.mark.parametrize("b,k_in,m,dtype", [
    (8, 4096, 4096, torch.bfloat16), (16, 11008, 4096, torch.bfloat16),
    (8, 2560, 256, torch.bfloat16), (8, 7168, 384, torch.float32),
    (2048, 7168, 384, torch.float32), (2048, 6144, 8, torch.float32)])
def test_int4_matmul_split_k_is_bitwise_reproducible(dev, b, k_in, m, dtype):
    """A row tile's K slices are summed in slice order inside their cluster,
    so three calls give the same bits; a residual one element into its
    buffer (not 16-byte aligned) is taken as well."""
    from repro_torch.core.quant import quantize_int4
    from repro_torch.kernels import int4_matmul as k
    g = torch.Generator(device=dev).manual_seed(k_in + m)
    q = quantize_int4(torch.randn(m, k_in, generator=g, device=dev) / math.sqrt(k_in), 128)
    x = torch.randn(b, k_in, generator=g, device=dev).to(dtype)
    res = torch.randn(b * m + 1, generator=g, device=dev).to(dtype)[1:].view(b, m)
    outs = [k.int4_matmul(x, q["qweight"], q["scales"], 128, residual=res, activation="gelu")
            for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    want = k.int4_matmul_ref(x.float(), q["qweight"], q["scales"], 128, residual=res.float(),
                             activation="gelu")
    _close(outs[0], want, 1e-2 if dtype == torch.bfloat16 else 1e-4)


def test_int4_nibble_conversion_all_bytes(dev):
    """The prefill kernel's conversion (byte gather + magic-number bf16) on
    all 256 byte values, bit for bit against ``unpack_int4``."""
    from repro_torch.core.quant import unpack_int4
    from repro_torch.kernels import int4_matmul as k
    packed = torch.arange(256, dtype=torch.uint8, device=dev).reshape(8, 32)
    got = k.unpack_on_card(packed)
    torch.cuda.synchronize()
    assert torch.equal(got, unpack_int4(packed).to(torch.bfloat16))
    flipped = packed.flip(0).contiguous()  # each byte value in another lane and word
    assert torch.equal(k.unpack_on_card(flipped), unpack_int4(flipped).to(torch.bfloat16))


def _pool(nb, bs, hkv, dh, dtype, dev, g):
    k = torch.randn(nb, bs, hkv, dh, generator=g, device=dev)
    v = torch.randn(nb, bs, hkv, dh, generator=g, device=dev)
    if dtype != torch.int8:
        return {"k": k.to(dtype), "v": v.to(dtype)}
    out = {}
    for nm, x in (("k", k), ("v", v)):
        sc = x.abs().amax(-1).clamp(min=1e-8) / 127.0
        out[nm] = torch.round(x / sc[..., None]).to(torch.int8)
        out[nm + "_scale"] = sc
    return out


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("h,hkv,dh", [(4, 4, 128), (8, 2, 64), (32, 2, 128), (64, 8, 112)])
@pytest.mark.parametrize("sq,window", [(1, 0), (70, 0), (9, 5)])
def test_paged_attention_kernels(dev, sq, window, h, hkv, dh, qdt, kvdt):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as pf
    g = torch.Generator(device=dev).manual_seed(sq * 100 + h)
    b, bs, w = 3, 16, 12
    nb = 1 + b * w
    # at (8, 2, 64) also whisper-base's heads, H8/Hkv8/Dh64 (group 1)
    for n_kv in (hkv, 8) if (h, hkv, dh) == (8, 2, 64) else (hkv,):
        cache = _pool(nb, bs, n_kv, dh, kvdt, dev, g)
        bt = torch.randperm(nb - 1, generator=g, device=dev)[:b * w].reshape(b, w).to(
            torch.int32) + 1
        q = torch.randn(b, sq, h, dh, generator=g, device=dev).to(qdt)
        start = torch.tensor([0, 37, 120], device=dev)
        qpos = (start[:, None] + torch.arange(sq, device=dev)[None]).to(torch.int32)
        qpos[1, -1] = -1
        qpos[2, 0] = -1
        if sq == 1:
            got = pa.paged_attention(q[:, 0].contiguous(), cache, bt,
                                     qpos[:, 0].contiguous())[:, None]
        else:
            got = pf.prefill_attention(q, qpos, cache=cache, block_tables=bt, window=window)
        want = pa.paged_attention_plain(q.float(), {k: v for k, v in cache.items()}, bt, qpos,
                                        window=window)
        _close_rows(got, want,
                    *((1e-4, 1e-4) if qdt == torch.float32 else (2.0 ** -6, 2.0 ** -6)))
        assert not got[qpos < 0].any()


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.bfloat16, torch.int8),
                                      (torch.float32, torch.int8)])
@pytest.mark.parametrize("h,hkv,dh", [(4, 4, 64), (8, 4, 128), (32, 2, 128), (16, 1, 256),
                                      (10, 1, 256), (64, 8, 112), (4, 4, 112)])
def test_paged_decode_splits(dev, h, hkv, dh, qdt, kvdt):
    """Paged decode over tables of 640 entries in 3 splits (GQA groups 1, 2,
    16, 10 and 8; head dim 112: f32 queries take decode_simt, whose lanes
    own 4 dims each, and bf16 ones decode_mma, whose last load batch is
    masked): contexts of 1 key, mid-block (37), past a split boundary
    (299), the full table (640), one split only (129) and an inactive row
    (qpos -1: zeros); one launch a call, and three calls in a row bitwise
    equal (the split counters reset and the merge runs in split order)."""
    from repro_torch.kernels import paged_attention as pa
    g = torch.Generator(device=dev).manual_seed(h * 10 + dh)
    b, bs, w = 6, 16, 40
    nb = 1 + b * w
    cache = _pool(nb, bs, hkv, dh, kvdt, dev, g)
    bt = torch.randperm(nb - 1, generator=g, device=dev)[:b * w].reshape(b, w).to(torch.int32) + 1
    q = torch.randn(b, h, dh, generator=g, device=dev).to(qdt)
    qpos = torch.tensor([0, 36, 639, 299, -1, 128], dtype=torch.int32, device=dev)
    splits, kps = pa.decode_plan(w * bs)
    assert splits == 3
    n0 = pa.launches
    got = [pa.paged_attention(q, cache, bt, qpos) for _ in range(3)]
    torch.cuda.synchronize()
    assert pa.launches == n0 + 3
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    want = pa.paged_attention_plain(q.float()[:, None], cache, bt, qpos[:, None])[:, 0]
    _close_rows(got[0], want, *((1e-4, 1e-4) if qdt == torch.float32 else (2.0 ** -6, 2.0 ** -6)))
    assert torch.isfinite(got[0].float()).all()
    assert not got[0][qpos < 0].any()


def _ring(b, wr, hkv, dh, dtype, dev, g, fill):
    """Rings of ``wr`` entries holding positions ``fill[i]`` .. in ring order
    (entry p % wr), so a row filled past ``wr`` has wrapped; -1 = empty."""
    k = torch.randn(b, wr, hkv, dh, generator=g, device=dev)
    v = torch.randn(b, wr, hkv, dh, generator=g, device=dev)
    kpos = torch.full((b, wr), -1, dtype=torch.int32, device=dev)
    for i, n in enumerate(fill):
        p = torch.arange(max(0, n - wr), n, device=dev, dtype=torch.int32)
        kpos[i, p % wr] = p
    out = {"kpos": kpos}
    if dtype != torch.int8:
        out.update(k=k.to(dtype), v=v.to(dtype))
        return out
    for nm, x in (("k", k), ("v", v)):
        sc = x.abs().amax(-1).clamp(min=1e-8) / 127.0
        out[nm] = torch.round(x / sc[..., None]).to(torch.int8)
        out[nm + "_scale"] = sc
    return out


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("h,hkv,dh", [(10, 1, 256), (4, 4, 128), (8, 2, 64), (16, 2, 112)])
@pytest.mark.parametrize("sq,window", [(1, 0), (1, 48), (70, 0), (40, 48)])
def test_ring_attention_kernel(dev, sq, window, h, hkv, dh, qdt, kvdt):
    from repro_torch.kernels import prefill_attention as pf
    g = torch.Generator(device=dev).manual_seed(sq * 100 + h + window)
    b, wr = 4, 160
    fill = [300, 37 + sq, wr + sq // 2, 0]  # wrapped, short, just wrapped, empty
    ring = _ring(b, wr, hkv, dh, kvdt, dev, g, fill)
    q = torch.randn(b, sq, h, dh, generator=g, device=dev).to(qdt)
    start = torch.tensor([n - sq for n in fill], device=dev).clamp(min=0)
    qpos = (start[:, None] + torch.arange(sq, device=dev)[None]).to(torch.int32)
    qpos[3] = -1            # an idle slot
    qpos[1, -1] = -1        # a padding row
    kw = dict(k=ring["k"], v=ring["v"], kpos=ring["kpos"], window=window,
              k_scale=ring.get("k_scale"), v_scale=ring.get("v_scale"))
    n0 = pf.ring_launches
    got = pf.ring_attention(q, qpos, **kw)
    torch.cuda.synchronize()
    assert pf.ring_launches == n0 + (2 if sq == 1 else 1)  # decode: split pass + combine
    want = pf.ring_attention_plain(q.float(), ring["k"], ring["v"], qpos, ring["kpos"],
                                   window=window, k_scale=ring.get("k_scale"),
                                   v_scale=ring.get("v_scale"))
    _close_rows(got, want, *((1e-4, 1e-4) if qdt == torch.float32 else (2.0 ** -6, 2.0 ** -6)))
    assert not got[qpos < 0].any()


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("h,hkv,dh", [(10, 1, 256), (4, 4, 128), (8, 2, 64), (8, 1, 112)])
@pytest.mark.parametrize("window", [0, 2048])
@pytest.mark.parametrize("fill,qpos", [((3000, 1200), (2999, -1)),   # wrapped, idle slot
                                       ((700, 2500), (699, 2499))])  # short, just wrapped
def test_ring_decode_kernel_many_splits(dev, fill, qpos, window, h, hkv, dh, qdt, kvdt):
    """Decode (Sq = 1) at recurrentgemma-2b's ring width, WR 2304, B 2: 36
    splits of 64 entries.  Splits past a short ring's 700 entries are empty,
    and with the window the wrapped ring's entries holding positions
    696..951 (four whole splits) are masked."""
    from repro_torch.kernels import prefill_attention as pf
    g = torch.Generator(device=dev).manual_seed(h + window + fill[0])
    wr = 2304
    ring = _ring(2, wr, hkv, dh, kvdt, dev, g, fill)
    q = torch.randn(2, 1, h, dh, generator=g, device=dev).to(qdt)
    qp = torch.tensor(qpos, dtype=torch.int32, device=dev)[:, None].contiguous()
    kw = dict(k=ring["k"], v=ring["v"], kpos=ring["kpos"], window=window,
              k_scale=ring.get("k_scale"), v_scale=ring.get("v_scale"))
    assert pf.decode_splits(2, wr, hkv) == 36
    n0 = pf.ring_launches
    got = pf.ring_attention(q, qp, **kw)
    torch.cuda.synchronize()
    assert pf.ring_launches == n0 + 2
    want = pf.ring_attention_plain(q.float(), ring["k"], ring["v"], qp, ring["kpos"],
                                   window=window, k_scale=ring.get("k_scale"),
                                   v_scale=ring.get("v_scale"))
    _close_rows(got, want, *((1e-4, 1e-4) if qdt == torch.float32 else (2.0 ** -6, 2.0 ** -6)))
    assert torch.isfinite(got.float()).all()
    assert not got[qp[:, 0] < 0].any()


def _rglru_pos(b, s, dev):
    """Positions with an idle row 1, row 2 tail-padded from s // 3 and, with
    four rows or more, row 3 padded across a sub-chunk edge (step 16) and the
    kernel's panel edge (step 128)."""
    pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(b, 1)
    pos[1] = -1                              # an idle row
    if s > 1:
        pos[2, s // 3:] = -1                 # a short prompt, tail-padded
    if b > 3:
        pos[3, 12:21] = -1
        pos[3, 120:140] = -1
    return pos


def _pads_repeat(h, pos):
    """Every padding step's h equals the step before it, bitwise."""
    pad = pos[:, 1:] < 0
    assert torch.equal(h[:, 1:][pad], h[:, :-1][pad])


@pytest.mark.parametrize("scan_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w", [(8, 256, 2560), (3, 1, 200), (5, 37, 130), (4, 2, 64),
                                   (4, 16, 96), (4, 17, 130), (5, 300, 200), (4, 1000, 2560)])
def test_rglru_scan_kernel(dev, b, s, w, scan_dtype):
    """Real steps within 1e-5 of max|want| (f32 state: expf/sqrtf against
    torch's exp/sqrt, ~1 ulp a step, and the kernel's chunked order; bf16 h
    adds its own rounding of 2^-8); padding steps, idle rows and h_last of
    idle rows bitwise; h_last is the last h."""
    from repro_torch.kernels import scan_rglru as k
    g = torch.Generator(device=dev).manual_seed(b * s + w)
    log_a = -8.0 * torch.rand(b, s, w, generator=g, device=dev) * 0.5
    gx = torch.randn(b, s, w, generator=g, device=dev)
    h0 = torch.randn(b, w, generator=g, device=dev)
    pos = _rglru_pos(b, s, dev)
    n0 = k.launches
    h, h_last = k.rglru_scan(log_a, gx, h0, pos, scan_dtype=scan_dtype)
    torch.cuda.synchronize()
    assert k.launches == n0 + 1
    h_want, last_want = k.rglru_scan_plain(log_a, gx, h0, pos, scan_dtype=scan_dtype)
    assert h.dtype == scan_dtype and h_last.dtype == torch.float32
    assert torch.equal(h_last[1], h0[1])  # idle row: h0 bitwise
    assert torch.equal(h[1], h0[1].to(scan_dtype).expand(s, w))
    real = pos >= 0
    _close(h_last, last_want, 1e-5)
    _close(h[real].float(), h_want[real].float(), 1e-5 if scan_dtype == torch.float32
           else 2.0 ** -7)
    _pads_repeat(h, pos)  # the padded tail and the padding runs carry the state bitwise
    if scan_dtype == torch.float32:
        assert torch.equal(h_last, h[:, -1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,w", [(1, 130), (1, 2560), (37, 130), (37, 2560), (256, 130),
                                 (256, 2560)])
def test_rg_lru_gated_kernel(dev, s, w, dtype):
    """The fused entry (gates, scan, y = h·gelu_tanh(g)) against its plain
    version: y within 2^-7 (bf16: one rounding of h and of gelu(g)) or 1e-5
    (f32) of max|want|, h_last within 1e-5; h_last written in place into h0's
    storage, the idle row's bitwise h0; three back-to-back calls bitwise
    equal, and equal to a call that allocates h_last."""
    from repro_torch.kernels import scan_rglru as k
    b = 6
    g = torch.Generator(device=dev).manual_seed(s * 7 + w)
    ga, gxp, u, gg = (torch.randn(b, s, w, generator=g, device=dev).to(dtype)
                      for _ in range(4))
    lam = (0.7 + torch.randn(w, generator=g, device=dev)).to(dtype)
    h0 = torch.randn(b, w, generator=g, device=dev)
    pos = _rglru_pos(b, s, dev)
    y_want, last_want = k.rg_lru_gated_plain(ga, gxp, u, lam, gg, h0, pos)
    n0 = k.launches
    runs = []
    for _ in range(3):
        state = h0.clone()
        y, last = k.rg_lru_gated(ga, gxp, u, lam, gg, state, pos, h_out=state)
        assert last is state
        runs.append((y, state))
    y_new, last_new = k.rg_lru_gated(ga, gxp, u, lam, gg, h0, pos)
    torch.cuda.synchronize()
    assert k.launches == n0 + 4
    y, last = runs[0]
    for yy, ll in runs[1:] + [(y_new, last_new)]:
        assert torch.equal(yy, y) and torch.equal(ll, last)
    assert y.dtype == dtype and last.dtype == torch.float32
    _close(last, last_want, 1e-5)
    _close(y, y_want, 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)
    assert torch.equal(last[1], h0[1])


def test_griffin_session_launches_one_scan_a_recurrent_layer(dev):
    """A prefill chunk and a decode step of reduced recurrentgemma-2b (head
    dim 64, the ring kernels' smallest) on the card launch the RG-LRU kernel
    once a recurrent layer and no plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import scan_rglru as k
    from repro_torch.models import griffin
    from repro_torch.models.sessions import SessionSpec, make_session
    cfg = get_config("recurrentgemma-2b", reduced=True).replace(head_dim=64)
    params = griffin.init_lm(cfg, seed=0, device=dev)
    n_rec = sum(kind == "rec" for kind, _ in griffin._layers(cfg, params))
    sess = make_session(cfg, SessionSpec(slots=2, max_len=64, prefill_chunk=8,
                                         cache_dtype="bfloat16"), device=dev)
    state = sess.init_state()
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32, generator=g)
    pos = torch.arange(8, device=dev, dtype=torch.int32)[None].repeat(2, 1)
    pos[1, 5:] = -1
    n0, p0 = k.launches, k.plain_cuda_calls
    logits, state = sess.prefill_chunk(params, state, toks, pos)
    torch.cuda.synchronize()
    assert k.launches == n0 + n_rec
    logits, state = sess.decode_step(params, state, toks[:, :1].contiguous(),
                                     torch.tensor([8, -1], device=dev, dtype=torch.int32))
    torch.cuda.synchronize()
    assert k.launches == n0 + 2 * n_rec and k.plain_cuda_calls == p0
    assert torch.isfinite(logits).all()


def test_unembed_logits_in_f32_from_bf16_operands(dev):
    """The card's unembed (one bf16 GEMM with f32 output, no f32 copy of the
    table) against the f32 product of the same bf16 values: summation order
    only, 1e-5 of max|want|."""
    from repro_torch.models.modules import unembed
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 5, 2560, generator=g, device=dev).to(torch.bfloat16)
    table = (torch.randn(4000, 2560, generator=g, device=dev) / 50).to(torch.bfloat16)
    got = unembed(x, table, torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 4000)
    _close(got, x.float() @ table.float().T, 1e-5)


@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("modes", [
    ((8, 8, 8, 8), (20, 16, 10, 10), 16),   # llama2-7b's embed spec (V 32000, D 4096)
    ((4, 4, 2, 2), (4, 4, 4, 4), 16),       # tinyllama reduced at rank 16
    ((4, 4, 4), (8, 8, 4), 4),              # reduced, the CPU tests' spec
    ((4, 3, 2), (5, 2, 7), 3),              # d = 3, ragged: the scalar product path
    ((24,), (10,), 1),                      # d = 1
])
@pytest.mark.parametrize("t", [1, 8, 2048, 5000])
def test_tt_embed_kernel(dev, modes, cdtype, t):
    """Element by element at 1e-5 of the row max plus 1e-5 of the element:
    both are f32 sums of the same products, in other orders.  Ids out of
    range wrap once and clamp as the plain version's do; ids on every
    first-digit boundary (multiples of prod(out_modes[1:]), the id before
    each, V - 1) follow; T = 5000 is more than one wave of CTAs."""
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import tt_embed as k
    spec = TTSpec.make(0, 0, modes[2], d=len(modes[0]), in_modes=modes[0], out_modes=modes[1])
    g = torch.Generator(device=dev).manual_seed(t + spec.n_out)
    cores = [(torch.randn(s, generator=g, device=dev) / math.sqrt(s[0])).to(cdtype)
             for s in spec.core_matrix_shapes()]
    v = spec.n_out
    ids = torch.randint(0, v, (t,), generator=g, device=dev, dtype=torch.int32)
    ids[:4] = torch.tensor([-1, -v - 3, v, v + 7][:t], dtype=torch.int32)
    step = math.prod(spec.out_modes[1:])
    edges = [e for i in range(0, v, step) for e in (i, i + step - 1)] + [v - 1]
    ids[4:4 + len(edges)] = torch.tensor(edges[:max(0, t - 4)], dtype=torch.int32)
    n0 = k.launches
    got = k.tt_embed(ids, cores, spec)
    torch.cuda.synchronize()
    assert k.launches == n0 + 1 and got.dtype == torch.float32 and got.shape == (t, spec.n_in)
    _close_rows(got, k.tt_embed_plain(ids, cores, spec), 1e-5, 1e-5)
    two_d = k.tt_embed(ids.reshape(1, t).long(), cores, spec)
    assert two_d.shape == (1, t, spec.n_in) and torch.equal(two_d[0], got)


def _wkv_inputs(dev, b, s, h, hd, in_dtype, state_dtype, seed):
    """Slot 1 idle, slot 2 tail-padded (S > 1), slot 0's decays below the
    prefill floor (w ~ 1e-3 < e^-4.9), the rest in (0.5, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(b, s, h, hd, generator=g, device=dev).to(in_dtype) for _ in range(3))
    w = 0.5 + 0.499 * torch.rand(b, s, h, hd, generator=g, device=dev)
    w[0] = 5e-4 + 1.5e-3 * torch.rand(s, h, hd, generator=g, device=dev)
    u = 0.5 * torch.randn(h, hd, generator=g, device=dev)
    state0 = torch.randn(b, h, hd, hd, generator=g, device=dev)
    scale0 = None
    if state_dtype == torch.int8:
        scale0 = state0.abs().amax(dim=(-2, -1)).clamp(min=1e-8) / 127.0
        state0 = torch.round(state0 / scale0[..., None, None]).to(torch.int8)
    pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(b, 1) + 11
    pos[1] = -1
    if s > 1:
        pos[2, s // 3:] = -1
    return r, k, v, w, u, state0, pos, scale0


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hd", [(8, 256, 64, 64), (8, 1, 64, 64), (3, 20, 4, 16),
                                      (3, 1, 4, 16), (4, 37, 2, 32), (3, 15, 4, 64),
                                      (3, 16, 4, 32), (3, 17, 8, 64), (3, 256, 4, 16)])
def test_wkv_scan_kernel(dev, b, s, h, hd, in_dtype, state_dtype):
    """y and an f32 state within 1e-4 of max|want| (S > 1: both take the
    chunked form, the kernel its products in 3xTF32; S = 1: the exact step;
    f32 rounding only); an int8 payload within one step, its scale within
    1e-5 relative; the idle slot's state (and scale) bitwise; the padded
    slot's state bitwise equal to the kernel's over its real prefix alone."""
    from repro_torch.kernels import scan_wkv as k
    r, kk, v, w, u, state0, pos, scale0 = _wkv_inputs(dev, b, s, h, hd, in_dtype, state_dtype,
                                                      b * s + hd)
    n0 = k.launches
    y, st, sc = k.wkv_scan(r, kk, v, w, u, state0, pos, state_scale=scale0)
    torch.cuda.synchronize()
    assert k.launches == n0 + 1 and y.dtype == torch.float32 and st.dtype == state_dtype
    yw, stw, scw = k.wkv_scan_plain(r, kk, v, w, u, state0, pos, state_scale=scale0)
    _close(y, yw, 1e-4)
    assert torch.equal(st[1], state0[1])
    if state_dtype == torch.int8:
        assert (st.int() - stw.int()).abs().max().item() <= 1
        assert ((sc - scw).abs() / scw).max().item() <= 1e-5
        assert torch.equal(sc[1], scale0[1])
    else:
        _close(st, stw, 1e-4)
    n = s // 3
    if s > 1 and n > 1 and state_dtype == torch.float32:
        sl = slice(2, 3)
        _, st_n, _ = k.wkv_scan(r[sl, :n].contiguous(), kk[sl, :n].contiguous(),
                                v[sl, :n].contiguous(), w[sl, :n].contiguous(), u,
                                state0[sl].contiguous(), pos[sl, :n].contiguous())
        assert torch.equal(st[2], st_n[0])


def test_tied_tt_unembed_on_card(dev):
    """A tied TT embedding's logits (llama2-7b's embed spec, bf16 cores, f32
    x) through the tt_linear kernel against the plain version: f32 stages in
    both, 1e-4 of max|want|."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import tt_linear as k
    from repro_torch.models.modules import embed_spec, init_embed
    from repro_torch.models.transformer import logits_from_hidden
    cfg = get_config("llama2-7b")
    cfg = cfg.replace(tie_embeddings=True, ttd=dataclasses.replace(cfg.ttd, embed=True))
    g = torch.Generator(device=dev).manual_seed(7)
    params = {"embed": init_embed(cfg, torch.bfloat16, generator=g, device=dev)}
    x = torch.randn(2, 5, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    n0 = k.launches
    got = logits_from_hidden(params, cfg, x)
    torch.cuda.synchronize()
    assert k.launches == n0 + embed_spec(cfg).tt.d
    with dispatch.force_plain():
        want = logits_from_hidden(params, cfg, x)
    assert got.dtype == torch.float32 and got.shape == (2, 5, cfg.vocab_size)
    _close(got, want, 1e-4)


def _ring_scenario(kind, wr, sq, dev):
    """kpos (4, wr) and qpos (4, sq) for the flash tile's edge cases: a ring
    wrapped twice, a ring whose middle tiles are empty, a short ring whose
    later tiles are empty, and an all-padding sequence; ``kind`` "paged"
    gives the same query positions over a paged context instead."""
    fill = [2 * wr + 77, wr + 40, 45, 0]
    kpos = torch.full((4, wr), -1, dtype=torch.int32)
    for i, n in enumerate(fill):
        p = torch.arange(max(0, n - wr), n, dtype=torch.int32)
        kpos[i, p % wr] = p
    kpos[1, 64:192] = -1  # two interior tiles hold nothing
    qpos = torch.full((4, sq), -1, dtype=torch.int32)
    for i, n in enumerate(fill[:3]):
        m = min(n, sq)
        qpos[i, :m] = torch.arange(n - m, n, dtype=torch.int32)
    qpos[0, 5] = -1  # a padding row inside a live tile
    return kpos.to(dev), qpos.to(dev)


@pytest.mark.parametrize("kvdt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("h,hkv,dh", [(10, 1, 256), (16, 1, 128), (4, 4, 64), (6, 2, 256),
                                      (64, 8, 112), (8, 8, 112)])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_flash_tile_edges(dev, layout, window, h, hkv, dh, kvdt):
    """The bf16 flash tile of both layouts (Sq 70: not a multiple of any row
    tile) against the plain version, element by element in bf16: wrapped
    rings, interior empty tiles, a window edge inside a tile (window 100),
    padding rows and an all-padding sequence (zero output), head dims 64,
    112, 128 and 256, bf16 and int8 K/V.  One launch a call."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as pf
    g = torch.Generator(device=dev).manual_seed(h * 7 + dh + window)
    b, sq, wr = 4, 70, 384
    kpos, qpos = _ring_scenario(layout, wr, sq, dev)
    q = torch.randn(b, sq, h, dh, generator=g, device=dev).to(torch.bfloat16)
    if layout == "ring":
        ring = _ring(b, wr, hkv, dh, kvdt, dev, g, [0] * b)
        kw = dict(k=ring["k"], v=ring["v"], kpos=kpos, window=window,
                  k_scale=ring.get("k_scale"), v_scale=ring.get("v_scale"))
        n0 = pf.ring_launches
        got = pf.ring_attention(q, qpos, **kw)
        torch.cuda.synchronize()
        assert pf.ring_launches == n0 + 1
        want = pf.ring_attention_plain(q.float(), ring["k"], ring["v"], qpos, kpos,
                                       window=window, k_scale=ring.get("k_scale"),
                                       v_scale=ring.get("v_scale"))
    else:
        bs, w = 16, 2 * wr // 16 + 8
        nb = 1 + b * w
        cache = _pool(nb, bs, hkv, dh, kvdt, dev, g)
        bt = torch.randperm(nb - 1, generator=g, device=dev)[:b * w].reshape(b, w)
        bt = (bt + 1).to(torch.int32)
        n0 = pf.launches
        got = pf.prefill_attention(q, qpos, cache=cache, block_tables=bt, window=window)
        torch.cuda.synchronize()
        assert pf.launches == n0 + 1
        want = pa.paged_attention_plain(q.float(), cache, bt, qpos, window=window)
    _close_rows(got, want, 2.0 ** -6, 2.0 ** -6)
    assert not got[qpos < 0].any()
    walked, total = pf.tiles_walked(qpos, h, hkv, None if layout == "paged" else kpos,
                                    window=window)
    assert walked < total or (layout == "paged" and not window)


@pytest.mark.parametrize("modes,rank", [(((2,) * 9, (2,) * 9), 4),    # d = 9
                                        (((16, 8, 8), (8, 8, 16)), 48)])  # rank 48
def test_tt_linear_past_fused_limits(dev, modes, rank):
    """bf16 specs past the fused kernel's d <= 8 and ranks <= 32 take the
    staged kernel: a launch per core, against the plain version at 2e-2 of
    max|want| (bf16 output rounding)."""
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import tt_linear as k
    spec = TTSpec.make(0, 0, rank, d=len(modes[0]), in_modes=modes[0], out_modes=modes[1])
    assert not k.fused_route(spec, torch.bfloat16, [torch.bfloat16] * spec.d)
    g = torch.Generator(device=dev).manual_seed(rank)
    cores = [(torch.randn(s, generator=g, device=dev) / math.sqrt(s[0])).to(torch.bfloat16)
             for s in spec.core_matrix_shapes()]
    x = torch.randn(37, spec.n_in, generator=g, device=dev).to(torch.bfloat16)
    res = torch.randn(37, spec.n_out, generator=g, device=dev).to(torch.bfloat16)
    n0 = k.launches
    got = k.tt_linear(x, cores, spec, residual=res, activation="silu")
    torch.cuda.synchronize()
    assert k.launches == n0 + spec.d
    want = k.tt_linear_ref(x.float(), [c.float() for c in cores], spec, residual=res.float(),
                           activation="silu")
    _close(got, want, 2e-2)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_make_session_refuses_on_card(dev, case):
    """Each config past a hand kernel's limit is refused by make_session on
    the card, before any state is built, naming the kernel and its limit."""
    from repro_torch.models.sessions import SessionSpec, make_session
    cfg, backend, limit = refused_config(case)
    with pytest.raises(ValueError, match=re.escape(limit)):
        make_session(cfg, SessionSpec(slots=2, max_len=64), backend=backend, device=dev)


# ---------------------------------------------------------------------------
# The compression pipeline on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("modes", [
    ((16, 8, 8, 4), (4, 8, 8, 16), 16),     # chatglm3 attn_o
    ((8, 8, 8, 8), (4, 4, 8, 107), 16),     # chatglm3 gate/up (ragged 107)
    ((107, 8, 4, 4), (8, 8, 8, 8), 16),     # chatglm3 down
    ((8, 4, 2), (3, 5, 7), 4),              # ranks not a multiple of 8: scalar loads
    ((16, 8, 8), (8, 8, 16), 32),
])
@pytest.mark.parametrize("b", [1, 8, 130])
def test_tt_linear_f32_cores_take_the_fused_kernel(dev, modes, b):
    """f32 cores with bf16 x (what compress_model writes) take the fused
    route: 2 launches, no staged launch, and the same bits as the same cores
    rounded to bf16 first (the operator pass rounds each element as it loads
    it, as the plain version rounds each core); against the plain version at
    the bf16 tolerance of test_tt_linear_kernel."""
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import tt_linear as k
    spec = TTSpec.make(0, 0, modes[2], d=len(modes[0]), in_modes=modes[0], out_modes=modes[1])
    g = torch.Generator(device=dev).manual_seed(b)
    cores = [torch.randn(s, generator=g, device=dev) / math.sqrt(s[0])
             for s in spec.core_matrix_shapes()]
    x = torch.randn(b, spec.n_in, generator=g, device=dev).to(torch.bfloat16)
    res = torch.randn(b, spec.n_out, generator=g, device=dev).to(torch.bfloat16)
    n0, s0 = k.launches, k.staged_launches
    got = k.tt_linear(x, cores, spec, residual=res, activation="silu")
    torch.cuda.synchronize()
    assert (k.launches, k.staged_launches) == (n0 + 2, s0)
    same = k.tt_linear(x, [c.to(torch.bfloat16) for c in cores], spec, residual=res,
                       activation="silu")
    assert torch.equal(got, same)
    want = k.tt_linear_ref(x, cores, spec, residual=res, activation="silu")
    _close(got, want, 2e-2)


@pytest.mark.parametrize("shape,group", [((13696, 4096), 128), ((4096, 13696), 128),
                                         ((300, 256), 32)])
def test_quantize_int4_on_card_equals_the_cpu(dev, shape, group):
    """Bitwise, packed nibbles and bf16 scales: the scale is amax / 7 by a
    true division on both (a division by the Python scalar 7 is a multiply
    by its reciprocal on CUDA and moved nibbles across a rounding edge)."""
    from repro_torch.core.quant import quantize_int4
    g = torch.Generator(device=dev).manual_seed(shape[0])
    w = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16).float()
    got, want = quantize_int4(w, group), quantize_int4(w.cpu(), group)
    for leaf in ("qweight", "scales"):
        assert torch.equal(got[leaf].cpu(), want[leaf]), leaf


def _planted_weight(spec, g, dev):
    """A weight of TT rank ``spec.ranks`` (bf16 cores), f64, plus 1e-3 noise."""
    from repro_torch.core import ttd
    mats = [(torch.randn(s, generator=g, device=dev) / math.sqrt(s[0])).to(torch.bfloat16)
            for s in spec.core_matrix_shapes()]
    w = ttd.tt_reconstruct(ttd.matrices_to_cores([m.double() for m in mats], spec), spec)
    w = w / w.square().mean().sqrt()
    return w + 1e-3 * torch.randn(w.shape, generator=g, device=dev, dtype=torch.float64)


@pytest.mark.parametrize("method", ["svd", "gram", "auto"])
@pytest.mark.parametrize("modes", [
    ((8, 4, 4), (9, 4, 5), 6),
    ((4, 4, 4), (2, 4, 8), 5),
    ((8, 8, 8, 8), (4, 4, 8, 107), 16),     # chatglm3 gate at full width
])
def test_tt_svd_on_card_matches_the_cpu(dev, modes, method):
    """TT-SVD in f64 on the card (cuSOLVER) against the CPU (LAPACK) on a
    planted weight, gauge-invariantly: reconstructions within 1e-8."""
    from repro_torch.core import ttd
    spec = ttd.TTSpec.make(0, 0, modes[2], d=len(modes[0]), in_modes=modes[0],
                           out_modes=modes[1])
    w = _planted_weight(spec, torch.Generator(device=dev).manual_seed(3), dev)
    got = ttd.tt_reconstruct(ttd.tt_svd(w, spec, method=method), spec)
    assert got.is_cuda
    wc = w.cpu()
    want = ttd.tt_reconstruct(ttd.tt_svd(wc, spec, method=method), spec)
    assert float(torch.linalg.norm(got.cpu() - want) / torch.linalg.norm(want)) <= 1e-8
    assert float(torch.linalg.norm(want - wc) / torch.linalg.norm(wc)) <= 2e-3


def test_compressed_chatglm3_on_card_launches_no_staged_tt_linear(dev, tmp_path):
    """ChatGLM3-6B at full width, 2 layers (int4 block 0, TT block 1): dense
    bf16 params made on the card, compressed there (int4 leaves bitwise the
    CPU's, TT reconstructions within 1e-6 of the CPU's f32 cores), saved and
    loaded back onto the card bitwise, then served: the TT linears take the
    fused kernel on their f32 cores (no staged launch), no plain version
    runs on CUDA, and every request finishes."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import compress, ttd
    from repro_torch.kernels import int4_matmul, tt_linear
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.steps import serve_config_of
    cfg = serve_config_of(get_config("chatglm3-6b")).replace(n_layers=2)
    cfg = cfg.replace(ttd=dataclasses.replace(cfg.ttd, first_tt_block=1))
    dcfg = cfg.replace(ttd=dataclasses.replace(cfg.ttd, enabled=False),
                       quant=dataclasses.replace(cfg.quant, enabled=False))
    dense = transformer.init_lm(dcfg, seed=0, device=dev)
    tree = compress.compress_model(dense, dcfg, cfg)
    cpu = compress.compress_model(_to_cpu(dense), dcfg, cfg)
    assert tree["segments"][0][0]["mlp"]["gate"]["qweight"].device.type == dev.type
    for name in ("qweight", "scales"):
        assert torch.equal(tree["segments"][0][0]["mlp"]["down"][name].cpu(),
                           cpu["segments"][0][0]["mlp"]["down"][name])
        assert torch.equal(tree["segments"][1][0]["attn"]["wq"][name].cpu(),
                           cpu["segments"][1][0]["attn"]["wq"][name])
    specs = transformer.make_block_specs(cfg, True)
    for nm, sp in specs.mlp:
        a, b = (ttd.tt_reconstruct(ttd.matrices_to_cores(
            [c.double().cpu() for c in t["segments"][1][0]["mlp"][nm]["cores"]], sp.tt), sp.tt)
            for t in (tree, cpu))
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-6, nm
    del dense, cpu
    compress.save_compressed(tmp_path, tree, cfg)
    params, cfg2 = compress.load_compressed(tmp_path, device=dev)
    assert cfg2 == cfg
    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.convert import params_to_jax
    for (na, a), (nb, b) in zip(_flatten_with_paths(params_to_jax(params, cfg)),
                                _flatten_with_paths(params_to_jax(tree, cfg))):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b), na
    eng = Engine(cfg, params, slots=2, max_len=128, block_size=16, prefill_chunk=32,
                 cache_dtype="bfloat16", device=dev)
    counts = (tt_linear.launches, tt_linear.staged_launches, tt_linear.plain_cuda_calls,
              int4_matmul.launches, int4_matmul.plain_cuda_calls)
    reqs = [eng.submit(list(range(3, 3 + n)), max_tokens=4) for n in (40, 9)]
    eng.run()
    torch.cuda.synchronize()
    assert all(len(r.out_tokens) == 4 for r in reqs)
    assert tt_linear.launches > counts[0] and int4_matmul.launches > counts[3]
    assert (tt_linear.staged_launches, tt_linear.plain_cuda_calls,
            int4_matmul.plain_cuda_calls) == (counts[1], counts[2], counts[4])


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# ---------------------------------------------------------------------------
# Mixture-of-Experts: the grouped tt_linear, the f32 router, one MoE layer
# ---------------------------------------------------------------------------
GROUPED_ROUTINGS = {
    "spread": lambda e, r, g: torch.randint(0, e, (r,), generator=g, device=g.device),
    "one expert": lambda e, r, g: torch.full((r,), e - 1, device=g.device),
    "most empty": lambda e, r, g: torch.randint(0, 2, (r,), generator=g, device=g.device) * 3,
}


GROUPED_SPECS = [
    (((12, 8, 8, 8), (16, 16, 8, 8), 16), 8),    # mixtral expert gate/up
    (((16, 16, 8, 8), (12, 8, 8, 8), 16), 8),    # mixtral expert down
    (((14, 8, 8, 8), (8, 8, 8, 4), 16), 384),    # kimi-k2 expert gate/up
    (((8, 4, 2), (3, 5, 7), 4), 5),              # ranks not a multiple of 8: scalar loads
]
KIMI_DOWN = (((8, 8, 8, 4), (14, 8, 8, 8), 16), 384)  # kimi-k2 expert down


@pytest.mark.parametrize("modes,e", GROUPED_SPECS)
@pytest.mark.parametrize("routing", list(GROUPED_ROUTINGS))
@pytest.mark.parametrize("rows", [1, 16, 300])
@pytest.mark.parametrize("core_dtype", [torch.bfloat16, torch.float32])
def test_tt_linear_grouped_kernel(dev, modes, e, routing, rows, core_dtype):
    """Rows sorted by expert through the grouped kernel (2 launches, counted
    as grouped) against its plain version, the experts' tt_linear_ref, at the
    bf16 tolerance of test_tt_linear_kernel; experts without rows, all rows
    on one expert, 300 rows over mixtral's 8 experts (past the wgmma
    threshold) and f32 cores (rounded to bf16 as they load) included; two
    calls give the same bits."""
    _grouped_case(dev, modes, e, routing, rows, core_dtype)


def test_tt_linear_grouped_kimi_down_and_decode(dev):
    """kimi-k2's expert down spec at E 384 in every case of
    test_tt_linear_grouped_kernel, and a decode routing (64 rows over 384
    experts) at both kimi specs."""
    for routing in GROUPED_ROUTINGS:
        for core_dtype in (torch.bfloat16, torch.float32):
            for rows in (1, 16, 64, 300):
                _grouped_case(dev, *KIMI_DOWN, routing, rows, core_dtype)
            _grouped_case(dev, *GROUPED_SPECS[2], routing, 64, core_dtype)


def test_tt_linear_grouped_wgmma_route(dev):
    """Each served expert spec at the wgmma contraction's threshold (4 rows
    an expert: mixtral 32 rows, kimi 1536) and at 2048 tokens' rows, bf16
    cores, rows spread and on one expert; x not 16-byte aligned takes the
    decode tiles."""
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import tt_linear as k
    for modes, e in GROUPED_SPECS[:3] + [KIMI_DOWN]:
        spec = TTSpec.make(0, 0, modes[2], d=len(modes[0]), in_modes=modes[0],
                           out_modes=modes[1])
        for routing in ("spread", "one expert"):
            for rows in (k.GROUPED_WGMMA_MIN_ROWS * e, 2048 * (2 if e == 8 else 8)):
                assert k.grouped_plan(spec, rows, e).route == "wgmma"
                _grouped_case(dev, modes, e, routing, rows, torch.bfloat16)
            rows = k.GROUPED_WGMMA_MIN_ROWS * e
            assert k.grouped_plan(spec, rows, e, x_aligned=False).route == "decode tiles"
            _grouped_case(dev, modes, e, routing, rows, torch.bfloat16, x_offset=1)


def _grouped_case(dev, modes, e, routing, rows, core_dtype, x_offset=0):
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import tt_linear as k
    spec = TTSpec.make(0, 0, modes[2], d=len(modes[0]), in_modes=modes[0], out_modes=modes[1])
    g = torch.Generator(device=dev).manual_seed(rows)
    cores = [(torch.randn(e, *s, generator=g, device=dev) / math.sqrt(s[0])).to(core_dtype)
             for s in spec.core_matrix_shapes()]
    eid = torch.sort(GROUPED_ROUTINGS[routing](e, rows, g).long()).values
    offsets = torch.zeros(e + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(eid, minlength=e), 0)
    x = torch.randn(rows * spec.n_in + x_offset, generator=g, device=dev).to(torch.bfloat16)
    x = x[x_offset:].view(rows, spec.n_in)  # x_offset 1: contiguous, not 16-byte aligned
    n0, g0, p0 = k.launches, k.grouped_launches, k.plain_cuda_calls
    got = k.tt_linear_grouped(x, offsets, cores, spec, activation="silu")
    torch.cuda.synchronize()
    assert (k.launches, k.grouped_launches, k.plain_cuda_calls) == (n0 + 2, g0 + 2, p0)
    want = k.tt_linear_grouped_ref(x, offsets, cores, spec, activation="silu")
    _close(got, want, 2e-2)
    again = k.tt_linear_grouped(x, offsets, cores, spec, activation="silu")
    assert torch.equal(got, again)  # no atomics: the same bits every call


def test_tt_linear_grouped_refuses_what_it_cannot_take(dev):
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import tt_linear as k
    spec = TTSpec.make(0, 0, 48, d=3, in_modes=(16, 8, 8), out_modes=(8, 8, 16))
    cores = [torch.zeros(2, *s, device=dev, dtype=torch.bfloat16)
             for s in spec.core_matrix_shapes()]
    offsets = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no grouped staged"):
        k.tt_linear_grouped(torch.zeros(2, spec.n_in, device=dev, dtype=torch.bfloat16),
                            offsets, cores, spec)


@pytest.mark.parametrize("b,k_in,m,group", [
    (8, 6144, 8, 128), (1024, 6144, 8, 128), (2048, 6144, 8, 128),   # mixtral router
    (8, 7168, 384, 128), (2048, 7168, 384, 128),                      # kimi-k2 router
    (37, 256, 100, 32), (1, 64, 3, 16)])
def test_int4_matmul_f32_activations(dev, b, k_in, m, group):
    """f32 x takes the f32 route (one launch: TF32 tiles whose K slices are
    summed in their cluster) and returns f32, against the plain version at
    1e-4 of max|want| (products within ~2^-22, sums in another order); the
    epilogue in f32."""
    from repro_torch.core.quant import quantize_int4
    from repro_torch.kernels import int4_matmul as k
    g = torch.Generator(device=dev).manual_seed(b + m)
    q = quantize_int4(torch.randn(m, k_in, generator=g, device=dev) / math.sqrt(k_in), group)
    x = torch.randn(b, k_in, generator=g, device=dev)
    res = torch.randn(b, m, generator=g, device=dev)
    bias = torch.randn(m, generator=g, device=dev)
    for kw in ({}, dict(bias=bias, activation="silu"), dict(residual=res, scale=bias)):
        n0, f0 = k.launches, k.f32_launches
        got = k.int4_matmul(x, q["qweight"], q["scales"], group, **kw)
        assert got.dtype == torch.float32
        assert (k.launches, k.f32_launches) == (n0 + 1, f0 + 1)
        want = k.int4_matmul_ref(x, q["qweight"], q["scales"], group, **kw)
        _close(got, want, 1e-4)


def _moe_layer(arch, dev, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models import moe, transformer
    from repro_torch.serve.steps import serve_config_of
    cfg = serve_config_of(get_config(arch))
    specs = transformer.make_block_specs(cfg, True).moe
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, specs, moe.init_moe(cfg, specs, torch.bfloat16, generator=gen, device=dev)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("t", [8, 600])
def test_apply_moe_full_width_layer(dev, arch, t):
    """One MoE layer at full published width (serving config: int4 router on
    f32 activations, bf16 TT experts) through the kernels against the plain
    versions on the card.  Routes are compared first: the router's f32 sums
    differ in order only, so a token may change experts only on a near-tie
    (its plain probabilities within 1e-5); tokens routed alike are held at
    3e-2 of max|want| (bf16: the plain version rounds each TT stage, the
    kernel its operators and its one intermediate)."""
    from repro_torch.kernels import dispatch, int4_matmul, tt_linear
    from repro_torch.models import moe
    cfg, specs, p = _moe_layer(arch, dev)
    g = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(1, t, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    c0 = (tt_linear.grouped_launches, int4_matmul.f32_launches, tt_linear.plain_cuda_calls,
          int4_matmul.plain_cuda_calls)
    y, aux = moe.apply_moe(p, x, specs, cfg, torch.bfloat16)
    torch.cuda.synchronize()
    # gate, up and down: 2 launches each; the router: 1
    assert (tt_linear.grouped_launches, int4_matmul.f32_launches, tt_linear.plain_cuda_calls,
            int4_matmul.plain_cuda_calls) == (c0[0] + 6, c0[1] + 1, c0[2], c0[3])
    _, gates, eids = moe.route(p, x[0], specs, cfg)
    with dispatch.force_plain():
        yw, auxw = moe.apply_moe(p, x, specs, cfg, torch.bfloat16)
        probs_w, gates_w, eids_w = moe.route(p, x[0], specs, cfg)
    same = (eids.sort(-1).values == eids_w.sort(-1).values).all(-1)  # the same experts
    for i in torch.nonzero(~same)[:, 0].tolist():
        diff = set(eids[i].tolist()) ^ set(eids_w[i].tolist())
        kth = probs_w[i].sort(descending=True).values[cfg.experts_per_token - 1]
        assert all(abs(probs_w[i, j] - kth) <= 1e-5 for j in diff), i
    assert int(same.sum()) >= 0.99 * t
    torch.testing.assert_close(gates[same].sort(-1).values, gates_w[same].sort(-1).values,
                               rtol=1e-5, atol=1e-6)
    _close(y[0][same], yw[0][same], 3e-2)
    assert torch.isfinite(y).all() and y.shape == x.shape
    assert abs(float(aux) - float(auxw)) <= 1e-4 * abs(float(auxw))


def test_moe_sessions_on_card(dev):
    """mixtral-8x22b's serving config is accepted on the card (the ring
    backend), and so is kimi-k2-1t-a32b's (the paged backend: its head_dim
    112 is one the attention kernels take).  The single-sequence path
    (``models.api.Model``) takes qwen2-vl-7b's serving config on the card
    (the solo backend), and on every family at reduced width (int4 group 32)
    its prefill and three decode steps through the kernels hold the same
    calls under ``force_plain()`` at 1e-3 of max|want| in f32 (the MoE
    configs in bf16 at 2e-2: the grouped tt_linear takes bf16 activations).
    Its ``flash_attention`` at a long context (qwen2-vl-7b's 28 heads of 128
    over 4 KV heads, 32768 tokens, causal, bf16) keeps one (q_block,
    kv_block) tile of scores live: the call's peak stays under 2 GiB above
    its inputs (a key block's scores for every query block at once would be
    3.5 GiB), and 64 of its rows hold ``attention_dense`` on the same rows
    at atol = rtol = 2^-6."""
    from repro_torch.config import QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import build_model
    from repro_torch.models.sessions import SessionSpec, make_session
    from repro_torch.serve.steps import serve_config_of
    spec = SessionSpec(slots=1, max_len=64, cache_dtype="bfloat16")
    sess = make_session(serve_config_of(get_config("mixtral-8x22b")), spec, device=dev)
    assert sess.backend == "ring"
    sess = make_session(serve_config_of(get_config("kimi-k2-1t-a32b")), spec, device=dev)
    assert sess.backend == "paged"
    qwen = serve_config_of(get_config("qwen2-vl-7b"))
    dispatch.check_card_support(qwen, dev, "solo")
    build_model(qwen, device=dev)
    g = np.random.default_rng(0)
    for arch in ("tinyllama-1.1b", "mixtral-8x22b", "kimi-k2-1t-a32b", "recurrentgemma-2b",
                 "rwkv6-7b", "whisper-base", "chatglm3-6b", "qwen2-vl-7b"):
        cfg = get_config(arch, reduced=True)
        cdt = "bfloat16" if cfg.family == "moe" else "float32"
        cfg = cfg.replace(compute_dtype=cdt, param_dtype="float32",
                          quant=QuantConfig(enabled=True, bits=4, group_size=32))
        model = build_model(cfg, device=dev)
        params = model.init(0, device=dev)
        s = 40
        batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab_size, (1, s))
                                            .astype(np.int32)).to(dev)}
        if cfg.pos_type == "mrope":
            batch["positions"] = torch.arange(s, device=dev).expand(3, 1, s).contiguous()
        if cfg.family == "encdec":
            batch["enc_frames"] = torch.randn(1, cfg.enc_len, cfg.d_model, device=dev)
        outs = []
        for plain in (False, True):
            with dispatch.force_plain() if plain else contextlib.nullcontext():
                logits, cache = model.prefill(params, batch, cache_dtype=torch.float32,
                                              max_len=s + 3)
                rows = [logits]
                for t in range(3):
                    dec = {"tokens": batch["tokens"][:, t:t + 1]}
                    if cfg.pos_type == "mrope":
                        dec["positions"] = torch.full((3, 1, 1), s + t, device=dev)
                    logits, cache = model.decode_step(params, cache, dec, s + t)
                    rows.append(logits)
            outs.append(torch.cat(rows))
        _close(outs[0], outs[1], 2e-2 if cdt == "bfloat16" else 1e-3)
    from repro_torch.models.modules import attention_dense, flash_attention
    n = 32768
    q = torch.randn(1, n, 28, 128, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(1, n, 4, 128, device=dev, dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    o = flash_attention(q, k, v, qpos=pos, kpos=pos, causal=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < 2 * 2**30, f"flash_attention at {n} tokens peaked {peak / 2**30:.2f} GiB"
    rows = torch.from_numpy(np.sort(g.choice(n, 64, replace=False))).to(dev)
    want = attention_dense(q[:, rows], k, v, qpos=pos[rows], kpos=pos, causal=True)
    _close_rows(o[:, rows], want, 2.0 ** -6, 2.0 ** -6)


# ---------------------------------------------------------------------------
# The serving front end: dispatch-ahead on one stream, seeded sampling
# ---------------------------------------------------------------------------
def _llama_two_layers(dev):
    """llama2-7b's serving config at full width, 2 layers (int4 block 0, TT
    block 1), random params from seed 0 on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.steps import serve_config_of
    cfg = serve_config_of(get_config("llama2-7b")).replace(n_layers=2)
    cfg = cfg.replace(ttd=dataclasses.replace(cfg.ttd, first_tt_block=1))
    return cfg, transformer.init_lm(cfg, seed=0, device=dev)


def _burst_async(fe, prompts, max_tokens):
    import asyncio

    async def go():
        hs = [fe.submit(p, max_tokens=max_tokens) for p in prompts]
        await fe.drain()
        return [h.out_tokens for h in hs]
    return asyncio.run(go())


def test_ahead_dispatch_issues_no_sync(dev):
    """Every ahead dispatch (tick N's token copy to pinned memory and tick
    N+1's launch from tick N's device tokens) runs under
    ``set_sync_debug_mode("error")`` without raising, and the AsyncEngine's
    tokens, with dispatch-ahead on and off, equal the Engine's on a burst."""
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.frontend import AsyncEngine
    cfg, params = _llama_two_layers(dev)
    kw = dict(slots=4, max_len=256, block_size=16, prefill_chunk=64, prefill_batch=2,
              cache_dtype="bfloat16", device=dev)
    g = np.random.default_rng(3)
    prompts = [[int(t) for t in g.integers(0, cfg.vocab_size, n)] for n in (70, 5, 130, 33, 9)]
    eng = Engine(cfg, params, **kw)
    reqs = [eng.submit(p, max_tokens=12) for p in prompts]
    eng.run()
    want = [r.out_tokens for r in reqs]
    for ahead in (True, False):
        fe = AsyncEngine(cfg, params, dispatch_ahead=ahead, **kw)
        orig, checked = fe._dispatch_ahead, []

        def under_error_mode(plan2, tok_col, orig=orig, checked=checked):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(plan2, tok_col)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                checked.append(1)
        fe._dispatch_ahead = under_error_mode
        assert _burst_async(fe, prompts, 12) == want
        assert len(checked) == fe.stats["ahead_ticks"]
        assert (fe.stats["ahead_ticks"] > 0) == ahead
        assert fe.engine.num_free_blocks == fe.engine.manager.num_blocks - 1


def test_seeded_sampling_on_card(dev):
    """The batched draw on the card: reproducible from its seed, the draw
    ``torch.multinomial`` makes, free of host syncs, ``top_k=1`` equal to
    greedy; in the Engine, the same seed gives the same tokens with
    dispatch-ahead on and off."""
    from repro_torch.serve import steps
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.frontend import AsyncEngine
    logits = torch.randn(8, 32000, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    gens = [torch.Generator(device=dev).manual_seed(7) for _ in range(3)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = steps.sample_tokens(logits, gens[0], temperature=0.8, top_k=50)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b = steps.sample_tokens(logits, gens[1], temperature=0.8, top_k=50)
    scaled = logits / 0.8
    scaled = scaled.masked_fill(scaled < torch.topk(scaled, 50).values[:, -1:], float("-inf"))
    c = torch.multinomial(torch.softmax(scaled, -1), 1, generator=gens[2]).to(torch.int32)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(steps.sample_tokens(logits, gens[0], top_k=1), steps.greedy_tokens(logits))
    cfg, params = _llama_two_layers(dev)
    kw = dict(slots=2, max_len=128, block_size=16, prefill_chunk=32, cache_dtype="bfloat16",
              device=dev)
    prompts = [list(range(3, 40)), list(range(100, 109)), list(range(7, 20))]

    def run(**sample):
        eng = Engine(cfg, params, **kw, **sample)
        reqs = [eng.submit(p, max_tokens=10) for p in prompts]
        eng.run()
        return [r.out_tokens for r in reqs]

    sampled = dict(greedy=False, temperature=0.9, top_k=40, seed=5)
    first = run(**sampled)
    assert run(**sampled) == first
    assert run(greedy=False, top_k=1, seed=9) == run()
    for ahead in (True, False):
        fe = AsyncEngine(cfg, params, dispatch_ahead=ahead, **kw, **sampled)
        assert _burst_async(fe, prompts, 10) == first


def _grads_through(fn, ins, spec, act, epi_names, keep, seed):
    """y = fn(x, cores, spec, activation, epilogue operands) on fresh leaves
    of ``ins`` (x, the cores, then the operands named ``epi_names``) and
    their gradients for a seeded dy (times ``keep``)."""
    live = [t.clone().requires_grad_() for t in ins]
    y = fn(live[0], live[1:1 + spec.d], spec, activation=act,
           **dict(zip(epi_names, live[1 + spec.d:])))
    dy = torch.randn(y.shape, generator=torch.Generator(device=y.device).manual_seed(seed),
                     device=y.device).to(y.dtype)
    return y, torch.autograd.grad(y, live, dy * keep)


def test_tt_linear_backward_on_card(dev):
    """The tt_linear op's backward on the card (dx on the transposed train
    through the hand kernel, the cores' GEMMs, the epilogue's grads, u
    recomputed by a kernel call) against autograd of the plain version on
    the same inputs, for tinyllama-1.1b's and whisper-base's specs, the
    fused route (bf16 x, f32 cores: 2e-2 of max|plain|) and the staged one
    (f32 x: 1e-4), every activation with scale and bias, and the residual.
    Under grad mode the forward is bitwise the inference output; the
    backward's launches are counted apart and the plain version is never
    handed a CUDA tensor outside the reference call."""
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import tt_linear as k
    from repro_torch.kernels.epilogue import ACT_CODES
    g = torch.Generator(device=dev).manual_seed(28)
    specs = [TTSpec.make(2048, 2048, 16), TTSpec.make(2048, 5632, 16),
             TTSpec.make(5632, 2048, 16), TTSpec.make(512, 2048, 16, d=3)]
    epis = [dict(residual=True)] + [dict(activation=a, scale=True, bias=True)
                                   for a in sorted(a for a in ACT_CODES if a)]
    bad = []
    for spec in specs:
        cores = [(torch.randn(s, generator=g, device=dev) / math.sqrt(s[0]))
                 for s in spec.core_matrix_shapes()]
        for xdt, rel in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            for b in (3, 300):
                for epi in epis[:2] if b == 300 else epis:
                    x = torch.randn(b, spec.n_in, generator=g, device=dev).to(xdt)
                    kw = {}
                    if epi.get("residual"):
                        kw["residual"] = torch.randn(b, spec.n_out, generator=g,
                                                     device=dev).to(xdt)
                    if epi.get("scale"):
                        kw["scale"] = torch.rand(spec.n_out, generator=g, device=dev) + 0.5
                        kw["bias"] = 0.1 * torch.randn(spec.n_out, generator=g, device=dev)
                    act = epi.get("activation")
                    ins = [x, *cores, *kw.values()]
                    keep = 1
                    if act == "relu":  # its derivative jumps at 0, where the kernel's u and
                        # the plain version's differ by rounding: no gradient on |z| < 0.05
                        with dispatch.force_plain(), torch.no_grad():
                            z = dispatch.tt_linear(x, cores, spec, scale=kw["scale"],
                                                   bias=kw["bias"]).float()
                        keep = (z.abs() >= 0.05).to(xdt)

                    staged = k.staged_launches
                    bwd, rec, plain = k.bwd_launches, k.recompute_launches, k.plain_cuda_calls
                    y, got = _grads_through(k.tt_linear, ins, spec, act, list(kw), keep, b)
                    assert k.bwd_launches > bwd
                    assert (k.recompute_launches > rec) == (act is not None)
                    assert k.plain_cuda_calls == plain
                    assert (k.staged_launches > staged) == (xdt == torch.float32)
                    with torch.no_grad():
                        assert torch.equal(y, k.tt_linear(x, cores, spec, activation=act, **kw))
                    with dispatch.force_plain():
                        _, want = _grads_through(dispatch.tt_linear, ins, spec, act, list(kw),
                                                 keep, b)
                    for i, (a, w) in enumerate(zip(got, want)):
                        assert a.dtype == w.dtype and a.shape == w.shape
                        try:
                            _close(a, w, rel)
                        except AssertionError as e:
                            bad.append(f"{spec.in_modes} {xdt} B={b} {act} input {i}: {e}")
    assert not bad, bad


def test_wrappers_refuse_grad_on_card(dev):
    """Every hand kernel without a backward raises NotImplementedError for a
    CUDA input that requires grad under grad mode (and runs under no_grad);
    check_card_support's "train" backend refuses each TRAIN_REFUSALS case on
    the card."""
    from torch_card_cases import TRAIN_REFUSALS, train_refused_config

    from repro_torch.core.quant import quantize_int4
    from repro_torch.core.ttd import TTSpec
    from repro_torch.kernels import dispatch
    bf = torch.bfloat16
    r = lambda *s, dt=torch.float32: torch.randn(*s, device=dev).to(dt)  # noqa: E731
    w = quantize_int4(r(64, 128), 32)
    emb = TTSpec.make(64, 256, 4, d=2)
    grouped = TTSpec.make(64, 128, 4, d=2)
    offs = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
    pool = {"k": r(4, 16, 2, 64, dt=bf), "v": r(4, 16, 2, 64, dt=bf)}
    bt = torch.arange(1, 3, dtype=torch.int32, device=dev).reshape(1, 2)
    kpos = torch.arange(32, dtype=torch.int32, device=dev)[None]
    calls = {
        "int4_matmul": lambda g: dispatch.int4_matmul(
            r(2, 128, dt=bf).requires_grad_(g), w["qweight"], w["scales"], group=32),
        "tt_embed": lambda g: dispatch.tt_embed(
            torch.arange(3, device=dev),
            [c.requires_grad_(g) for c in (r(*s) for s in emb.core_matrix_shapes())], emb),
        "tt_linear_grouped (MoE experts)": lambda g: dispatch.tt_linear_grouped(
            r(4, 64, dt=bf).requires_grad_(g), offs,
            [r(2, *s, dt=bf) for s in grouped.core_matrix_shapes()], grouped),
        "wkv_scan": lambda g: dispatch.wkv_scan(
            r(1, 4, 2, 16).requires_grad_(g), r(1, 4, 2, 16), r(1, 4, 2, 16),
            torch.rand(1, 4, 2, 16, device=dev), r(2, 16), r(1, 2, 16, 16)),
        "rglru_scan": lambda g: dispatch.rglru_scan(
            -torch.rand(1, 4, 64, device=dev).requires_grad_(g), r(1, 4, 64), r(1, 64)),
        "rglru_scan (gated)": lambda g: dispatch.rg_lru_gated(
            r(1, 4, 64).requires_grad_(g), r(1, 4, 64), r(1, 4, 64), r(64), r(1, 4, 64),
            r(1, 64)),
        "paged_attention": lambda g: dispatch.paged_attention(
            r(1, 4, 64, dt=bf).requires_grad_(g), pool, bt,
            torch.tensor([20], dtype=torch.int32, device=dev)),
        "prefill_attention": lambda g: dispatch.prefill_attention(
            r(1, 8, 4, 64, dt=bf).requires_grad_(g), kpos[:, :8].contiguous(), cache=pool,
            block_tables=bt),
        "ring_attention": lambda g: dispatch.prefill_attention(
            r(1, 8, 4, 64, dt=bf).requires_grad_(g), kpos[:, :8].contiguous(),
            k=r(1, 32, 2, 64, dt=bf), v=r(1, 32, 2, 64, dt=bf), kpos=kpos),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=re.escape(f"{name} has no backward")):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)
    for case, kernel in TRAIN_REFUSALS.items():
        cfg, _ = train_refused_config(case)
        with pytest.raises(ValueError, match=re.escape(kernel)):
            dispatch.check_card_support(cfg, dev, "train")
