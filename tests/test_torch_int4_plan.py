"""The plans and the f32 arithmetic of the port's int4_matmul decode GEMV and
f32 (MoE router) routes, on the CPU.

Neither kernel runs here.  The GEMV cuts K into slices that CTAs of 16-row
warps reduce in one launch (``gemv_plan``); these tests hold every serve
shape's plan to covering each quant group exactly once, on group
boundaries, with a wave of CTAs and no more slices than a cluster holds.
The f32 route multiplies the dequantized weights, exact in TF32, by x split
into tf32 hi and lo parts on the tensor cores; ``f32_route_emulated`` writes
that arithmetic in torch, held here against ``repro``'s ``ref.int4_matmul``
in f32 on seeded numpy inputs at router widths, at 1e-5 of max|want| (the
card's check is 1e-4), with one TF32 pass shown to miss the card's 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.quant import pack_int4
from repro_torch.kernels import int4_matmul as k
from repro_torch.kernels.scan_wkv import tf32_round

# (K, M) of every int4 linear a served path runs at decode: llama2-7b,
# chatglm3-6b (q/o, k/v with 2 KV heads, gate/up, down), rwkv6-7b,
# recurrentgemma-2b, mixtral-8x22b and kimi-k2-1t-a32b (q, k/v)
SERVE_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 256), (4096, 13696),
                (13696, 4096), (2560, 2560), (2560, 256), (6144, 6144), (6144, 1024),
                (7168, 7168), (7168, 896)]


def _check_slices(plan_split, kk, group):
    slices = plan_split.slices(kk)
    assert slices[0][0] == 0 and slices[-1][1] == kk
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))  # each k once, in order
    assert all(lo < hi and lo % group == 0 and hi % group == 0 and (hi - lo) % 32 == 0
               for lo, hi in slices)  # group boundaries, whole 32-k runs
    assert max((hi - 1) // group - lo // group + 1 for lo, hi in slices) <= plan_split.ngs


def test_gemv_plan_on_the_serve_shapes():
    """Every served shape at B 1, 8 and 16 (one test: the plans are pure
    arithmetic, and a test item each would only lengthen the suite's
    scheduling)."""
    for kk, m in SERVE_SHAPES:
        for b in (1, 8, 16):
            p = k.gemv_plan(b, kk, m, 128)
            _check_slices(p.split, kk, 128)
            assert p.ctas >= k.WAVE and p.row_tiles * p.warps * 16 >= m, (kk, m, b)
            assert p.warps in (1, 2, 4, 8) and p.split.splits <= k.MAX_SPLITS, (kk, m, b)
            assert 8 * -(-b // 8) * p.split.per_k * 2 <= k.GEMV_X_BYTES, (kk, m, b)


def test_gemv_plan_by_group():
    for kk, m in ((4096, 4096), (11008, 4096), (2560, 256)):
        for group in (16, 32, 64, 128):
            p = k.gemv_plan(8, kk, m, group)
            _check_slices(p.split, kk, group)
            assert p.ctas >= k.WAVE, (kk, m, group)


def test_gemv_plan_refuses_past_its_tiles():
    with pytest.raises(ValueError, match="GEMV takes"):
        k.gemv_plan(8 * k.GEMV_MAX_NT + 1, 4096, 4096, 128)
    assert k.GEMV_MAX_B <= 8 * k.GEMV_MAX_NT


def test_the_wrapper_launches_its_plan(monkeypatch):
    """The wrapper hands the C entry the plan's grid, one call a launch, with
    no workspace: a row tile's slices reduce inside their cluster, so no
    plan has more slices than a cluster holds."""
    calls = []

    class Lib:
        def rt_int4_matmul(self, *a):
            calls.append(("bf16", a[7:-1]))
            return 0

        def rt_int4_matmul_f32(self, *a):
            calls.append(("f32", a[7:-1]))
            return 0

    monkeypatch.setattr(k._build, "lib", lambda: Lib())
    monkeypatch.setattr(k._build, "stream", lambda t: 0)

    class Cuda(torch.Tensor):  # a CPU tensor the wrapper takes for a CUDA one
        is_cuda = True

    for b, kk, m, dt in ((8, 4096, 11008, torch.bfloat16), (8, 2560, 256, torch.bfloat16),
                         (2048, 4096, 4096, torch.bfloat16), (2048, 7168, 384, torch.float32),
                         (8, 7168, 384, torch.float32)):
        x = torch.zeros(b, kk, dtype=dt).as_subclass(Cuda)
        qw = torch.zeros(m, kk // 2, dtype=torch.uint8).as_subclass(Cuda)
        sc = torch.zeros(m, kk // 128, dtype=torch.bfloat16).as_subclass(Cuda)
        n0 = k.launches
        k._int4_matmul_cuda(x, qw, sc, 128, None, None, None, "silu")
        assert k.launches == n0 + 1
        route, args = calls[-1]
        assert args[:5] == (b, kk, m, 128, k.ACT_CODES["silu"])
        if dt == torch.float32:
            p = k.f32_plan(b, kk, m, 128)
            assert route == "f32" and args[5:] == (p.fm, p.fn, p.wm, *p.split)
        elif b <= k.GEMV_MAX_B:
            p = k.gemv_plan(b, kk, m, 128)
            assert route == "bf16" and args[5:] == (p.warps, *p.split)
        else:
            assert route == "bf16" and args[5:] == (0, 0, 0, 0)  # the wgmma GEMM
        if args[6]:
            assert args[6] <= k.MAX_SPLITS


def test_f32_plan_covers_k():
    for b, kk, m in ((8, 6144, 8), (2048, 6144, 8), (8, 7168, 384), (2048, 7168, 384),
                     (37, 256, 100), (1, 64, 3)):
        group = 16 if kk == 64 else 128 if kk > 256 else 32
        p = k.f32_plan(b, kk, m, group)
        _check_slices(p.split, kk, group)
        assert (p.fm, p.fn, p.wm) in ((1, 1, 8), (1, 2, 8), (2, 8, 4), (1, 2, 2)), (b, kk, m)
        assert p.row_tiles * 16 * p.fm * p.wm >= m
        assert p.token_tiles * 8 * p.fn * (8 // p.wm) >= b
        if b > 16:  # the C side has no deep-stage tile above 16 tokens
            assert (p.fm, p.fn) != (1, 1)


def test_tf32_rounding_bits():
    """cvt.rna.tf32.f32: the low 13 mantissa bits rounded off, ties away
    from zero, a carry into the exponent, and NaN, infinities, zeros and
    subnormals kept in class."""
    bits = torch.tensor([0x3F800000, 0x3F801000, 0x3F800FFF, 0xBF801000, 0x3FFFF000,
                         0x7F800000, 0x00000001, 0x00001000, 0x80000000, 0x7FC00000,
                         0x4B000005], dtype=torch.int64).to(torch.int32)
    want = [0x3F800000, 0x3F802000, 0x3F800000, 0xBF802000, 0x40000000,
            0x7F800000, 0x00000000, 0x00002000, 0x80000000, 0x7FC00000, 0x4B000000]
    got = tf32_round(bits.view(torch.float32)).view(torch.int32).tolist()
    assert [g & 0xFFFFFFFF for g in got] == want


def _router_inputs(b, kk, m, group, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 8, (m, kk)).astype(np.int8)
    packed = pack_int4(torch.from_numpy(q))
    scales = torch.from_numpy(rng.uniform(0.005, 0.05, (m, kk // group)).astype(np.float32)
                              ).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((b, kk)).astype(np.float32))
    want = np.asarray(jref.int4_matmul(jnp.asarray(x.numpy()), jnp.asarray(packed.numpy()),
                                       jnp.asarray(scales.float().numpy()), group))
    return x, packed, scales, want


def test_dequantized_weights_are_exact_in_tf32():
    """q * scale for every q in [-8, 7] and every bf16 scale of a normal
    product (exponents -120..120) has at most 11 significant bits: TF32
    rounding leaves it as it is, so the f32 route's A operand is exact."""
    bits = torch.arange(0, 1 << 15, dtype=torch.int32).to(torch.int16)
    s = bits.view(torch.bfloat16).float()
    s = torch.cat([s, -s])
    s = s[(s.abs() >= 2.0 ** -120) & (s.abs() <= 2.0 ** 120)]
    w = torch.arange(-8, 8, dtype=torch.float32)[:, None] * s[None]
    assert torch.equal(tf32_round(w), w)


@pytest.mark.parametrize("b,kk,m,group", [(3, 7168, 384, 128), (2, 6144, 8, 128),
                                          (4, 256, 40, 16)])
def test_f32_route_matches_ref(b, kk, m, group):
    """w x_lo + w x_hi (w = q * scale) against ``ref.int4_matmul`` in f32:
    1e-5 of max|want| (the two passes leave ~2^-22 of each product)."""
    x, packed, scales, want = _router_inputs(b, kk, m, group, kk + m)
    got = k.f32_route_emulated(x, packed, scales, group).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_one_tf32_pass_misses_the_card_tolerance(monkeypatch):
    """x_hi alone (one TF32 pass) is off by more than the card check's 1e-4
    of max|want| at the kimi-k2 router's width: the lo pass is needed."""
    x, packed, scales, want = _router_inputs(4, 7168, 384, 128, 1)
    monkeypatch.setattr(k, "tf32_round", lambda t: tf32_round(t) if t is x else 0 * t)
    got = k.f32_route_emulated(x, packed, scales, 128).numpy()
    assert np.abs(got - want).max() > 1e-4 * np.abs(want).max()
