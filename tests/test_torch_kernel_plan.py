"""The arithmetic of the port's redesigned int4_matmul and tt_embed kernels,
on the CPU.

The tt_embed kernels form a row as the product of two halves split at a
rank: L from the cores left of the split, selected by the id's prefix
digits, times R from the cores right of it, selected by its suffix digits.
The prefill int4_matmul kernel converts nibbles to bf16 by a magic number
(no float conversion) and keeps the products exact, folding each quant
group's f32 partial sums with the group's scale.  Neither kernel runs here, so these tests hold plain
versions of the same arithmetic, in the kernels' layouts and orders, against
``repro``'s oracles (``ref.tt_embedding`` and the ``pallas-interpret``
kernel, ``ref.int4_matmul``) and ``core.quant.unpack_int4``, on inputs from
seeded numpy generators, at rtol = atol = 2e-4 in f32 (the JAX suite's own
ref-vs-kernel tolerance); the conversion is held bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ttd import TTSpec as JTTSpec
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.core.quant import pack_int4, unpack_int4
from repro_torch.core.ttd import TTSpec
from repro_torch.kernels.int4_matmul import unpack_magic
from repro_torch.kernels.tt_embed import (embed_halves, embed_plan, embed_split,
                                          tt_embed_plain, tt_embed_two_half)
from repro_torch.models.modules import embed_spec

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("modes,rank", [
    (((8, 8, 8, 8), (20, 16, 10, 10)), 16),   # llama2-7b's embed spec
    (((4, 4, 2, 2), (4, 4, 4, 4)), 16),       # reduced, ranks capped (1, 16, 16, 8, 1)
    (((4, 3, 2), (5, 2, 7)), 3),              # d = 3
    (((24,), (10,)), 1),                      # d = 1: the right half is empty
])
def test_two_half_embedding_matches_ref_and_interpret(modes, rank):
    """Every split rho: the prefix and suffix tables, row = L[prefix] ·
    R[suffix] flattened n_1-slowest, on ids that wrap once (-1, -V-3) and
    clamp (V, V+7) and on every digit boundary (multiples of the suffix
    count, V - 1)."""
    spec = TTSpec.make(0, 0, rank, d=len(modes[0]), in_modes=modes[0], out_modes=modes[1])
    jspec = JTTSpec(spec.in_modes, spec.out_modes, spec.ranks)
    rng = np.random.default_rng(spec.n_out + rank)
    cores = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
             for s in spec.core_matrix_shapes()]
    v = spec.n_out
    step = v // spec.out_modes[0]
    ids = np.concatenate([[0, 1, v - 1, -1, -v - 3, v, v + 7], np.arange(0, v, step),
                          np.arange(step - 1, v, step), rng.integers(0, v, 6)]).astype(np.int32)
    jc = [jnp.asarray(c) for c in cores]
    want = np.asarray(jref.tt_embedding(jnp.asarray(ids), jc, jspec))
    interp = np.asarray(jdispatch.tt_embed(jnp.asarray(ids), jc, jspec,
                                           backend="pallas-interpret"))
    tc = [torch.from_numpy(c) for c in cores]
    tid = torch.from_numpy(ids)
    for rho in (range(1, spec.d) if spec.d > 1 else (1,)):
        plan = embed_split(spec, rho)
        left, right = embed_halves(tc, spec, rho)
        assert left.shape == (plan.n_left, plan.p, plan.rank)
        assert right.shape == (plan.n_right, plan.rank, plan.q)
        assert plan.p * plan.q == spec.n_in and plan.n_left * plan.n_right == v
        got = tt_embed_two_half(tid, tc, spec, rho).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"rho={rho}")
        np.testing.assert_allclose(got, interp, **TOL, err_msg=f"rho={rho}")
    even = 2 * (len(ids) // 2)
    np.testing.assert_allclose(tt_embed_two_half(tid[:even].reshape(2, -1), tc, spec).numpy(),
                               want[:even].reshape(2, -1, spec.n_in), **TOL)


def test_two_half_embedding_on_bf16_cores():
    """bf16 cores go through the halves in f32, as the kernels take them."""
    spec = TTSpec.make(0, 0, 16, in_modes=(8, 8, 8, 8), out_modes=(20, 16, 10, 10))
    rng = np.random.default_rng(7)
    cores = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0]))
             .to(torch.bfloat16) for s in spec.core_matrix_shapes()]
    ids = torch.from_numpy(rng.integers(-100, spec.n_out + 100, 40).astype(np.int64))
    np.testing.assert_allclose(tt_embed_two_half(ids, cores, spec).numpy(),
                               tt_embed_plain(ids, cores, spec).numpy(), **TOL)


@pytest.mark.parametrize("arch", ["llama2-7b", "chatglm3-6b", "tinyllama-1.1b"])
def test_embed_plan_on_serve_specs(arch):
    """The split is the cheapest; at llama2-7b's spec rho = 2 (L 64 x 16,
    R 16 x 64, 320 prefixes and 100 suffixes), 0.197 MFLOP a token, under
    the left-to-right chain's 0.426."""
    cfg = get_config(arch)
    cfg = cfg.replace(ttd=dataclasses.replace(cfg.ttd, enabled=True, embed=True))
    spec = embed_spec(cfg).tt
    plan = embed_plan(spec)
    splits = [embed_split(spec, rho) for rho in range(1, spec.d)]
    assert plan.flops == min(p.flops for p in splits)
    chain = embed_split(spec, spec.d - 1).flops  # left to right: the last core is R
    assert plan.flops <= chain
    if arch == "llama2-7b":
        assert (plan.rho, plan.p, plan.q, plan.rank, plan.n_left, plan.n_right) == \
            (2, 64, 64, 16, 320, 100)
        assert plan.flops == 196608 and chain == 425984


def test_magic_nibble_conversion_all_bytes():
    """All 256 byte values: nibble XOR 8 into the mantissa of bf16 128.0,
    minus 136, is the sign-extended nibble exactly (low nibble = even k)."""
    b = torch.arange(256, dtype=torch.uint8)
    got = unpack_magic(b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), unpack_int4(b).float())
    assert torch.equal(unpack_magic(b.reshape(8, 32)).float(),
                       unpack_int4(b.reshape(8, 32)).float())


@pytest.mark.parametrize("b,k_in,m,group", [(5, 256, 48, 128), (3, 192, 40, 32),
                                            (4, 160, 24, 16)])
def test_int4_exact_products_match_ref(b, k_in, m, group):
    """The kernels' order: per group, exact bf16 products of the converted
    nibbles with bf16 activations summed in f32, then acc += partial *
    scale, against ``ref.int4_matmul``."""
    rng = np.random.default_rng(k_in + m)
    q = rng.integers(-8, 8, (m, k_in)).astype(np.int8)
    packed = pack_int4(torch.from_numpy(q))
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, (m, k_in // group)).astype(np.float32)
                              ).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((b, k_in)).astype(np.float32)).to(torch.bfloat16)
    w = unpack_magic(packed).float().reshape(m, k_in // group, group)
    parts = torch.einsum("bgk,mgk->bmg", x.float().reshape(b, k_in // group, group), w)
    got = (parts * scales.float()[None]).sum(-1)
    want = np.asarray(jref.int4_matmul(jnp.asarray(x.float().numpy()),
                                       jnp.asarray(packed.numpy()),
                                       jnp.asarray(scales.float().numpy()), group))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
