"""The dense configs the port registers beside the paper's, against repro.

granite-3-8b, phi4-mini-3.8b (tied embeddings), qwen1.5-110b (qkv bias) and
chatglm3-6b (qkv bias, partial rotary 0.5, multi-query attention with 2 KV
heads) reduced, in f32 with int4 (group 32) on q/k/v and block 0 and TT on
block 1: paged prefill and decode logits at rtol = atol = 2e-4 (the JAX
suite's own tolerance) and Engine greedy tokens identical to repro's.
qwen2-vl-7b's M-RoPE is refused by the paged and ring backends of both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QuantConfig, config_to_dict
from repro.configs import get_config as jget
from repro.models import sessions as jsessions
from repro.models import transformer as jtf
from repro.serve.engine import Engine as JEngine
from repro_torch.config import config_from_dict
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import sessions as tsessions
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Engine as TEngine
from torch_parity import jax_params

NEW_DENSE = ["granite-3-8b", "phi4-mini-3.8b", "qwen1.5-110b", "chatglm3-6b"]


def _setup(arch):
    base = jget(arch, reduced=True)
    jcfg = base.replace(compute_dtype="float32", param_dtype="float32",
                        quant=QuantConfig(enabled=True, bits=4, group_size=32),
                        ttd=dataclasses.replace(base.ttd, first_tt_block=1))
    tcfg = config_from_dict(config_to_dict(jcfg))
    jparams = jax_params(jcfg, seed=7)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams), tcfg, device="cpu")


def test_registry_matches_repro():
    from repro.configs import ALL_ARCHS as J_ARCHS
    assert set(ALL_ARCHS) <= set(J_ARCHS)
    for arch in ALL_ARCHS:
        for reduced in (False, True):
            assert config_to_dict(jget(arch, reduced)) == \
                dataclasses.asdict(tget(arch, reduced)), (arch, reduced)


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_paged_logits_and_engine_tokens_match_repro(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    assert (tcfg.tie_embeddings, tcfg.qkv_bias) == (jcfg.tie_embeddings, jcfg.qkv_bias)
    slots, bs, w, chunk = 3, 4, 8, 8
    nb = 1 + slots * w
    bt = np.random.default_rng(0).permutation(np.arange(1, nb))[:slots * w] \
        .reshape(slots, w).astype(np.int32)
    jcache = jtf.init_paged_cache(jcfg, nb, bs, jnp.float32)
    tcache = ttf.init_paged_cache(tcfg, nb, bs, torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (slots, 2 * chunk)).astype(np.int32)
    pos = np.full((slots, 2 * chunk), -1, np.int32)
    pos[0] = np.arange(2 * chunk)
    pos[1, :5] = np.arange(5)
    for c in range(2):
        sl = slice(c * chunk, (c + 1) * chunk)
        jl, jcache = jtf.prefill_paged_chunk(jparams, jcfg, jcache, jnp.asarray(toks[:, sl]),
                                             jnp.asarray(bt), jnp.asarray(pos[:, sl]))
        tl, tcache = ttf.prefill_paged_chunk(tparams, tcfg, tcache,
                                             torch.from_numpy(toks[:, sl]),
                                             torch.from_numpy(bt), torch.from_numpy(pos[:, sl]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    for step in range(2):
        dpos = np.array([2 * chunk + step, 5 + step, -1], np.int32)
        dtok = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)
        jl, jcache = jtf.decode_step_paged(jparams, jcfg, jcache, jnp.asarray(dtok),
                                           jnp.asarray(bt), jnp.asarray(dpos))
        tl, tcache = ttf.decode_step_paged(tparams, tcfg, tcache, torch.from_numpy(dtok),
                                           torch.from_numpy(bt), torch.from_numpy(dpos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)

    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab_size, n)] for n in (3, 12, 7, 20)]
    geometry = dict(slots=2, max_len=48, block_size=4, prefill_batch=2, prefill_chunk=8)
    outs = []
    for eng in (JEngine(jcfg, jparams, backend="paged", **geometry),
                TEngine(tcfg, tparams, device="cpu", **geometry)):
        reqs = [eng.submit(p, max_tokens=6) for p in prompts]
        eng.run()
        outs.append([r.out_tokens for r in reqs])
    assert outs[1] == outs[0]


@pytest.mark.parametrize("backend", ["paged", "ring"])
def test_mrope_is_refused_by_the_kv_backends(backend):
    jcfg = jget("qwen2-vl-7b", reduced=True)
    tcfg = tget("qwen2-vl-7b", reduced=True)
    assert tcfg.pos_type == "mrope" and tcfg.mrope_sections == (2, 3, 3)
    with pytest.raises(NotImplementedError, match="mrope"):
        jsessions.make_session(jcfg, jsessions.SessionSpec(slots=2, max_len=32), backend=backend)
    with pytest.raises(NotImplementedError, match="mrope"):
        tsessions.make_session(tcfg, tsessions.SessionSpec(slots=2, max_len=32),
                               backend=backend, device="cpu")
