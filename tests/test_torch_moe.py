"""repro_torch's Mixture-of-Experts (``models/moe.py``) against repro's.

Reduced mixtral-8x22b (4 experts, top-2, sliding window 16: served through
the ring backend, whose rings wrap) and reduced kimi-k2-1t-a32b (8 experts,
top-2, full attention: the paged backend), with seeded numpy parameters and
inputs handed to both packages.  repro runs its no-mesh path
(``_moe_dense``: every expert on every token) on its ``ref`` kernels; the
port runs the routed rows only, sorted by expert, through the grouped
tt_linear's plain version.  Tolerances: rtol = atol = 2e-4 in f32 (the JAX
suite's own); in bf16 the layer output at 2^-7 of max|want| (one bf16 ulp
of the largest element: both sides round each TT stage, the gated product
and the combine to bf16, summing in f32 in other orders).  Greedy Engine
tokens are compared for identity.  Also: the router's tie-break, the
grouped plain version against per-expert ``tt_linear_ref`` bitwise, the
grouped kernel's device tile schedule, ``compress_model`` and a repro-saved
MoE checkpoint served by the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QuantConfig as JQuant
from repro.config import TTDConfig as JTTD
from repro.config import config_to_dict
from repro.configs import get_config as jget
from repro.core import compress as jcomp
from repro.core import ttd as jttd
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve.engine import Engine as JEngine
from repro_torch.config import config_from_dict
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import compress as tcomp
from repro_torch.core import ttd as tttd
from repro_torch.kernels import tt_linear as ttk
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.sessions import SessionSpec, make_session
from repro_torch.serve.engine import Engine as TEngine
from torch_parity import jax_params

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["mixtral-8x22b", "kimi-k2-1t-a32b"]
_SETUPS = {}


def _setup(arch, quant=True, head_dim=None):
    """f32 reduced config with int4 (group 32) on q/k/v and the router, TT
    (d 3, rank 4) on attn_o and the experts, both packages' params;
    ``head_dim`` replaces the reduced config's (16)."""
    key = (arch, quant, head_dim)
    if key not in _SETUPS:
        base = jget(arch, reduced=True)
        if head_dim is not None:
            base = base.replace(head_dim=head_dim)
        jcfg = base.replace(compute_dtype="float32", param_dtype="float32",
                            quant=JQuant(enabled=quant, bits=4, group_size=32))
        tcfg = config_from_dict(config_to_dict(jcfg))
        jparams = jax_params(jcfg, seed=7)
        tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
        _SETUPS[key] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)
    return _SETUPS[key]


def _layer(s, li=0):
    """Layer ``li``'s MoE params in both packages and their specs."""
    jlayer = jax.tree.map(lambda a: a[li], s["jparams"]["segments"][0])["moe"]
    return (jlayer, jtf.make_block_specs(s["jcfg"], True).moe,
            s["tparams"]["segments"][0][li]["moe"], ttf.make_block_specs(s["tcfg"], True).moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_and_aux_loss_match_repro(arch):
    s = _setup(arch)
    jlayer, jspecs, tlayer, tspecs = _layer(s)
    assert tspecs["router"].kind == "int4" and tspecs["expert"]["gate"].kind == "tt"
    x = np.random.default_rng(1).standard_normal((37, s["jcfg"].d_model)).astype(np.float32)
    jp, jg, je = jmoe._route(jlayer, jnp.asarray(x), jspecs, s["jcfg"])
    tp, tg, te = tmoe.route(tlayer, torch.from_numpy(x), tspecs, s["tcfg"])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(float(tmoe.aux_loss(tp, te, s["tcfg"])),
                               float(jmoe._aux_loss(jp, je, s["jcfg"], axes=None)), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_moe_dense(arch, dtype):
    s = _setup(arch)
    jlayer, jspecs, tlayer, tspecs = _layer(s)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg, tcfg = s["jcfg"].replace(compute_dtype=dtype), s["tcfg"].replace(compute_dtype=dtype)
    x = np.random.default_rng(2).standard_normal((3, 11, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe._moe_dense(jlayer, jnp.asarray(x, jd).reshape(33, -1), jspecs, jcfg, jd)
    ty, taux = tmoe.apply_moe(tlayer, torch.from_numpy(x).to(td), tspecs, tcfg, td)
    assert ty.dtype == td and ty.shape == x.shape
    want = np.asarray(jy.astype(jnp.float32)).reshape(x.shape)
    got = ty.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_go_to_the_lower_expert(arch):
    """Dense f32 router weights with planted equal columns: experts 1 and 3
    tie for the top (both packages take [1, 3]), and under a larger expert 0
    experts 2 and 3 tie for second (both take [0, 2])."""
    s = _setup(arch, quant=False)
    jlayer, jspecs, tlayer, tspecs = _layer(s)
    assert tspecs["router"].kind == "dense"
    d = s["jcfg"].d_model
    x = np.abs(np.random.default_rng(3).standard_normal((4, d))).astype(np.float32)
    for cols, want in (({1: 1.0, 3: 1.0}, [1, 3]), ({0: 2.0, 2: 1.0, 3: 1.0}, [0, 2])):
        w = np.full((d, s["jcfg"].n_experts), -1.0 / d, np.float32)
        for c, v in cols.items():
            w[:, c] = v / d
        jl = dict(jlayer, router={"w": jnp.asarray(w)})
        tl = dict(tlayer, router={"w": torch.from_numpy(w)})
        _, _, je = jmoe._route(jl, jnp.asarray(x), jspecs, s["jcfg"])
        _, _, te = tmoe.route(tl, torch.from_numpy(x), tspecs, s["tcfg"])
        assert np.asarray(je).tolist() == [want] * 4
        assert te.tolist() == [want] * 4


ROUTINGS = {"spread": [5, 0, 3, 9, 0, 1, 7, 2], "one expert": [0, 0, 0, 27, 0, 0, 0, 0],
            "most empty": [0, 0, 1, 0, 0, 0, 0, 2]}


@pytest.mark.parametrize("routing", list(ROUTINGS))
@pytest.mark.parametrize("activation", [None, "silu"])
def test_grouped_plain_equals_per_expert_ref_bitwise(routing, activation):
    counts = ROUTINGS[routing]
    spec = tttd.TTSpec.make(0, 0, 4, d=3, in_modes=(4, 4, 4), out_modes=(2, 4, 4))
    rng = np.random.default_rng(4)
    e = len(counts)
    cores = [torch.from_numpy(rng.standard_normal((e, *sh)).astype(np.float32))
             for sh in spec.core_matrix_shapes()]
    x = torch.from_numpy(rng.standard_normal((sum(counts), spec.n_in)).astype(np.float32))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    got = ttk.tt_linear_grouped_ref(x, offsets, cores, spec, activation=activation)
    for i in range(e):
        a, b = int(offsets[i]), int(offsets[i + 1])
        want = ttk.tt_linear_ref(x[a:b], [c[i] for c in cores], spec, activation=activation)
        assert torch.equal(got[a:b], want), i


@pytest.mark.parametrize("n_experts", [4, 8, 384])
def test_grouped_tile_schedule(n_experts):
    """Every row in one tile, no tile across experts, at most ceil(R/TB) + E
    tiles, over spread, skewed, one-expert and mostly empty routings."""
    rng = np.random.default_rng(n_experts)
    routings = [rng.integers(0, 40, n_experts), rng.integers(0, 3, n_experts) * 17,
                np.eye(n_experts, dtype=int)[n_experts // 2] * 301,
                (rng.random(n_experts) < 0.1) * rng.integers(1, 9, n_experts)]
    for counts in routings:
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for tb in (1, 2, 4, 8):
            tiles, slots = ttk.grouped_tiles(offsets, tb)
            assert len(tiles) <= slots == -(-offsets[-1] // tb) + n_experts
            seen = np.zeros(offsets[-1], int)
            for ex, r0, r1 in tiles:
                assert offsets[ex] <= r0 < r1 <= offsets[ex + 1] and r1 - r0 <= tb
                seen[r0:r1] += 1
            assert (seen == 1).all()


def _logits_case(s, backend):
    """Chunks of prefill over 3 slots (the longest prompt wraps a ring of
    window 16 + chunk 8), then decode steps, through both packages' sessions
    of ``backend``; yields (port logits, repro logits)."""
    from repro.models import sessions as jsessions
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    slots, chunk, max_len, bs = 3, 8, 64, 4
    spec = dict(slots=slots, max_len=max_len, prefill_chunk=chunk, block_size=bs)
    jsess = jsessions.make_session(jcfg, jsessions.SessionSpec(**spec), backend=backend)
    tsess = make_session(tcfg, SessionSpec(**spec), backend=backend, device="cpu")
    jstate, tstate = jsess.init_state(), tsess.init_state()
    if backend == "paged":
        bt = np.random.default_rng(0).permutation(np.arange(1, 1 + slots * 16))[:slots * 16] \
            .reshape(slots, 16).astype(np.int32)
        jstate, tstate = jsess.with_tables(jstate, bt), tsess.with_tables(tstate, bt)
    jpre, jdec = jax.jit(jsess.prefill_chunk), jax.jit(jsess.decode_step)
    rng = np.random.default_rng(9)
    n_chunks = 4
    toks = rng.integers(0, jcfg.vocab_size, (slots, n_chunks * chunk)).astype(np.int32)
    pos = np.full((slots, n_chunks * chunk), -1, np.int32)
    pos[0, :29] = np.arange(29)
    pos[1, :6] = np.arange(6)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        jl, jstate = jpre(s["jparams"], jstate, jnp.asarray(toks[:, sl]), jnp.asarray(pos[:, sl]))
        tl, tstate = tsess.prefill_chunk(s["tparams"], tstate, torch.from_numpy(toks[:, sl]),
                                         torch.from_numpy(pos[:, sl]))
        yield tl, jl
    for step in range(3):
        dpos = np.array([29 + step, 6 + step, -1], np.int32)
        dtok = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)
        jl, jstate = jdec(s["jparams"], jstate, jnp.asarray(dtok), jnp.asarray(dpos))
        tl, tstate = tsess.decode_step(s["tparams"], tstate, torch.from_numpy(dtok),
                                       torch.from_numpy(dpos))
        yield tl, jl


@pytest.mark.parametrize("arch,backend,head_dim", [
    pytest.param("mixtral-8x22b", "ring", None, id="mixtral-8x22b-ring"),
    pytest.param("kimi-k2-1t-a32b", "paged", None, id="kimi-k2-1t-a32b-paged"),
    pytest.param("kimi-k2-1t-a32b", "paged", 112, id="kimi-k2-1t-a32b-paged-dh112"),
])
def test_session_logits_and_engine_tokens_match_repro(arch, backend, head_dim):
    """Reduced configs' session logits against repro's at 2e-4, then their
    greedy Engine tokens equal repro's; kimi-k2 also at its own head dim,
    112 (the reduced config's is 16)."""
    s = _setup(arch, head_dim=head_dim)
    assert make_session(s["tcfg"], SessionSpec(slots=1, max_len=32), device="cpu").backend \
        == backend
    for got, want in _logits_case(s, backend):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, s["jcfg"].vocab_size, n)]
               for n in (3, 21, 7, 30)]
    geometry = dict(slots=2, max_len=48, block_size=4, prefill_batch=2, prefill_chunk=8)
    outs = []
    for eng in (JEngine(s["jcfg"], s["jparams"], backend=backend, **geometry),
                TEngine(s["tcfg"], s["tparams"], device="cpu", **geometry)):
        reqs = [eng.submit(p, max_tokens=6) for p in prompts]
        eng.run()
        outs.append([r.out_tokens for r in reqs])
    assert outs[1] == outs[0]
    assert all(len(o) == 6 for o in outs[1])


def test_compress_model_matches_repro():
    """Reduced mixtral's dense f32 params (3 layers, dense experts) through
    both packages' ``compress_model`` for a target with TT (d 2, full rank)
    on blocks 1-2 and int4 (group 32) elsewhere, the router included: int4
    leaves bitwise, every expert's TT linear equal by reconstruction."""
    base = jget("mixtral-8x22b", reduced=True).replace(n_layers=3, compute_dtype="float32",
                                                       param_dtype="float32")
    jt = base.replace(ttd=JTTD(enabled=True, rank=10 ** 6, d=2, first_tt_block=1),
                      quant=JQuant(enabled=True, bits=4, group_size=32))
    jd = base.replace(ttd=JTTD(enabled=False), quant=JQuant(enabled=False))
    td, tt = (config_from_dict(config_to_dict(c)) for c in (jd, jt))
    jdense = jax_params(jd, seed=3)
    jtree = jax.device_get(jcomp.compress_model(jdense, jd, jt, svd_method="svd"))
    ttree = tcomp.compress_model(params_from_jax(jax.device_get(jdense), td, device="cpu"),
                                 td, tt, svd_method="svd")
    tcomp.validate_compressed_params(tt, ttree)
    from repro.checkpoint.store import _flatten_with_paths
    got = dict(_flatten_with_paths(params_to_jax(ttree, tt)))
    want = dict(_flatten_with_paths(jtree))
    assert list(got) == list(want)
    n_int4 = 0
    for name, a in got.items():
        assert str(a.dtype).split(".")[-1] == np.asarray(want[name]).dtype.name, name
        if name.endswith(("/qweight", "/scales")):
            bits = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
            wb = np.asarray(want[name])
            wb = wb.view(np.int16) if wb.dtype.name == "bfloat16" else wb
            np.testing.assert_array_equal(bits.numpy(), wb, err_msg=name)
            n_int4 += 1
    # segment 0: q/k/v/o, the router and the experts' gate/up/down; segment 1: q/k/v, the router
    assert n_int4 == 2 * (8 + 4)
    n_tt = 0
    sp = ttf.make_block_specs(tt, True).moe["expert"]
    for li in range(2):
        for nm, lsp in sp.items():
            mine = ttree["segments"][1][li]["moe"]["experts"][nm]["cores"]
            ref = jtree["segments"][1]["moe"]["experts"][nm]["cores"]
            jspec = jttd.TTSpec(lsp.tt.in_modes, lsp.tt.out_modes, lsp.tt.ranks)
            for ex in range(tt.n_experts):
                rec = tttd.tt_reconstruct(tttd.matrices_to_cores(
                    [c[ex].double() for c in mine], lsp.tt), lsp.tt).numpy()
                jrec = jttd.tt_reconstruct(jttd.matrices_to_cores(
                    [np.asarray(c[li, ex], np.float64) for c in ref], jspec), jspec)
                assert np.linalg.norm(rec - jrec) <= 1e-6 * np.linalg.norm(jrec), (li, nm, ex)
                n_tt += 1
    assert n_tt == 2 * 3 * tt.n_experts


def test_engine_serves_a_repro_saved_moe_checkpoint(tmp_path):
    """Reduced mixtral's bf16 serving tree (int4 group 32 on q/k/v and the
    router, bf16 TT cores elsewhere), saved by repro and loaded by the port:
    the leaves bitwise, and greedy tokens identical to repro's Engine on the
    tree it saved, both computing in f32 on the bf16 leaves."""
    from repro.serve.steps import serve_config_of
    base = jget("mixtral-8x22b", reduced=True)
    jcfg = serve_config_of(base).replace(quant=JQuant(enabled=True, bits=4, group_size=32))
    jtree = jax.device_get(jax_params(jcfg, seed=2))
    jcomp.save_compressed(tmp_path, jtree, jcfg)
    params, cfg = tcomp.load_compressed(tmp_path, device="cpu")
    assert cfg == config_from_dict(config_to_dict(jcfg))
    from repro.checkpoint.store import _flatten_with_paths
    mine = dict(_flatten_with_paths(params_to_jax(params, cfg)))
    for name, want in _flatten_with_paths(jtree):
        a, w = mine[name], np.asarray(want)
        bits = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        np.testing.assert_array_equal(bits, w.view(np.int16) if w.dtype.name == "bfloat16"
                                      else w, err_msg=name)
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in (5, 27, 9)]
    geometry = dict(slots=2, max_len=48, prefill_batch=2, prefill_chunk=8,
                    cache_dtype="float32")
    outs = []
    for eng in (JEngine(jcfg.replace(compute_dtype="float32"),
                        jax.tree.map(jnp.asarray, jtree), backend="ring", **geometry),
                TEngine(cfg.replace(compute_dtype="float32"), params, device="cpu",
                        **geometry)):
        reqs = [eng.submit(p, max_tokens=6) for p in prompts]
        eng.run()
        outs.append([r.out_tokens for r in reqs])
    assert outs[1] == outs[0]


def test_non_tt_experts_run_on_the_plain_versions():
    """Experts left dense (TT off) serve on the CPU through the per-expert
    plain route, matching repro."""
    s = _setup("kimi-k2-1t-a32b", quant=False)
    jcfg = s["jcfg"].replace(ttd=dataclasses.replace(s["jcfg"].ttd, enabled=False))
    tcfg = config_from_dict(config_to_dict(jcfg))
    jparams = jax_params(jcfg, seed=8)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    jlayer = jax.tree.map(lambda a: a[0], jparams["segments"][0])["moe"]
    tspecs = ttf.make_block_specs(tcfg, True).moe
    assert tspecs["expert"]["gate"].kind == "dense"
    x = np.random.default_rng(6).standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    jy, _ = jmoe._moe_dense(jlayer, jnp.asarray(x).reshape(14, -1),
                            jtf.make_block_specs(jcfg, True).moe, jcfg, jnp.float32)
    ty, _ = tmoe.apply_moe(tparams["segments"][0][0]["moe"], torch.from_numpy(x), tspecs,
                           tcfg, torch.float32)
    np.testing.assert_allclose(ty.numpy().reshape(14, -1), np.asarray(jy), **TOL)


def test_moe_specs_tree_matches_repro():
    for arch in ARCHS:
        jt = jtf.specs_tree(jget(arch))
        tt = ttf.specs_tree(config_from_dict(config_to_dict(jget(arch))))
        jl, tl = jt["segments"][0], tt["segments"][0][0]
        assert set(tl) == set(jl) == {"ln1", "ln2", "attn", "moe"}
        assert set(tl["moe"]) == {"router", "experts"}
        for nm, sp in tl["moe"]["experts"].items():
            assert (sp.kind, sp.n_in, sp.n_out) == (jl["moe"]["experts"][nm].kind,
                                                    jl["moe"]["experts"][nm].n_in,
                                                    jl["moe"]["experts"][nm].n_out)
            assert sp.tt.in_modes == jl["moe"]["experts"][nm].tt.in_modes
