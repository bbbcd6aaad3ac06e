"""repro_torch's compression pipeline against repro's: TT-SVD (paper
Algorithm 1), rank search, the §V.A recipe (``compress_model``), Table I
accounting, the step-0 repair (f32 TT cores under bf16 activations) and the
recovery factor ``chip_smoke.py`` gates on.

SVD signs and bases differ between LAPACK builds and cuSOLVER, so TT leaves
are compared through gauge-invariant quantities (``tt_reconstruct``, layer
outputs), never core by core, and only on weights with a spectral gap at
each cut: full rank (``rank=10**6``) or a planted low-TT-rank weight plus
1e-3 noise.  Reconstructions agree within 1e-8 relative in f64; int4 leaves
and data-movement helpers bitwise; logits at rtol = atol = 2e-4 in f32 (the
JAX suite's own); bf16 layer outputs at the bf16 tolerance of
``test_torch_model.py`` (rtol = atol = 5e-2, mean |diff| < 1e-2).
"""
import dataclasses
import math
import re

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
from repro.core import ranksearch as jrs
from repro.core import ttd as jttd
from repro.kernels import dispatch as jdispatch
from repro.models import transformer as jtf
from repro_torch.config import config_from_dict
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import compress as tcomp
from repro_torch.core import ranksearch as trs
from repro_torch.core import ttd as tttd
from repro_torch.kernels import tt_linear as ttk
from repro_torch.models import transformer as ttf
from repro_torch.models.modules import LinearSpec
from torch_parity import jax_params

RECON_TOL = 1e-8
# (in_modes, out_modes, planted rank): 'auto' takes the Gram route on the
# first (72 x 320) unfolding of the first; the second's first unfolding is
# wide (8 x 512); the third is d = 2.
MODES = [((8, 4, 4), (9, 4, 5), 6), ((4, 4, 4), (2, 4, 8), 5), ((8, 8), (8, 8), 7)]
MODE_IDS = ["gram-first", "wide-first", "d2"]


def _spec(in_m, out_m, rank):
    return tttd.TTSpec.make(0, 0, rank, d=len(in_m), in_modes=in_m, out_modes=out_m)


def _jspec(spec):
    return jttd.TTSpec(spec.in_modes, spec.out_modes, spec.ranks)


def _planted(spec, rng, noise=1e-3):
    """A weight of TT rank ``spec.ranks`` (unit RMS) plus ``noise`` RMS."""
    cores = [rng.standard_normal((spec.ranks[k], spec.mode_sizes[k], spec.ranks[k + 1]))
             for k in range(spec.d)]
    w = jttd.tt_reconstruct(cores, _jspec(spec))
    w = w / np.sqrt(np.mean(w * w))
    return w + noise * rng.standard_normal(w.shape)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bits(a) -> np.ndarray:
    """An array's bit pattern (bf16 as uint16), for bitwise comparisons."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _dtype(a) -> str:
    return str(a.dtype).replace("torch.", "") if isinstance(a, torch.Tensor) else \
        np.asarray(a).dtype.name


# ---------------------------------------------------------------------------
# core/ttd.py
# ---------------------------------------------------------------------------
def test_tensorize_and_core_layouts_bitwise():
    rng = np.random.default_rng(0)
    for in_m, out_m, r in MODES:
        spec = _spec(in_m, out_m, r)
        jspec = _jspec(spec)
        assert spec.mode_sizes == jspec.mode_sizes
        assert spec.compression_ratio() == jspec.compression_ratio()
        assert tttd.tt_params(spec) == jttd.tt_params(jspec)
        assert tttd.compression_ratio(spec) == jttd.compression_ratio(jspec)
        w = rng.standard_normal((spec.n_out, spec.n_in))
        t = tttd.tensorize_weight(torch.from_numpy(w), spec)
        np.testing.assert_array_equal(t.numpy(), jttd.tensorize_weight(w, jspec))
        np.testing.assert_array_equal(tttd.untensorize_weight(t, spec).numpy(), w)
        cores = [rng.standard_normal((spec.ranks[k], spec.mode_sizes[k], spec.ranks[k + 1]))
                 for k in range(spec.d)]
        mats = tttd.cores_to_matrices([torch.from_numpy(c) for c in cores], spec)
        jmats = jttd.cores_to_matrices(cores, jspec)
        for a, b in zip(mats, jmats):
            np.testing.assert_array_equal(a.numpy(), b)
        for a, b in zip(tttd.matrices_to_cores(mats, spec), cores):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_allclose(
            tttd.tt_reconstruct([torch.from_numpy(c) for c in cores], spec).numpy(),
            jttd.tt_reconstruct(cores, jspec), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["svd", "gram", "auto"])
@pytest.mark.parametrize("case", ["planted", "full-rank"])
@pytest.mark.parametrize("modes", MODES, ids=MODE_IDS)
def test_tt_svd_reconstruction_matches_repro(modes, case, method):
    in_m, out_m, r = modes
    rng = np.random.default_rng(1)
    spec = _spec(in_m, out_m, r if case == "planted" else 10 ** 6)
    w = _planted(spec, rng) if case == "planted" else \
        rng.standard_normal((spec.n_out, spec.n_in))
    want = jttd.tt_reconstruct(jttd.tt_svd(w, _jspec(spec), method=method), _jspec(spec))
    cores = tttd.tt_svd(torch.from_numpy(w), spec, method=method)
    assert [tuple(c.shape) for c in cores] == \
        [(spec.ranks[k], spec.mode_sizes[k], spec.ranks[k + 1]) for k in range(spec.d)]
    assert all(c.dtype == torch.float64 for c in cores)
    assert _rel(tttd.tt_reconstruct(cores, spec).numpy(), want) <= RECON_TOL


@pytest.mark.parametrize("modes", MODES, ids=MODE_IDS)
def test_tt_error_and_tt_linear_from_dense_match_repro(modes):
    from repro.core.tt_linear import tt_linear_from_dense as jfrom
    from repro.core.tt_linear import tt_stage_shapes as jstages
    from repro_torch.core.tt_linear import tt_linear_from_dense, tt_stage_shapes
    in_m, out_m, r = modes
    rng = np.random.default_rng(2)
    spec = _spec(in_m, out_m, r)
    w = _planted(spec, rng)
    assert abs(trs.tt_error(torch.from_numpy(w), spec) - jrs.tt_error(w, _jspec(spec))) <= 1e-9
    got = tt_linear_from_dense(torch.from_numpy(w), spec)["cores"]
    want = jfrom(w, _jspec(spec))["cores"]
    assert [c.dtype for c in got] == [torch.float32] * spec.d
    assert [tuple(c.shape) for c in got] == [tuple(c.shape) for c in want]
    rec = tttd.tt_reconstruct(tttd.matrices_to_cores([c.double() for c in got], spec), spec)
    jrec = jttd.tt_reconstruct(jttd.matrices_to_cores(
        [np.asarray(c, np.float64) for c in want], _jspec(spec)), _jspec(spec))
    assert _rel(rec.numpy(), jrec) <= 1e-6  # f32 cores
    assert tt_stage_shapes(spec, 5) == jstages(_jspec(spec), 5)


def test_tt_svd_raises_on_an_unattainable_rank():
    spec = tttd.TTSpec((2, 2), (2, 2), (1, 8, 1))  # the (4 x 4) unfolding has rank <= 4
    w = np.random.default_rng(3).standard_normal((4, 4))
    with pytest.raises(ValueError, match="attained rank 4 < requested 8"):
        jttd.tt_svd(w, _jspec(spec))
    with pytest.raises(ValueError, match="attained rank 4 < requested 8"):
        tttd.tt_svd(torch.from_numpy(w), spec)
    with pytest.raises(ValueError, match="unknown method"):
        tttd.tt_svd(torch.from_numpy(w), tttd.TTSpec((2, 2), (2, 2), (1, 2, 1)), method="qr")


# ---------------------------------------------------------------------------
# core/ranksearch.py: the cases of tests/test_ranksearch.py
# ---------------------------------------------------------------------------
RANK_CASES = {
    "target-cr": (4096, 4096, dict(target_cr=100.0), None),
    "paper-default": (4096, 11008, {}, None),
    "error-budget-0.95": (128, 64, dict(max_error=0.95, ranks=(2, 4, 8)), 0),
    "error-budget-0.5": (128, 64, dict(max_error=0.5, ranks=(2, 4, 8)), 0),
    "tie-break": (512, 512, dict(target_cr=30.0, ds=(2, 3), ranks=(4, 8)), 7),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_search_spec_matches_repro(case):
    n_in, n_out, kw, seed = RANK_CASES[case]
    w = None if seed is None else np.random.default_rng(seed).standard_normal((n_out, n_in))
    want = jrs.search_spec(n_in, n_out, weight=w, **kw)
    got = trs.search_spec(n_in, n_out, weight=None if w is None else torch.from_numpy(w), **kw)
    assert (got.spec.in_modes, got.spec.out_modes, got.spec.ranks) == \
        (want.spec.in_modes, want.spec.out_modes, want.spec.ranks)
    assert got.cr == want.cr
    assert (got.rel_error is None) == (want.rel_error is None)
    if want.rel_error is not None:
        assert abs(got.rel_error - want.rel_error) <= 1e-9
    assert trs.spec_for_layer(n_in, n_out) == tttd.TTSpec(*dataclasses.astuple(
        jrs.spec_for_layer(n_in, n_out)))


# ---------------------------------------------------------------------------
# compression_report (Table I)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_compression_report_matches_repro(arch):
    for param_bits in (None, 16):
        want = jcomp.compression_report(jget(arch), param_bits)
        got = tcomp.compression_report(tget(arch), param_bits)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("block_cr", "network_cr", "network_cr_with_embed", "network_cr_bits"):
            assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("arch,block,network,wo,gate,deploy", [
    ("chatglm3-6b", 10.72, 1.94, 481.88, 1446.44, 2.09),
    ("llama2-7b", 4.01, 1.80, 481.88, 1007.89, 2.25),
])
def test_table1_and_deploy_bits_pins(arch, block, network, wo, gate, deploy):
    from benchmarks.table1_cr import DEPLOY_BITS
    from repro_torch.serve.steps import serve_config_of
    rep = tcomp.compression_report(tget(arch))
    crs = {r.role: r.cr for r in rep.roles}
    assert abs(rep.block_cr - block) < 0.01 and abs(rep.network_cr - network) < 0.01
    assert abs(crs["wo"] - wo) < 0.01
    assert abs(crs["gate" if arch == "chatglm3-6b" else "down"] - gate) < 0.01
    dep = tcomp.compression_report(serve_config_of(tget(arch)), param_bits=16)
    assert abs(dep.network_cr_bits - deploy) < 0.005
    assert DEPLOY_BITS[arch] == deploy


# ---------------------------------------------------------------------------
# compress_model on reduced llama2-7b and chatglm3-6b (f32, full-rank TT)
# ---------------------------------------------------------------------------
_SETUPS = {}


def _setup(arch):
    """Dense reduced params (4 layers, f32) from repro's layout, both
    packages' ``compress_model`` of them for a target with TT (d 2, full
    rank) on blocks 2-3 and int4 (group 32) elsewhere."""
    if arch not in _SETUPS:
        base = jget(arch, reduced=True).replace(n_layers=4, compute_dtype="float32",
                                                param_dtype="float32")
        jt = base.replace(ttd=JTTD(enabled=True, rank=10 ** 6, d=2, first_tt_block=2),
                          quant=JQuant(enabled=True, bits=4, group_size=32))
        jd = base.replace(ttd=JTTD(enabled=False), quant=JQuant(enabled=False))
        td, tt = (config_from_dict(config_to_dict(c)) for c in (jd, jt))
        jdense = jax_params(jd, seed=3)
        tdense = params_from_jax(jax.device_get(jdense), td, device="cpu")
        jtree = jax.device_get(jcomp.compress_model(jdense, jd, jt, svd_method="svd"))
        ttree = tcomp.compress_model(tdense, td, tt, svd_method="svd")
        _SETUPS[arch] = dict(jd=jd, jt=jt, td=td, tt=tt, jtree=jtree, ttree=ttree,
                             tdense=tdense)
    return _SETUPS[arch]


def _named(tree):
    from repro.checkpoint.store import _flatten_with_paths
    return dict(_flatten_with_paths(tree))


def _tt_linears(tcfg):
    """(segment, layer, path to the linear, its TTSpec) of every TT linear."""
    for si, seg in enumerate(ttf.specs_tree(tcfg)["segments"]):
        for li, layer in enumerate(seg):
            for group, linears in (("attn", layer["attn"]), ("mlp", layer["mlp"])):
                for nm, sp in linears.items():
                    if isinstance(sp, LinearSpec) and sp.kind == "tt":
                        yield si, li, (group, nm), sp.tt


@pytest.mark.parametrize("arch", ["llama2-7b", "chatglm3-6b"])
def test_compress_model_matches_repro(arch):
    s = _setup(arch)
    got = _named(params_to_jax(s["ttree"], s["tt"]))
    want = _named(s["jtree"])
    assert list(got) == list(want)
    assert {n: _dtype(a) for n, a in got.items()} == {n: _dtype(a) for n, a in want.items()}
    assert [len(seg) for seg in s["ttree"]["segments"]] == [2, 2]  # re-split at block 2
    n_int4 = 0
    for name, a in got.items():
        if name.endswith(("/qweight", "/scales")):
            np.testing.assert_array_equal(_bits(a), _bits(want[name]), err_msg=name)
            n_int4 += 1
    assert n_int4 == 2 * (7 + 3)  # segment 0 all seven linears, segment 1 q/k/v
    n_tt = 0
    for si, li, (group, nm), spec in _tt_linears(s["tt"]):
        mine = s["ttree"]["segments"][si][li][group][nm]["cores"]
        ref = [np.asarray(c[li], np.float64) for c in s["jtree"]["segments"][si][group][nm]["cores"]]
        rec = tttd.tt_reconstruct(tttd.matrices_to_cores([c.double() for c in mine], spec), spec)
        jrec = jttd.tt_reconstruct(jttd.matrices_to_cores(ref, _jspec(spec)), _jspec(spec))
        assert _rel(rec.numpy(), jrec) <= 1e-6, (si, li, nm)
        n_tt += 1
    assert n_tt == 2 * 4


def _paged_logits(s):
    """Two prefill chunks and two decode steps of 3 slots through both
    packages' paged paths on their compressed trees."""
    jcfg, tcfg = s["jt"], s["tt"]
    tparams = s["ttree"]
    jparams = jax.tree.map(jnp.asarray, s["jtree"])
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
    out = []
    for c in range(2):
        sl = slice(c * chunk, (c + 1) * chunk)
        jl, jcache = jtf.prefill_paged_chunk(jparams, jcfg, jcache, jnp.asarray(toks[:, sl]),
                                             jnp.asarray(bt), jnp.asarray(pos[:, sl]))
        tl, tcache = ttf.prefill_paged_chunk(tparams, tcfg, tcache,
                                             torch.from_numpy(toks[:, sl]),
                                             torch.from_numpy(bt), torch.from_numpy(pos[:, sl]))
        out.append((tl, jl))
    for step in range(2):
        dpos = np.array([2 * chunk + step, 5 + step, -1], np.int32)
        dtok = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)
        jl, jcache = jtf.decode_step_paged(jparams, jcfg, jcache, jnp.asarray(dtok),
                                           jnp.asarray(bt), jnp.asarray(dpos))
        tl, tcache = ttf.decode_step_paged(tparams, tcfg, tcache, torch.from_numpy(dtok),
                                           torch.from_numpy(bt), torch.from_numpy(dpos))
        out.append((tl, jl))
    return out


@pytest.mark.parametrize("arch", ["llama2-7b", "chatglm3-6b"])
def test_compressed_trees_serve_equal_logits(arch):
    for got, want in _paged_logits(_setup(arch)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_walk_errors_match_repro():
    for walk in (jcomp._walk, tcomp._walk):
        with pytest.raises(ValueError, match=r"'segments'.*3 param.*2 spec"):
            walk({"segments": [{"x": 1}, {"x": 2}, {"x": 3}]}, {"segments": [None, None]},
                 "auto")
        assert walk({"segments": [{"x": 1}, {"x": 2}]}, {"segments": [None, None]},
                    "auto") == {"segments": [{"x": 1}, {"x": 2}]}
        with pytest.raises(ValueError, match=r"'segments\[0\]/mlp'"):
            walk({"segments": [{"mlp": [1, 2]}]}, {"segments": [{"mlp": [None]}]}, "auto")
        with pytest.raises(ValueError, match=r"\['atn'\].*'segments\[0\]'"):
            walk({"segments": [{"attn": {"x": 1}}]}, {"segments": [{"atn": None}]}, "auto")


def _error_lines(err: ValueError, per_layer: bool) -> tuple[str, set[str]]:
    """The refusal's header and its set of leaf lines, the port's per-layer
    paths (segments[s][l]) folded to repro's stacked ones (segments[s])."""
    head, *lines = str(err).split("\n  ")
    if per_layer:
        lines = [re.sub(r"(segments\[\d+\])\[\d+\]", r"\1", ln) for ln in lines]
    return head, set(lines)


@pytest.mark.parametrize("other", ["tt-off", "d3", "tt-embed"])
def test_validate_refuses_a_tree_compressed_for_another_spec(other):
    s = _setup("chatglm3-6b")
    jt = s["jt"]
    jother = {"tt-off": jt.replace(ttd=JTTD(enabled=False)),
              "d3": jt.replace(ttd=dataclasses.replace(jt.ttd, d=3)),
              "tt-embed": jt.replace(ttd=dataclasses.replace(jt.ttd, embed=True))}[other]
    tother = config_from_dict(config_to_dict(jother))
    with pytest.raises(ValueError) as je:
        jcomp.validate_compressed_params(jother, s["jtree"])
    with pytest.raises(ValueError) as te:
        tcomp.validate_compressed_params(tother, s["ttree"])
    assert _error_lines(te.value, True) == _error_lines(je.value, False)
    tcomp.validate_compressed_params(s["tt"], s["ttree"])


# ---------------------------------------------------------------------------
# Step 0: f32 TT cores (what compress_model writes) under bf16 activations
# ---------------------------------------------------------------------------
def _step0_case(tcores, spec, rng):
    """The port's plain tt_linear and repro's ``ref`` path on the same f32
    cores with bf16 x; the card takes the fused kernel for such a call."""
    assert all(c.dtype == torch.float32 for c in tcores)
    assert ttk.fused_route(spec, torch.bfloat16, [c.dtype for c in tcores])
    x = rng.standard_normal((2, 7, spec.n_in)).astype(np.float32)
    got = ttk.tt_linear(torch.from_numpy(x).to(torch.bfloat16), tcores, spec)
    want = jdispatch.tt_linear(jnp.asarray(x, jnp.bfloat16),
                               [jnp.asarray(c.numpy()) for c in tcores], _jspec(spec),
                               backend="ref")
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    assert np.abs(got - want).mean() < 1e-2


@pytest.mark.parametrize("arch", ["llama2-7b", "chatglm3-6b"])
def test_f32_cores_under_bf16_activations_match_repro_ref(arch):
    """On a ``compress_model`` tree at the reduced recipe (d 3, rank 4: f32
    cores) and at ChatGLM3-6B's full-width gate spec (rank 16)."""
    s = _setup(arch)
    tt = s["tt"].replace(ttd=dataclasses.replace(s["tt"].ttd, rank=4, d=3))
    tree = tcomp.compress_model(s["tdense"], s["td"], tt)
    rng = np.random.default_rng(6)
    specs = list(_tt_linears(tt))
    assert len(specs) == 8
    for si, li, (group, nm), spec in specs:
        _step0_case(tree["segments"][si][li][group][nm]["cores"], spec, rng)
    gate = ttf.make_block_specs(tget("chatglm3-6b"), True).mlp_d()["gate"].tt
    g = torch.Generator().manual_seed(1)
    _step0_case([torch.randn(shp, generator=g) / math.sqrt(shp[0])
                 for shp in gate.core_matrix_shapes()], gate, rng)


# ---------------------------------------------------------------------------
# The recovery bound of chip_smoke.py's compression phase
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("in_m,out_m", [((4, 4, 4, 4), (2, 2, 4, 27)),    # gate/up-like
                                        ((27, 4, 2, 2), (4, 4, 4, 4)),    # down-like
                                        ((4, 4, 4, 4), (2, 4, 4, 8))])    # attn_o-like
def test_planted_tt_recovered_from_bf16_within_bound(in_m, out_m):
    """TT-SVD of bf16(W), W a planted rank-r TT weight made of bf16 cores,
    recovers W within (1 + sqrt(d - 1)) * ||bf16(W) - W||: each of the d - 1
    truncations discards at most ||bf16(W) - W|| (W's unfoldings have rank
    <= r), so ||TT(bf16 W) - bf16 W|| <= sqrt(d - 1) ||bf16(W) - W||, and the
    triangle inequality adds the rounding once.  chip_smoke.py gates every
    TT linear of ChatGLM3-6B on this factor; at these reduced widths the
    measured ratio is 0.19-0.25, far inside it."""
    spec = _spec(in_m, out_m, 8)
    g = torch.Generator().manual_seed(0)
    mats = [(torch.randn(shp, generator=g) / math.sqrt(shp[0])).to(torch.bfloat16)
            for shp in spec.core_matrix_shapes()]
    w = tttd.tt_reconstruct(tttd.matrices_to_cores([c.double() for c in mats], spec), spec)
    w16 = w.to(torch.bfloat16)
    cores = tttd.tt_svd(w16.float(), spec)
    rec = tttd.tt_reconstruct(tttd.matrices_to_cores(
        [c.float().double() for c in tttd.cores_to_matrices(cores, spec)], spec), spec)
    rounding = float(torch.linalg.norm(w16.double() - w) / torch.linalg.norm(w))
    err = float(torch.linalg.norm(rec - w) / torch.linalg.norm(w))
    factor = 1 + math.sqrt(spec.d - 1)
    assert 0 < rounding < 4e-3
    assert err <= factor * rounding, (err, rounding)
    assert err <= 0.5 * rounding  # the measured ratio, with room
