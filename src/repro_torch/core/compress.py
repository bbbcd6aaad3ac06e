"""Whole-model compression pipeline (the paper's §V.A recipe), counterpart of
``repro.core.compress``.

``compress_model(dense_params, dense_cfg, target_cfg)`` converts a dense
checkpoint into the target config's parameterization, layer by layer on the
dense params' device:

  * linears whose target spec is ``tt``   -> TT-SVD cores (Algorithm 1), f32
  * linears whose target spec is ``int4`` -> packed int4 + bf16 group scales
  * linears whose target spec is ``dense`` -> an f32 copy
  * everything else (norms, embedding table, head, biases) -> the dense
    tree's tensors, shared rather than copied

so the leaf dtypes are the reference's.  ``compression_report(cfg)``
computes Table-I-style CR accounting without any weights, and
``save_compressed`` / ``load_compressed`` hand a compressed tree, with the
config it serves under, across checkpoints in ``repro``'s on-disk format.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from .._device import resolve_device
from ..config import ModelConfig, QuantConfig, TTDConfig, config_from_dict, config_to_dict
from ..models.modules import LinearSpec, embed_spec, linear_param_bits, linear_param_count
from .quant import quantize_int4
from .ttd import cores_to_matrices, tt_svd


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------
def _convert_linear(p_dense: dict[str, Any], spec: LinearSpec, svd_method: str):
    """p_dense: {"w": (..., n_in, n_out)[, "b"]} -> target params subtree.

    An embedding table rides the same path: ``{"table": (V, D)}`` is a
    transposed linear ``w`` (the TT's (M, N) weight has M = V), so the
    shared ``flat[i].T`` below hands TT-SVD the (V, D) matrix directly.
    """
    if "table" in p_dense:
        if spec.kind != "tt":
            raise ValueError(
                f"embedding tables only compress to TT cores, got {spec.kind!r}")
        w = p_dense["table"].to(torch.float32).T  # (D, V) ~ (n_in, n_out)
    else:
        w = p_dense["w"].to(torch.float32)
    lead = tuple(w.shape[:-2])
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))

    def stacked(parts):
        return torch.stack(parts).reshape(lead + parts[0].shape) if lead else parts[0]

    out: dict[str, Any] = {}
    if spec.kind == "dense":
        out["w"] = p_dense["w"].to(torch.float32, copy=True)
    elif spec.kind == "tt":
        per_core: list[list[torch.Tensor]] = [[] for _ in range(spec.tt.d)]
        for i in range(flat.shape[0]):
            mats = cores_to_matrices(tt_svd(flat[i].T, spec.tt, method=svd_method), spec.tt)
            for k, m in enumerate(mats):
                per_core[k].append(m.to(torch.float32))
        out["cores"] = [stacked(cs) for cs in per_core]
    elif spec.kind == "int4":
        qs = [quantize_int4(flat[i].T, spec.quant_group) for i in range(flat.shape[0])]
        out["qweight"] = stacked([q["qweight"] for q in qs])
        out["scales"] = stacked([q["scales"] for q in qs])
    else:
        raise ValueError(spec.kind)
    if "b" in p_dense:
        out["b"] = p_dense["b"]
    return out


def _walk(p_dense, spec_tree, svd_method, path=""):
    if isinstance(spec_tree, LinearSpec):
        return _convert_linear(p_dense, spec_tree, svd_method)
    if spec_tree is None:
        return p_dense
    if isinstance(spec_tree, dict):
        missing = set(spec_tree) - set(p_dense)
        if missing:
            # a dangling spec key would otherwise drop its conversion silently
            raise ValueError(
                f"compress: spec keys {sorted(missing)} at "
                f"{path or '<root>'!r} have no matching param entries")
        return {k: _walk(p_dense[k], spec_tree[k], svd_method,
                         f"{path}/{k}" if path else k) if k in spec_tree
                else p_dense[k] for k in p_dense}
    if isinstance(spec_tree, (list, tuple)):
        if len(p_dense) != len(spec_tree):
            # a silent zip here would drop trailing layers uncompressed
            raise ValueError(
                f"compress: param/spec tree length mismatch at "
                f"{path or '<root>'!r}: {len(p_dense)} param entries vs "
                f"{len(spec_tree)} spec entries")
        return [_walk(p, s, svd_method, f"{path}[{i}]")
                for i, (p, s) in enumerate(zip(p_dense, spec_tree))]
    raise TypeError(type(spec_tree))


def _model(cfg: ModelConfig):
    """The module that builds ``cfg``'s params."""
    if cfg.family in ("dense", "moe"):
        from ..models import transformer
        return transformer
    if cfg.family == "griffin":
        from ..models import griffin
        return griffin
    if cfg.family == "rwkv":
        from ..models import rwkv
        return rwkv
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported yet (dense, moe, griffin, rwkv "
        "are)")


def _specs_tree(cfg: ModelConfig):
    return _model(cfg).specs_tree(cfg)


def compress_model(dense_params, dense_cfg: ModelConfig, target_cfg: ModelConfig,
                   svd_method: str = "auto"):
    """Dense params -> the target (TT/int4) parameterization, on the dense
    params' device."""
    tree = _specs_tree(target_cfg)
    if target_cfg.family in ("dense", "moe"):
        from ..models.transformer import segment_plan
        # re-split the dense layer stack to the target segment boundaries
        layers = [layer for seg in dense_params["segments"] for layer in seg]
        segs, off = [], 0
        for n, _ in segment_plan(target_cfg):
            segs.append(layers[off:off + n])
            off += n
        dense_params = dict(dense_params)
        dense_params["segments"] = segs
    return _walk(dense_params, tree, svd_method)


# ---------------------------------------------------------------------------
# CR accounting (Table I reproduction)
# ---------------------------------------------------------------------------
@dataclass
class RoleReport:
    role: str
    kind: str
    n_in: int
    n_out: int
    dense_params: int
    params: int
    bits: int

    @property
    def cr(self) -> float:
        return self.dense_params / max(self.params, 1)


@dataclass
class CompressionReport:
    name: str
    roles: list[RoleReport] = field(default_factory=list)
    block_dense: int = 0  # params of one (uncompressed) block
    block_comp: int = 0  # params of one compressed block
    n_blocks: int = 0
    n_tt_blocks: int = 0
    embed_params: int = 0  # dense embedding storage (table counted once when tied)
    embed_params_comp: int = 0  # after TT embed compression (== embed_params when off)
    block_bits_dense: int = 0
    block_bits_comp: int = 0

    @property
    def block_cr(self) -> float:
        return self.block_dense / max(self.block_comp, 1)

    @property
    def network_cr(self) -> float:
        """Paper convention: transformer blocks only."""
        total_dense = self.n_blocks * self.block_dense
        total_comp = (self.n_tt_blocks * self.block_comp
                      + (self.n_blocks - self.n_tt_blocks) * self.block_dense)
        return total_dense / max(total_comp, 1)

    @property
    def network_cr_with_embed(self) -> float:
        total_dense = self.n_blocks * self.block_dense + self.embed_params
        total_comp = (self.n_tt_blocks * self.block_comp
                      + (self.n_blocks - self.n_tt_blocks) * self.block_dense
                      + self.embed_params_comp)
        return total_dense / max(total_comp, 1)

    @property
    def network_cr_bits(self) -> float:
        total_dense = self.n_blocks * self.block_bits_dense
        total_comp = (self.n_tt_blocks * self.block_bits_comp
                      + (self.n_blocks - self.n_tt_blocks) * self.block_bits_dense)
        return total_dense / max(total_comp, 1)


_DTYPE_BITS = {"float32": 32, "bfloat16": 16, "float16": 16}


def compression_report(cfg: ModelConfig, param_bits: int | None = None) -> CompressionReport:
    """Per-role + block + network CR for a transformer-family config (the
    paper's Table I columns).

    ``param_bits`` is the dense baseline's storage width, derived from
    ``cfg.param_dtype`` unless given.  Compressed kinds count their own
    widths per role (int4 weights 4 bits + 16-bit group scales, TT cores
    ``param_bits``) via ``linear_param_bits``.  An MoE block lists its router
    and its ``expert_*`` roles, each expert role counted ``n_experts`` times
    in the block's totals.
    """
    from ..models.transformer import block_linear_specs, segment_plan

    if param_bits is None:
        param_bits = _DTYPE_BITS.get(cfg.param_dtype, 32)
    rep = CompressionReport(name=cfg.name)
    rep.n_blocks = cfg.n_layers
    rep.n_tt_blocks = sum(n for n, tt in segment_plan(cfg) if tt)
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    rep.embed_params = cfg.vocab_size * cfg.d_model + head
    esp = embed_spec(cfg)
    rep.embed_params_comp = (
        (esp.tt.n_params() if esp is not None else cfg.vocab_size * cfg.d_model)
        + head)  # an untied head stays dense under TT embed compression

    def roles(bs):
        if bs.moe is None:
            return list(bs.attn + bs.mlp)
        return list(bs.attn) + [("router", bs.moe["router"])] + [
            (f"expert_{nm}", sp) for nm, sp in bs.moe["expert"].items()]

    comp = block_linear_specs(cfg, ttd_block=True)
    base = block_linear_specs(cfg.replace(ttd=TTDConfig(enabled=False),
                                          quant=QuantConfig(enabled=False)), ttd_block=False)
    for (nm, sp), (_, sp0) in zip(roles(comp), roles(base)):
        mult = cfg.n_experts if nm.startswith("expert_") else 1
        rr = RoleReport(role=nm, kind=sp.kind, n_in=sp.n_in, n_out=sp.n_out,
                        dense_params=linear_param_count(sp0),
                        params=linear_param_count(sp),
                        bits=linear_param_bits(sp, param_bits))
        rep.roles.append(rr)
        rep.block_dense += mult * rr.dense_params
        rep.block_comp += mult * rr.params
        rep.block_bits_dense += mult * linear_param_bits(sp0, param_bits)
        rep.block_bits_comp += mult * rr.bits
    return rep


# ---------------------------------------------------------------------------
# Compression -> serving handoff.  A compressed tree is only interpretable
# together with the target cfg it was compressed for (the specs ride the
# cfg, not the tree), so the checkpoint carries the cfg in its manifest and
# loading validates structure eagerly instead of failing inside a step.
# ---------------------------------------------------------------------------
_KIND_KEYS = {"dense": ("w",), "tt": ("cores",), "int4": ("qweight", "scales")}


def validate_compressed_params(cfg: ModelConfig, params) -> None:
    """Raise ``ValueError`` naming every leaf where ``params`` does not
    structurally match ``cfg``'s spec tree (wrong kind, missing keys)."""
    errs: list[str] = []

    def walk(p, s, path):
        if isinstance(s, LinearSpec):
            want = set(_KIND_KEYS[s.kind]) | ({"b"} if s.bias else set())
            have = set(p) if isinstance(p, dict) else set()
            if want - have:
                kinds = [k for k, keys in _KIND_KEYS.items() if set(keys) <= have]
                got = f"a {kinds[0]!r} subtree" if kinds else f"keys {sorted(have)}"
                errs.append(f"{path or '<root>'}: expected {s.kind!r} linear "
                            f"(keys {sorted(want)}), tree has {got}")
            elif s.kind == "tt" and len(p["cores"]) != s.tt.d:
                errs.append(f"{path or '<root>'}: {len(p['cores'])} TT cores "
                            f"vs spec d={s.tt.d}")
            return
        if s is None:
            return
        if isinstance(s, dict):
            if not isinstance(p, dict) or set(s) - set(p):
                errs.append(f"{path or '<root>'}: missing keys "
                            f"{sorted(set(s) - set(p if isinstance(p, dict) else ()))}")
                return
            for k in s:
                walk(p[k], s[k], f"{path}/{k}" if path else k)
            return
        if len(p) != len(s):
            errs.append(f"{path or '<root>'}: {len(p)} param entries vs "
                        f"{len(s)} spec entries")
            return
        for i, (pp, ss) in enumerate(zip(p, s)):
            walk(pp, ss, f"{path}[{i}]")

    walk(params, _specs_tree(cfg), "")
    if errs:
        raise ValueError(
            f"param tree does not match config {cfg.name!r} "
            f"(ttd={'on' if cfg.ttd.enabled else 'off'}, "
            f"quant={'on' if cfg.quant.enabled else 'off'}, "
            f"tt_embed={'on' if cfg.ttd.embed else 'off'}) — was it "
            "compressed for a different spec?\n  " + "\n  ".join(errs))


def save_compressed(ckpt_dir, params, cfg: ModelConfig, *, step: int = 0):
    """Checkpoint a compressed tree together with the cfg it serves under,
    in the JAX package's layout (layers stacked on the host)."""
    from ..checkpoint.store import save_checkpoint
    from ..convert import params_to_jax
    validate_compressed_params(cfg, params)
    return save_checkpoint(ckpt_dir, step, params_to_jax(params, cfg),
                           extra={"model_config": config_to_dict(cfg)})


def load_compressed(ckpt_dir, step: int | None = None, *, device=None):
    """Load ``(params, cfg)`` saved by :func:`save_compressed` (of either
    package) onto ``device`` (the card unless ``device="cpu"``).

    The target structure is rebuilt from the cfg in the manifest on the meta
    device (no weights are drawn), then checked against the spec tree, so a
    mismatched checkpoint fails here with leaf paths, not inside a step.
    """
    from ..checkpoint.store import _flatten_with_paths, latest_step, restore_checkpoint
    from ..convert import params_from_jax, params_to_jax

    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    manifest = json.loads(
        (Path(ckpt_dir) / f"step_{step:08d}" / "manifest.json").read_text())
    extra = manifest["extra"]
    if "model_config" not in extra:
        raise ValueError(
            f"checkpoint {ckpt_dir} step {step} carries no model_config — "
            "re-save via core.compress.save_compressed so the target cfg "
            "round-trips with the tree")
    cfg = config_from_dict(extra["model_config"])
    meta = torch.device("meta")
    target = params_to_jax(_model(cfg).init_lm(cfg, generator=torch.Generator(), device=meta),
                           cfg, device=meta)
    tree, _ = restore_checkpoint(ckpt_dir, step, target)
    mismatch = [
        f"{name}: saved {tuple(got.shape)} vs spec {tuple(want.shape)}"
        for (name, got), (_, want) in zip(_flatten_with_paths(tree),
                                          _flatten_with_paths(target))
        if got.shape != want.shape]
    if mismatch:
        raise ValueError(
            f"checkpoint {ckpt_dir} step {step} does not match its own "
            f"manifest cfg {cfg.name!r}:\n  " + "\n  ".join(mismatch[:8]))
    params = params_from_jax(tree, cfg, device=device)
    validate_compressed_params(cfg, params)
    return params, cfg

