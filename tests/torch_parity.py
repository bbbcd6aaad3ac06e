"""Shared fixtures for the repro_torch parity tests (tests/test_torch_*.py).

``jax_params`` builds a JAX param tree for a config without running
``init_lm`` (whose eager int4 quantization and TT init cost ~12 s on the
CPU): ``jax.eval_shape`` gives the tree's structure, shapes and dtypes, and
seeded numpy fills every leaf at a scale that keeps activations O(1).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import griffin as jgriffin
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtf
from repro.models import whisper as jwhisper

_INITS = {"griffin": jgriffin.init_lm, "rwkv": jrwkv.init_lm, "encdec": jwhisper.init_lm}


def _fill(name: str, in_cores: bool, shape, cfg, rng):
    if name == "qweight":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if name == "scales":  # int4 group scales: dequantized weight var ~ 1/n_in
        n_in = shape[-1] * cfg.quant.group_size
        return rng.uniform(0.5, 1.5, shape) / np.sqrt(21.0 * n_in)
    if name == "scale":  # norm gains
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name in ("b", "bias", "conv_b"):
        return 0.1 * rng.standard_normal(shape)
    if name == "lambda":  # RG-LRU decay: a = exp(-8 softplus(lambda) r) in ~0.6-0.99,
        return rng.uniform(-6.0, -2.0, shape)  # a memory of tens of steps
    if name.startswith("mu"):  # rwkv token-shift mixing coefficients
        return rng.uniform(0.2, 0.8, shape)
    if name == "decay_w0":  # rwkv decay w = exp(-exp(w0 + ...)): ~0.99 down to ~0.007
        return rng.uniform(-5.0, 1.6, shape)
    if name == "bonus_u":
        return 0.5 * rng.standard_normal(shape)
    if name in ("mix_w1", "mix_w2", "decay_w1", "decay_w2"):  # rwkv LoRAs: small offsets
        return 0.3 * rng.standard_normal(shape) / np.sqrt(shape[-2])
    if in_cores:  # per-stage variance ~constant: std = 1/sqrt(contraction rows)
        return rng.standard_normal(shape) / np.sqrt(shape[-2])
    fan = shape[-1] if name == "table" else shape[-2]  # table (V, D); w (…, in, out)
    return rng.standard_normal(shape) / np.sqrt(fan)


def jax_params(cfg, seed=0):
    """Seeded JAX param tree with ``init_lm``'s structure, shapes and dtypes
    (the dense transformer's, griffin's, rwkv's or whisper's, by the
    config's family)."""
    init = _INITS.get(cfg.family, jtf.init_lm)
    shapes = jax.eval_shape(partial(init, cfg=cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        keys = [str(p.key) for p in path if hasattr(p, "key")]
        x = _fill(keys[-1], "cores" in keys, leaf.shape, cfg, rng)
        out.append(jnp.asarray(np.asarray(x).astype(np.float32) if x.dtype != np.uint8 else x,
                               leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)
