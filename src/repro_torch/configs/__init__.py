"""Architecture registry: every config of the JAX package, mirrored."""
from importlib import import_module

_MODULES = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen1.5-110b": "qwen1_5_110b",
    "granite-3-8b": "granite_3_8b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "chatglm3-6b": "chatglm3_6b",
    "llama2-7b": "llama2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-7b": "rwkv6_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "whisper-base": "whisper_base",
}

ALL_ARCHS = tuple(_MODULES)


def _mod(name: str):
    key = name.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet; "
                       f"ported: {ALL_ARCHS}")
    return import_module(f".{_MODULES[key]}", __package__)


def get_config(name: str, reduced: bool = False):
    m = _mod(name)
    return m.reduced() if reduced else m.config()
