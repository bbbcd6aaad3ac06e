"""Configs past a hand kernel's limit, one for each refusal of
``repro_torch.kernels.dispatch.check_card_support``, with the backend they
are served through and the text the refusal must carry.  Shared by the card
test (``make_session`` on the card) and its CPU counterpart
(``check_card_support`` handed a CUDA device without a card).  The
``"train"`` backend's cases (``TRAIN_REFUSALS``): configs whose trained path
reaches a hand kernel with no backward."""
from repro_torch.configs import get_config
from repro_torch.models.moe import NON_TT_EXPERTS
from repro_torch.serve.steps import serve_config_of

# The shipped configs whose full and serving forms every hand kernel takes
# (``card_limits`` finds nothing).  qwen2-vl-7b is not here: its M-RoPE is
# refused by the KV backends before any kernel limit is checked.
FITTING_ARCHS = ("llama2-7b", "chatglm3-6b", "tinyllama-1.1b", "recurrentgemma-2b",
                 "rwkv6-7b", "granite-3-8b", "phi4-mini-3.8b", "qwen1.5-110b",
                 "mixtral-8x22b", "kimi-k2-1t-a32b", "whisper-base")
# The configs the single-sequence path (``models.api.Model``, the "solo"
# backend: attention on plain ops) takes on the card: every one, qwen2-vl-7b
# among them.
SOLO_FITTING_ARCHS = FITTING_ARCHS + ("qwen2-vl-7b",)
# The refusals the solo backend keeps: those of a linear, a scan or the MoE
# experts, not of an attention kernel.
SOLO_REFUSALS = ("int4_group", "wkv_head_dim", "moe_int4_experts", "moe_dense_experts")

REFUSALS = {
    "int4_group": "int4_matmul takes K % 32 == 0 and group % 16 == 0",
    "wkv_head_dim": "wkv_scan takes head dims (16, 32, 64)",
    "paged_head_dim": "paged_attention (decode) takes head_dim (64, 112, 128, 256)",
    "ring_head_dim": "ring_attention takes head_dim (64, 112, 128, 256)",
    "moe_int4_experts": NON_TT_EXPERTS,
    "moe_dense_experts": NON_TT_EXPERTS,
}


def refused_config(case: str):
    """(config, backend, the limit its refusal names) for a ``REFUSALS`` key."""
    import dataclasses
    llama = serve_config_of(get_config("llama2-7b"))  # int4 on blocks 0-12 and q/k/v
    mixtral = serve_config_of(get_config("mixtral-8x22b"))
    no_tt_experts = dataclasses.replace(mixtral.ttd, roles=("attn_o",))
    cfg, backend = {
        "int4_group": (llama.replace(quant=dataclasses.replace(llama.quant, group_size=8)),
                       "paged"),
        "wkv_head_dim": (serve_config_of(get_config("rwkv6-7b")).replace(rwkv_head_dim=128),
                         "recurrent"),
        "paged_head_dim": (llama.replace(head_dim=96), "paged"),  # a head dim no kernel takes
        "ring_head_dim": (llama.replace(head_dim=96, window=4096), "ring"),
        "moe_int4_experts": (mixtral.replace(ttd=no_tt_experts), "ring"),
        "moe_dense_experts": (mixtral.replace(ttd=no_tt_experts,
                                              quant=dataclasses.replace(mixtral.quant,
                                                                        enabled=False)), "ring"),
    }[case]
    return cfg, backend, REFUSALS[case]


# The configs the "train" backend (train.step on the card) takes: dense
# models whose linears are TT or dense (no int4, no TT embedding).
TRAIN_FITTING_ARCHS = ("tinyllama-1.1b", "llama2-7b", "chatglm3-6b", "granite-3-8b",
                       "phi4-mini-3.8b", "qwen1.5-110b", "qwen2-vl-7b", "whisper-base")
TRAIN_REFUSALS = {
    "int4_linears": "int4_matmul has no backward on the card yet",
    "tt_embed": "tt_embed has no backward on the card yet",
    "moe_experts": "tt_linear_grouped (MoE experts) has no backward on the card yet",
    "wkv_scan": "wkv_scan has no backward on the card yet",
    "rglru_scan": "rglru_scan has no backward on the card yet",
    "whisper_int4_qkv": "int4_matmul has no backward on the card yet: its q/k/v are int4",
}


def train_refused_config(case: str):
    """(config, the kernel its "train" refusal names) for a
    ``TRAIN_REFUSALS`` key."""
    import dataclasses
    llama = get_config("llama2-7b")
    cfg = {
        "int4_linears": serve_config_of(llama),  # int4 on blocks 0-12 and q/k/v
        "tt_embed": llama.replace(ttd=dataclasses.replace(llama.ttd, embed=True)),
        "moe_experts": get_config("mixtral-8x22b"),
        "wkv_scan": get_config("rwkv6-7b"),
        "rglru_scan": get_config("recurrentgemma-2b"),
        "whisper_int4_qkv": serve_config_of(get_config("whisper-base")),
    }[case]
    return cfg, TRAIN_REFUSALS[case]
