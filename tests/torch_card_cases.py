"""Configs past a hand kernel's limit, one for each refusal of
``repro_torch.kernels.dispatch.check_card_support``, with the backend they
are served through and the text the refusal must carry.  Shared by the card
test (``make_session`` on the card) and its CPU counterpart
(``check_card_support`` handed a CUDA device without a card)."""
from repro_torch.configs import get_config
from repro_torch.models.moe import NON_TT_EXPERTS
from repro_torch.serve.steps import serve_config_of

# The shipped configs whose full and serving forms every hand kernel takes
# (``card_limits`` finds nothing).  qwen2-vl-7b is not here: its M-RoPE is
# refused by the KV backends before any kernel limit is checked.
FITTING_ARCHS = ("llama2-7b", "chatglm3-6b", "tinyllama-1.1b", "recurrentgemma-2b",
                 "rwkv6-7b", "granite-3-8b", "phi4-mini-3.8b", "qwen1.5-110b",
                 "mixtral-8x22b", "kimi-k2-1t-a32b", "whisper-base")

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
