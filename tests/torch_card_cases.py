"""Configs past a hand kernel's limit, one for each refusal of
``repro_torch.kernels.dispatch.check_card_support``, with the backend they
are served through and the text the refusal must carry.  Shared by the card
test (``make_session`` on the card) and its CPU counterpart
(``check_card_support`` handed a CUDA device without a card)."""
from repro_torch.configs import get_config
from repro_torch.serve.steps import serve_config_of

REFUSALS = {
    "int4_f32": "int4_matmul takes bf16 activations",
    "int4_group": "int4_matmul takes K % 32 == 0 and group % 16 == 0",
    "wkv_head_dim": "wkv_scan takes head dims (16, 32, 64)",
    "paged_head_dim": "paged_attention (decode) takes head_dim (64, 128)",
    "ring_head_dim": "ring_attention takes head_dim (64, 128, 256)",
}


def refused_config(case: str):
    """(config, backend, the limit its refusal names) for a ``REFUSALS`` key."""
    import dataclasses
    llama = serve_config_of(get_config("llama2-7b"))  # int4 on blocks 0-12 and q/k/v
    cfg, backend = {
        "int4_f32": (llama.replace(compute_dtype="float32"), "paged"),
        "int4_group": (llama.replace(quant=dataclasses.replace(llama.quant, group_size=8)),
                       "paged"),
        "wkv_head_dim": (serve_config_of(get_config("rwkv6-7b")).replace(rwkv_head_dim=128),
                         "recurrent"),
        "paged_head_dim": (llama.replace(head_dim=112), "paged"),  # kimi-k2's head_dim
        "ring_head_dim": (llama.replace(head_dim=112, window=4096), "ring"),
    }[case]
    return cfg, backend, REFUSALS[case]
