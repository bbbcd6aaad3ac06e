"""The port's up-front refusal of configs its hand kernels cannot serve, on
the CPU.

``dispatch.check_card_support`` is handed a CUDA device (no card is needed
to name one), so the refusal logic that ``make_session`` runs on the card
runs here: each config past a kernel's limit is refused with the kernel and
its limit named (``torch_card_cases``), the shipped serve configs pass, and
a CPU device checks nothing; MoE experts must be TT (the grouped kernel).
``tt_linear.fused_route`` sends bf16 specs past the fused kernel's limits to
the staged kernel instead of refusing, and f32 cores under bf16 activations
to the fused kernel.
"""
import pytest
import torch
from torch_card_cases import (
    FITTING_ARCHS,
    REFUSALS,
    SOLO_FITTING_ARCHS,
    SOLO_REFUSALS,
    TRAIN_FITTING_ARCHS,
    TRAIN_REFUSALS,
    refused_config,
    train_refused_config,
)

from repro_torch.configs import get_config
from repro_torch.core.ttd import TTSpec
from repro_torch.kernels import dispatch
from repro_torch.kernels import tt_linear as tk
from repro_torch.models.sessions import default_backend
from repro_torch.serve.steps import serve_config_of

CUDA = torch.device("cuda")


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refused_on_a_cuda_device_naming_the_limit(case):
    cfg, backend, limit = refused_config(case)
    with pytest.raises(ValueError, match="cannot be served on the card") as e:
        dispatch.check_card_support(cfg, CUDA, backend)
    assert limit in str(e.value)
    dispatch.check_card_support(cfg, torch.device("cpu"), backend)  # plain versions: no limit


@pytest.mark.parametrize("arch", FITTING_ARCHS)
def test_shipped_configs_fit_the_kernels(arch):
    for cfg in (get_config(arch), serve_config_of(get_config(arch))):
        assert dispatch.card_limits(cfg, default_backend(cfg)) == []


def test_solo_backend_refuses_past_linear_scan_and_expert_limits():
    """The single-sequence path's backend ("solo"), handed a CUDA device
    without a card, refuses each config past a linear, scan or expert limit,
    naming it, and passes every shipped config, qwen2-vl-7b's M-RoPE and
    head dims no attention kernel takes among them (its attention is plain
    ops)."""
    for case in SOLO_REFUSALS:
        cfg, _, limit = refused_config(case)
        with pytest.raises(ValueError, match="cannot be served on the card") as e:
            dispatch.check_card_support(cfg, CUDA, "solo")
        assert limit in str(e.value), case
    for case in sorted(set(REFUSALS) - set(SOLO_REFUSALS)):  # attention head dims
        cfg, _, _ = refused_config(case)
        assert dispatch.card_limits(cfg, "solo") == [], case
    for arch in SOLO_FITTING_ARCHS:
        for cfg in (get_config(arch), serve_config_of(get_config(arch))):
            assert dispatch.card_limits(cfg, "solo") == [], arch
            dispatch.check_card_support(cfg, CUDA, "solo")


def test_train_backend_refuses_kernels_without_backward():
    """The "train" backend (``train.step`` on the card), handed a CUDA device
    without a card, refuses each config whose trained path reaches a hand
    kernel with no backward, naming it — int4 linears (whisper's q/k/v
    among them), a TT embedding, MoE experts, the wkv and RG-LRU scans —
    and also keeps the solo backend's refusals; the dense configs whose
    linears are TT or dense pass; ``init_train_state`` refuses up front."""
    from repro_torch.config import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state
    for case, kernel in TRAIN_REFUSALS.items():
        cfg, _ = train_refused_config(case)
        with pytest.raises(ValueError, match="cannot be trained on the card") as e:
            dispatch.check_card_support(cfg, CUDA, "train")
        assert kernel in str(e.value), case
        dispatch.check_card_support(cfg, torch.device("cpu"), "train")
    for case in SOLO_REFUSALS:
        cfg, _, limit = refused_config(case)
        assert any(limit in p for p in dispatch.card_limits(cfg, "train")), case
    for arch in TRAIN_FITTING_ARCHS:
        assert dispatch.card_limits(get_config(arch), "train") == [], arch
    cfg, kernel = train_refused_config("moe_experts")
    with pytest.raises(ValueError, match="tt_linear_grouped"):
        init_train_state(build_model(cfg), TrainConfig(), 0, device=CUDA)


def test_f32_activations_fit_the_int4_kernel():
    """int4_matmul takes f32 activations (the MoE router's; repro's kernel
    takes them too), so a config computing in f32 crosses no int4 limit."""
    cfg = serve_config_of(get_config("llama2-7b")).replace(compute_dtype="float32")
    assert dispatch.card_limits(cfg, "paged") == []


def test_kimi_k2_is_refused_for_its_head_dim():
    """kimi-k2-1t-a32b's experts fit the grouped tt_linear and its head_dim
    112 fits both paged attention kernels, so its serving config has no card
    limit; a head dim that no attention kernel takes (96) is refused on the
    paged backend by name for the decode kernel and for the prefill kernel."""
    cfg = serve_config_of(get_config("kimi-k2-1t-a32b"))
    assert default_backend(cfg) == "paged"
    assert dispatch.card_limits(cfg, "paged") == []
    assert dispatch.card_limits(cfg.replace(head_dim=96), "paged") == [
        "paged_attention (decode) takes head_dim (64, 112, 128, 256); head_dim is 96",
        "prefill_attention takes head_dim (64, 112, 128, 256); head_dim is 96"]


@pytest.mark.parametrize("in_modes,out_modes,rank,dtype,fused", [
    ((16, 8, 8, 4), (4, 8, 8, 16), 16, torch.bfloat16, True),    # llama2 attn_o
    ((2,) * 9, (2,) * 9, 4, torch.bfloat16, False),               # d = 9
    ((16, 8, 8), (8, 8, 16), 48, torch.bfloat16, False),          # rank 48
    ((8, 8, 4), (4, 8, 8), 32, torch.bfloat16, True),
    ((16, 8, 8, 4), (4, 8, 8, 16), 16, torch.float32, False),     # f32: staged
])
def test_tt_linear_route_by_shape(in_modes, out_modes, rank, dtype, fused):
    spec = TTSpec.make(0, 0, rank, d=len(in_modes), in_modes=in_modes, out_modes=out_modes)
    assert tk.fused_route(spec, dtype, [dtype] * spec.d) is fused


@pytest.mark.parametrize("x_dtype,core_dtypes,rank,fused", [
    (torch.bfloat16, [torch.float32] * 4, 16, True),    # compress_model's f32 cores
    (torch.bfloat16, [torch.float32] * 4, 48, False),   # past the rank limit
    (torch.bfloat16, [torch.float32, torch.bfloat16] * 2, 16, False),  # mixed cores
    (torch.float32, [torch.float32] * 4, 16, False),    # f32 x
])
def test_tt_linear_route_of_core_dtypes(x_dtype, core_dtypes, rank, fused):
    """bf16 x takes the fused kernel on cores that are all bf16 or all f32
    (rounded to bf16 as they load, as the plain version rounds them)."""
    spec = TTSpec.make(0, 0, rank, d=4, in_modes=(16, 8, 8, 4), out_modes=(4, 8, 8, 16))
    assert tk.fused_route(spec, x_dtype, core_dtypes) is fused
