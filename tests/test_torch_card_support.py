"""The port's up-front refusal of configs its hand kernels cannot serve, on
the CPU.

``dispatch.check_card_support`` is handed a CUDA device (no card is needed
to name one), so the refusal logic that ``make_session`` runs on the card
runs here: each config past a kernel's limit is refused with the kernel and
its limit named (``torch_card_cases``), the shipped serve configs pass, and
a CPU device checks nothing.  ``tt_linear.fused_route`` sends bf16 specs
past the fused kernel's limits to the staged kernel instead of refusing, and
f32 cores under bf16 activations to the fused kernel.
"""
import pytest
import torch
from torch_card_cases import FITTING_ARCHS, REFUSALS, refused_config

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
