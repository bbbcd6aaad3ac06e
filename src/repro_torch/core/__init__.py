"""Core of the port: Tensor-Train decomposition of linear layers (paper §II),
the staged-contraction layer (§III) and INT4 quantization (§V.A); the
whole-model pipeline is ``core.compress``."""

from .quant import dequantize_int4, pack_int4, quantize_int4, unpack_int4  # noqa: F401
from .tt_linear import (  # noqa: F401
    init_tt_linear,
    tt_linear_apply,
    tt_linear_from_dense,
    tt_stage_shapes,
)
from .ttd import (  # noqa: F401
    TTSpec,
    compression_ratio,
    cores_to_matrices,
    factorize,
    matrices_to_cores,
    tensorize_weight,
    tt_params,
    tt_reconstruct,
    tt_svd,
    untensorize_weight,
)
