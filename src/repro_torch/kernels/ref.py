"""Plain PyTorch versions of the ported kernels, under ``repro``'s names.

Each lives beside its kernel (``kernels/<name>.py``); this module re-exports
them with the signatures of ``repro.kernels.ref`` so the parity tests call
both packages the same way.
"""
from .int4_matmul import int4_matmul_ref as int4_matmul  # noqa: F401
from .paged_attention import gather_paged_kv  # noqa: F401
from .paged_attention import paged_attention_plain as paged_attention  # noqa: F401
from .tt_linear import tt_linear_ref as tt_linear_bn_res  # noqa: F401
from .prefill_attention import ring_attention_plain as ring_attention  # noqa: F401
from .scan_rglru import rglru_scan_plain as rglru_scan  # noqa: F401
from .scan_wkv import wkv_scan_plain as wkv_scan  # noqa: F401
from .tt_embed import tt_embed_plain as tt_embedding  # noqa: F401
