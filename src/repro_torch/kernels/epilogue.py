"""Shared epilogue math for the linear kernels and their plain versions.

The paper's TTDLinear-BN(-Res) post-processing (§III.A), in f32 whatever the
matmul or store dtype:

    y -> y * scale -> y + bias -> activation(y) -> y + residual

``ACT_CODES`` numbers the activations the same way the CUDA epilogue in
``csrc/common.cuh`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "gelu": lambda y: F.gelu(y, approximate="tanh"),
    "gelu_exact": lambda y: F.gelu(y, approximate="none"),
    "silu": F.silu,
    "relu": F.relu,
    "relu2": lambda y: torch.square(F.relu(y)),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "gelu_exact": 3, "relu": 4,
             "relu2": 5, "sigmoid": 6, "tanh": 7}


def apply_epilogue(y, *, scale=None, bias=None, residual=None,
                   activation: str | None = None) -> torch.Tensor:
    """Fused post-ops on a matmul accumulator; returns f32."""
    y = y.to(torch.float32)
    if scale is not None:
        y = y * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation is not None:
        y = ACTIVATIONS[activation](y)
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y
