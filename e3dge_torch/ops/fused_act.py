"""Fused bias-add + leaky-ReLU (x sqrt(2) gain) — counterpart of
`e3dge_tpu/ops/fused_act.py` (reference `op/fused_act.py:106-118`).

Plain tensor math: the StyleGAN2 CUDA op it stands for is an elementwise
epilogue, and the JAX package wrote no kernel for it either.
"""

from __future__ import annotations

import math

import torch

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(
    x: torch.Tensor,
    bias: torch.Tensor | None = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
) -> torch.Tensor:
    """leaky_relu(x + bias) * scale; bias broadcasts over axis 1 for rank >= 3
    (NCHW / NCL) and over the last axis for rank <= 2."""
    if bias is not None:
        if x.ndim >= 3:
            shape = (1, -1) + (1,) * (x.ndim - 2)
        else:
            shape = (1,) * (x.ndim - 1) + (-1,)
        x = x + bias.reshape(shape)
    return torch.where(x >= 0, x, x * negative_slope) * scale


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """leaky_relu(x) * sqrt(2) (reference `ScaledLeakyReLU`)."""
    return torch.where(x >= 0, x, x * negative_slope) * SQRT2
