"""Bilinear sampling, resizes and pools — counterpart of
`e3dge_tpu/ops/grid_sample.py` and the pools of `e3dge_tpu/models/e3dge.py:46-76`.

The JAX package wrote these as separable matmuls and row gathers because that is
what a TPU runs fast; the functions are the torch semantics they emulate, so
here they are the torch calls themselves. `grid_sample_mm` (a TPU lowering of
the same bilinear sample) has no counterpart: the port has one sampler.
`tests/test_torch_ops.py` holds each against its JAX function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [B, C, H, W] at [B, Hg, Wg, 2] (x, y) locations in
    [-1, 1]: zeros padding, align_corners=False -> [B, C, Hg, Wg]."""
    return F.grid_sample(
        x, grid.to(x.dtype), mode="bilinear", padding_mode="zeros", align_corners=False
    )


def interpolate_bilinear(
    x: torch.Tensor, size: tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Bilinear resize of NCHW (torch semantics in both align_corners modes)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)


def interpolate_bicubic(
    x: torch.Tensor, size: tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Bicubic resize of NCHW (Keys a=-0.75, border-clamped taps) — the PIFu
    hourglass upsample (HGFilters.py:58-61). The JAX package computes it in NHWC
    (`interpolate_bicubic_nhwc`); the port's hourglass runs NCHW."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bicubic", align_corners=align_corners)


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """AdaptiveAvgPool2d for sizes that divide (the only case the pipeline hits);
    smaller inputs repeat (`e3dge.py:46-69`)."""
    h = x.shape[-1]
    if h == out:
        return x
    if h > out:
        return F.avg_pool2d(x, h // out)
    return upsample_nearest(x, out)


def upsample_nearest(x: torch.Tensor, out: int) -> torch.Tensor:
    """Nearest upsample by an integer factor to (out, out) (`e3dge.py:72-76`)."""
    f = out // x.shape[-1]
    return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
