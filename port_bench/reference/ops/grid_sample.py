"""Bilinear sampling, resizes and pools — counterpart of
`e3dge_tpu/ops/grid_sample.py` and the pools of `e3dge_tpu/models/e3dge.py:46-76`.

The JAX package wrote these as separable matmuls and row gathers because that is
what a TPU runs fast; the functions are the torch semantics they emulate, so
here they are the torch calls themselves. `grid_sample_mm` (a TPU lowering of
the same bilinear sample) has no counterpart: the port has one sampler, and
`grid_sample_3d` its trilinear twin.
`tests/test_torch_ops.py` holds each against its JAX function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [B, C, H, W] at [B, Hg, Wg, 2] (x, y) locations in
    [-1, 1]: zeros padding, align_corners=False -> [B, C, Hg, Wg] in x's dtype.
    The sample runs in f32 whatever x's dtype, as the JAX sampler computes its
    corner indices and weights from f32 coordinates: rounding the coordinates
    to a bf16 feature map's dtype moves samples by up to 1/4 texel on a
    64-wide map."""
    return F.grid_sample(
        x.float(), grid.float(), mode="bilinear", padding_mode="zeros", align_corners=False
    ).to(x.dtype)


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
    """torch.nn.AdaptiveAvgPool2d to (out, out), the reference's pool (its
    256^2 and 64^2 adapters `pool_256` / `pool_64`, datasetgan_runner.py:56-57,
    and `gt_pool`, utils/transform.py:3). The JAX function
    (`e3dge.py:46-69`) emulates it for sizes that divide, as a box filter or
    a nearest repeat, and the same two are taken here; any other size pools
    by AdaptiveAvgPool2d's bins. NoW's 224^2 crops into a 256^2 model are
    such a size: the JAX function keeps 224 there going up and raises going
    down (ROADMAP §C)."""
    h = x.shape[-1]
    if h == out:
        return x
    if h > out and h % out == 0:
        return F.avg_pool2d(x, h // out)
    if h < out and out % h == 0:
        return upsample_nearest(x, out)
    return adaptive_avg_pool2d(x, (out, out))


def adaptive_avg_pool2d(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool2d on NCHW with its exact bin rule: output cell
    i averages input rows floor(i * in / out) .. ceil((i + 1) * in / out) - 1,
    for any sizes, up or down (`e3dge_tpu/ops/grid_sample.py:285-307`; the ID
    loss pools a 188^2 face crop to 112^2)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.adaptive_avg_pool2d(x, tuple(size))


def upsample_nearest(x: torch.Tensor, out: int) -> torch.Tensor:
    """Nearest upsample by an integer factor to (out, out) (`e3dge.py:72-76`)."""
    f = out // x.shape[-1]
    return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
