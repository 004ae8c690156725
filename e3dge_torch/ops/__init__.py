"""L0 tensor ops of the PyTorch port (counterparts of `e3dge_tpu/ops`), plus the
hand-written field kernel's wrapper (`siren_field`)."""

from e3dge_torch.ops.fast_math import fast_sin
from e3dge_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from e3dge_torch.ops.grid_sample import (
    adaptive_avg_pool,
    adaptive_avg_pool2d,
    grid_sample,
    grid_sample_3d,
    interpolate_bicubic,
    interpolate_bilinear,
    upsample_nearest,
)
from e3dge_torch.ops.posenc import pos_encoding
from e3dge_torch.ops.upfirdn2d import blur, downsample2x, make_kernel, upfirdn2d, upsample2x

__all__ = [
    "adaptive_avg_pool",
    "adaptive_avg_pool2d",
    "blur",
    "downsample2x",
    "fast_sin",
    "fused_leaky_relu",
    "grid_sample",
    "grid_sample_3d",
    "interpolate_bicubic",
    "interpolate_bilinear",
    "make_kernel",
    "pos_encoding",
    "scaled_leaky_relu",
    "upfirdn2d",
    "upsample2x",
    "upsample_nearest",
]
