"""L0 tensor ops of the PyTorch port (counterparts of `e3dge_tpu/ops`), plus the
hand-written field kernel's wrapper (`siren_field`)."""

from port_bench.reference.ops.fast_math import fast_sin
from port_bench.reference.ops.fused_act import fused_leaky_relu
from port_bench.reference.ops.grid_sample import (
    adaptive_avg_pool,
    adaptive_avg_pool2d,
    grid_sample,
    interpolate_bicubic,
    interpolate_bilinear,
    upsample_nearest,
)
from port_bench.reference.ops.posenc import pos_encoding
from port_bench.reference.ops.upfirdn2d import blur, make_kernel, upfirdn2d, upsample2x

__all__ = [
    "adaptive_avg_pool",
    "adaptive_avg_pool2d",
    "blur",
    "fast_sin",
    "fused_leaky_relu",
    "grid_sample",
    "interpolate_bicubic",
    "interpolate_bilinear",
    "make_kernel",
    "pos_encoding",
    "upfirdn2d",
    "upsample2x",
    "upsample_nearest",
]
