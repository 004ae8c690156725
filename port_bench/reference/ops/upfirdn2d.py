"""upfirdn2d — UPsample, FIR filter, DowNsample (the StyleGAN2 resampling
primitive) — counterpart of `e3dge_tpu/ops/upfirdn2d.py`.

The plain StyleGAN2 math (reference `op/upfirdn2d.py:157-200`, the pure
fallback): zero-insertion upsample by `up`, zero pad by `pad` (negative =
crop), 2D convolution with the *flipped* kernel as a depthwise conv, then
stride-`down` subsampling. The JAX package's fused/phased XLA rewrites
(`fuse_fir_upsample`, `conv2d_up_fused`, `conv_transpose2x_blur_phased`) are TPU
layout rewrites of the same function and are not ported.

The depthwise FIR is an autograd function whose backward is the same FIR
(flipped kernel, full padding), so every derivative, the R1 penalty's double
backward included, runs as a forward depthwise conv: on the card, cuDNN's own
double backward of a grouped conv dominated the full-res D's R1 step (see
chip_smoke.py phase 8's profile of that step).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_kernel(k) -> torch.Tensor:
    """Normalized 2D FIR kernel from 1D or 2D taps (reference
    `stylesdf_model.py:85-93`): 1D taps are outer-producted, then the kernel is
    scaled to unit sum. Returns a CPU float32 tensor; modules keep it as a
    non-persistent buffer so it follows `.to(device)`."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return torch.from_numpy(k / np.sum(k))


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class _DepthwiseFir(torch.autograd.Function):
    """Valid correlation of each channel of [B, C, H, W] with a constant
    [kh, kw] kernel; its gradient is the same op with the kernel flipped on
    the gradient padded by (kh - 1, kw - 1)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(kernel)
        c = x.shape[1]
        weight = kernel.to(x.dtype).reshape(1, 1, *kernel.shape).expand(c, 1, *kernel.shape)
        return F.conv2d(x.contiguous(), weight, groups=c)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (kernel,) = ctx.saved_tensors
        kh, kw = kernel.shape
        grad = F.pad(grad, [kw - 1, kw - 1, kh - 1, kh - 1])
        return _DepthwiseFir.apply(grad, torch.flip(kernel, (0, 1))), None


def upfirdn2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: int | tuple[int, int] = 1,
    down: int | tuple[int, int] = 1,
    pad: tuple[int, ...] = (0, 0),
) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, (H*up_y + pad_y0 + pad_y1 - kh)//down_y + 1, ...].

    pad is (pad0, pad1) for both axes or (x0, x1, y0, y1)."""
    up_y, up_x = _pair(up)
    down_y, down_x = _pair(down)
    if len(pad) == 2:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad[0], pad[1], pad[0], pad[1]
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad
    b, c, h, w = x.shape
    kh, kw = kernel.shape

    if up_y > 1 or up_x > 1:  # zero insertion, trailing zeros included
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, [0, up_x - 1, 0, 0, 0, up_y - 1])
        x = x.reshape(b, c, h * up_y, w * up_x)
    x = F.pad(x, [max(pad_x0, 0), max(pad_x1, 0), max(pad_y0, 0), max(pad_y1, 0)])
    x = x[
        :,
        :,
        max(-pad_y0, 0) : x.shape[2] - max(-pad_y1, 0),
        max(-pad_x0, 0) : x.shape[3] - max(-pad_x1, 0),
    ]
    out = _DepthwiseFir.apply(x, torch.flip(kernel, (0, 1)).to(device=x.device))
    return out[:, :, ::down_y, ::down_x]


def upsample2x(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """FIR 2x upsample (reference `Upsample`)."""
    factor = 2
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel * factor**2, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def blur(
    x: torch.Tensor, kernel: torch.Tensor, pad: tuple[int, int], upsample_factor: int = 1
) -> torch.Tensor:
    """FIR blur with the upsample gain (reference `Blur`)."""
    k = kernel * upsample_factor**2 if upsample_factor > 1 else kernel
    return upfirdn2d(x, k, pad=pad)
