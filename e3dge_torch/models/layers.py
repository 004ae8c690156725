"""StyleGAN2 / StyleSDF building blocks — counterpart of
`e3dge_tpu/models/layers.py` (reference stylesdf_model.py:30-584), with the
reference's state_dict names.

As in the JAX package every layer computes in its INPUT dtype: parameters are
f32 masters cast at use, and demodulation statistics stay f32, so casting the
activations to bf16 at a pipeline boundary switches a whole stack to bf16.
`ModulatedConv2d` uses the JAX package's shared-weight form
y_b = demod_b * conv(x_b * s_b, scale * W), which equals the reference's grouped
per-sample conv; the s2d phase-space modes (a TPU layout rewrite) are not ported.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from e3dge_torch.ops import blur, fused_leaky_relu, make_kernel, upsample2x


def pixel_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=dim, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """Equalized-lr linear (stylesdf_model.py:210-249)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: bool = False, zero_init: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_dim, in_dim) if zero_init else torch.randn(out_dim, in_dim) / lr_mul
        )
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init))) if bias else None
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul, self.activation, self.bias_init = lr_mul, activation, bias_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ (self.weight * self.scale).to(x.dtype).t()
        if self.bias is not None:
            b = (self.bias * self.lr_mul).to(x.dtype)
            return fused_leaky_relu(out, b) if self.activation else out + b
        return fused_leaky_relu(out, None) if self.activation else out


class MappingLinear(nn.Module):
    """Kaiming-init mapping layer with a scale-1 fused lrelu (stylesdf_model.py:40-82)."""

    def __init__(self, in_dim: int, out_dim: int, activation: bool = True, is_last: bool = False):
        super().__init__()
        gain = math.sqrt(2.0 / 1.04) * (0.25 if is_last else 1.0)
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim) * gain / math.sqrt(in_dim))
        bound = math.sqrt(1.0 / in_dim)
        self.bias = nn.Parameter(torch.empty(out_dim).uniform_(-bound, bound))
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.activation:
            return fused_leaky_relu(x @ w.t(), b, scale=1.0)
        return x @ w.t() + b


class EqualConv2d(nn.Module):
    """Equalized-lr conv (stylesdf_model.py:168-207). NCHW."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_channel, in_channel, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x, (self.weight * self.scale).to(x.dtype), stride=self.stride, padding=self.padding)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype).reshape(1, -1, 1, 1)
        return out


class ModulatedConv2d(nn.Module):
    """StyleGAN2 modulated conv (stylesdf_model.py:263-362)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int, style_dim: int,
                 demodulate: bool = True, upsample: bool = False, blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, out_channel, in_channel, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.kernel_size, self.demodulate, self.upsample = kernel_size, demodulate, upsample
        self.blur_taps = len(blur_kernel)
        self.register_buffer("blur_kernel", make_kernel(blur_kernel), persistent=False)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        s = self.modulation(style)  # [B, in]
        w = self.scale * self.weight  # f32 master
        if self.demodulate:
            wmod = w * s.float()[:, None, :, None, None]
            demod = torch.rsqrt(torch.sum(wmod * wmod, dim=(2, 3, 4)) + 1e-8).to(x.dtype)  # [B, out]
        x = x * s.to(x.dtype)[:, :, None, None]
        w = w[0].to(x.dtype)
        if self.upsample:
            # conv_transpose (stride 2) then the FIR blur with the upsample gain
            out = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
            if self.demodulate:
                out = out * demod[:, :, None, None]
            p = (self.blur_taps - 2) - (k - 1)
            return blur(out, self.blur_kernel, pad=((p + 1) // 2 + 1, p // 2 + 1), upsample_factor=2)
        out = F.conv2d(x, w, padding=k // 2)
        if self.demodulate:
            out = out * demod[:, :, None, None]
        return out


class NoiseInjection(nn.Module):
    """image + weight * noise (stylesdf_model.py:365-466); the noise is drawn
    from `generator` when not given."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, image: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if noise is None:
            b, _, h, w = image.shape
            noise = torch.randn(b, 1, h, w, device=image.device, dtype=image.dtype, generator=generator)
        return image + self.weight.to(image.dtype) * noise.to(image.dtype)


class FusedLeakyReLU(nn.Module):
    """Bias + lrelu * sqrt(2); holds the reference's `activate.bias` ([C])."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias.to(x.dtype))


class StyledConv(nn.Module):
    """ModulatedConv2d + noise + fused lrelu (stylesdf_model.py:469-507)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int, style_dim: int,
                 upsample: bool = False, blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size, style_dim,
                                    upsample=upsample, blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)

    def forward(self, x, style, noise=None, generator=None):
        out = self.noise(self.conv(x, style), noise, generator)
        return self.activate(out)


class ToRGB(nn.Module):
    """1x1 modulated conv (no demod) + the upsampled skip (stylesdf_model.py:510-541)."""

    def __init__(self, in_channel: int, style_dim: int, upsample: bool = True,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), out_channels: int = 3):
        super().__init__()
        self.upsample = upsample
        self.conv = ModulatedConv2d(in_channel, out_channels, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, out_channels, 1, 1))
        self.register_buffer("blur_kernel", make_kernel(blur_kernel), persistent=False)

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias.to(x.dtype)
        if skip is not None:
            if self.upsample:
                skip = upsample2x(skip, self.blur_kernel)
            out = out + skip
        return out


class ConvLayer(nn.Sequential):
    """Discriminator conv block: optional blur-downsample + equalized conv +
    fused lrelu (stylesdf_model.py:544-584); torch Sequential indices skip the
    parameter-free blur, as the reference's do."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int, downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), bias: bool = True, activate: bool = True):
        layers: list[nn.Module] = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(_Blur(blur_kernel, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size, stride=stride, padding=padding,
                                  bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channel) if bias else _LeakyReLU())
        super().__init__(*layers)


class _Blur(nn.Module):
    def __init__(self, taps: Sequence[int], pad: tuple[int, int]):
        super().__init__()
        self.pad = pad
        self.register_buffer("kernel", make_kernel(taps), persistent=False)

    def forward(self, x):
        return blur(x, self.kernel, self.pad)


class _LeakyReLU(nn.Module):
    def forward(self, x):
        return fused_leaky_relu(x, None)
