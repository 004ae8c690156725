"""Discriminators; counterpart of `e3dge_tpu/models/discriminator.py`
(reference stylesdf_model.py:1193-1617): the volume-render discriminator, whose
viewpoint head is the pose estimator at inference, and the full-resolution
StyleGAN2 discriminator of stage-2.2 training, under the reference's
state_dict names.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from port_bench.reference.models.encoders.fpn import Conv2d
from port_bench.reference.models.layers import ConvLayer, EqualLinear
from port_bench.reference.ops import fused_leaky_relu
from port_bench.reference.parallel import mesh

VOLUME_D_CHANNELS = {2: 400, 4: 400, 8: 400, 16: 400, 32: 256, 64: 128, 128: 64}


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """Concat normalized (y, x) coordinate channels (stylesdf_model.py:1238-1268)."""
    b, _, h, w = x.shape
    xx = torch.linspace(-1.0, 1.0, w, device=x.device, dtype=x.dtype).reshape(1, 1, 1, w).expand(b, 1, h, w)
    yy = torch.linspace(-1.0, 1.0, h, device=x.device, dtype=x.dtype).reshape(1, 1, h, 1).expand(b, 1, h, w)
    return torch.cat([x, yy, xx], dim=1)


class _BiasLeakyReLU(nn.Module):
    """fused_leaky_relu(x, bias, scale=1) holding the reference's `activation.bias`."""

    def __init__(self, channels: int, fan_in: int):
        super().__init__()
        bound = math.sqrt(1.0 / fan_in)
        self.bias = nn.Parameter(torch.empty(channels).uniform_(-bound, bound))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias.to(x.dtype), scale=1.0)


class VolumeDiscConv(nn.Module):
    """Plain conv + optional fused lrelu(scale=1) (stylesdf_model.py:1193-1235)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, activate: bool = False):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                           bias=not activate)
        self.activation = _BiasLeakyReLU(out_channels, in_channels * kernel_size**2) if activate else None

    def forward(self, x):
        out = self.conv(x)
        return out if self.activation is None else self.activation(out)


class CoordConvLayer(nn.Module):
    """CoordConv + fused lrelu(scale=1) (stylesdf_model.py:1302-1336)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int = 3):
        super().__init__()
        padding = kernel_size // 2 if kernel_size > 2 else 0
        self.conv = nn.Module()  # reference nesting: CoordConv.conv is the Conv2d
        self.conv.conv = Conv2d(in_channel + 2, out_channel, kernel_size, padding=padding, bias=False)
        self.activation = _BiasLeakyReLU(out_channel, in_channel * kernel_size**2)

    def forward(self, x):
        return self.activation(self.conv.conv(add_coords(x)))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


class VolumeRenderResBlock(nn.Module):
    """CoordConv resblock with avg-pool downsample (stylesdf_model.py:1339-1366)."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.conv1 = CoordConvLayer(in_channel, out_channel)
        self.conv2 = CoordConvLayer(out_channel, out_channel)
        self.skip = VolumeDiscConv(in_channel, out_channel, 1) if out_channel != in_channel else None

    def forward(self, x):
        out = avg_pool2(self.conv2(self.conv1(x)))
        skip = avg_pool2(x)
        if self.skip is not None:
            skip = self.skip(skip)
        return (out + skip) / math.sqrt(2.0)


def volume_d_trunk(init_size: int = 64) -> tuple[nn.Sequential, int]:
    """The volume D's CoordConv trunk over init_size^2 thumbs down to 2x2
    (stylesdf_model.py:1369-1419's `convs`), and its output channels; the
    volume-D encoders of `encoders/factory.py` share it."""
    ch = VOLUME_D_CHANNELS
    convs = [VolumeDiscConv(3, ch[init_size], 1, activate=True)]
    in_ch = ch[init_size]
    for i in range(int(math.log2(init_size)) - 1, 0, -1):
        convs.append(VolumeRenderResBlock(in_ch, ch[2**i]))
        in_ch = ch[2**i]
    return nn.Sequential(*convs), in_ch


class VolumeRenderDiscriminator(nn.Module):
    """Progressive CoordConv D over 64-res thumbs with the GAN logit and the
    (azim, elev) regression head (stylesdf_model.py:1369-1419)."""

    def __init__(self, init_size: int = 64):
        super().__init__()
        self.convs, in_ch = volume_d_trunk(init_size)
        self.final_conv = VolumeDiscConv(in_ch, 3, 2)

    def forward(self, x: torch.Tensor):
        """-> (GAN logit [B, 1], (azim, elev) [B, 2])."""
        out = self.final_conv(self.convs(x))
        return out[:, 0:1].reshape(-1, 1), out[:, 1:].reshape(-1, 2)


class DiscResBlock(nn.Module):
    """StyleGAN2 D resblock (stylesdf_model.py:1514-1540)."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True, bias=False, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2.0)


def sg2_trunk(input_size: int = 1024, channel_multiplier: int = 2,
              channel_base: int = 512) -> tuple[nn.Sequential, int]:
    """The full-resolution StyleGAN2 D's conv trunk down to 4x4
    (stylesdf_model.py:1541-1596's `convs`, channel table :1630-1641), and its
    output channels; the D-backbone encoders of `encoders/factory.py` share
    it."""
    cb, cm = channel_base, channel_multiplier
    ch = {4: cb, 8: cb, 16: cb, 32: cb, 64: cb // 2 * cm, 128: cb // 4 * cm, 256: cb // 8 * cm,
          512: cb // 16 * cm, 1024: cb // 32 * cm}
    convs = [ConvLayer(3, ch[input_size], 1)]
    in_ch = ch[input_size]
    for i in range(int(math.log2(input_size)), 2, -1):
        convs.append(DiscResBlock(in_ch, ch[2 ** (i - 1)]))
        in_ch = ch[2 ** (i - 1)]
    return nn.Sequential(*convs), in_ch


class Discriminator(nn.Module):
    """Full-resolution StyleGAN2 D with minibatch stddev (stylesdf_model.py:
    1541-1617) over [B, 3, input_size, input_size] images -> [B, 1] logits; B
    must be a multiple of min(B, stddev_group). In a data-parallel step
    (`parallel.mesh.sharded`) the stddev groups are the global batch's, as
    JAX's D sees it, and the gradient crosses the ranks."""

    def __init__(self, input_size: int = 1024, channel_multiplier: int = 2, channel_base: int = 512,
                 stddev_group: int = 4):
        super().__init__()
        self.stddev_group = stddev_group
        self.convs, in_ch = sg2_trunk(input_size, channel_multiplier, channel_base)
        cb = channel_base
        self.final_conv = ConvLayer(in_ch + 1, cb, 3)
        self.final_linear = nn.Sequential(EqualLinear(cb * 4 * 4, cb, activation=True), EqualLinear(cb, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.convs(x)
        b, c, h, w = out.shape
        full = mesh.gather_rows(out)
        group = min(full.shape[0], self.stddev_group)
        y = full.reshape(group, -1, 1, c, h, w)
        stddev = torch.sqrt(y.var(dim=0, correction=0) + 1e-8).mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
        out = torch.cat([out, mesh.own_rows(stddev.repeat(group, 1, h, w))], dim=1)
        return self.final_linear(self.final_conv(out).reshape(b, -1))
