"""Stacked-hourglass image filter, the E1 local feature extractor; counterpart of
`e3dge_tpu/models/pifu/hourglass.py` (reference PIFu `ConvBlock` / `HourGlass` /
`HGFilter`, net_util.py:399-453, HGFilters.py:6-188): group norm, ave-pool
downsampling, bicubic (align_corners=True) upsampling. The JAX package runs it
NHWC inside for the TPU; here it is NCHW throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from e3dge_torch.models.encoders.fpn import Conv2d
from e3dge_torch.ops import interpolate_bicubic


class GroupNorm(nn.GroupNorm):
    """GroupNorm with f32 statistics and the input's dtype out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


def group_norm(channels: int) -> GroupNorm:
    """torch GroupNorm(32, C); configs too narrow for 32 groups fall back to
    min(4, C) — the JAX package's rule (`hourglass.py:52-56`), which the tiny
    configs depend on."""
    groups = 32 if channels % 32 == 0 and channels >= 32 else min(4, channels)
    return GroupNorm(groups, channels, eps=1e-5)


class ConvBlock(nn.Module):
    """PIFu residual block: three 3x3 convs giving out/2 + out/4 + out/4
    channels, concatenated, plus the (1x1-projected) shortcut."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        o2, o4 = out_planes // 2, out_planes // 4
        self.bn1, self.conv1 = group_norm(in_planes), Conv2d(in_planes, o2, 3, padding=1, bias=False)
        self.bn2, self.conv2 = group_norm(o2), Conv2d(o2, o4, 3, padding=1, bias=False)
        self.bn3, self.conv3 = group_norm(o4), Conv2d(o4, o4, 3, padding=1, bias=False)
        if in_planes != out_planes:
            # the reference shares bn4 as downsample.0, so a released state
            # dict holds its parameters under both names
            self.bn4 = group_norm(in_planes)
            self.downsample = nn.Sequential(self.bn4, nn.ReLU(), Conv2d(in_planes, out_planes, 1, bias=False))
        else:
            self.downsample = None

    def forward(self, x):
        out1 = self.conv1(torch.relu(self.bn1(x)))
        out2 = self.conv2(torch.relu(self.bn2(out1)))
        out3 = self.conv3(torch.relu(self.bn3(out2)))
        out = torch.cat([out1, out2, out3], dim=1)
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual


class HourGlass(nn.Module):
    """Recursive hourglass of `depth` pool/upsample levels (HGFilters.py:6-67)."""

    def __init__(self, depth: int, features: int = 256):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            self.add_module(f"b1_{level}", ConvBlock(features, features))
            self.add_module(f"b2_{level}", ConvBlock(features, features))
            if level == 1:
                self.add_module(f"b2_plus_{level}", ConvBlock(features, features))
            self.add_module(f"b3_{level}", ConvBlock(features, features))

    def _forward(self, level: int, inp: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"b1_{level}")(inp)
        low1 = getattr(self, f"b2_{level}")(F.avg_pool2d(inp, 2))
        if level > 1:
            low2 = self._forward(level - 1, low1)
        else:
            low2 = getattr(self, f"b2_plus_{level}")(low1)
        low3 = getattr(self, f"b3_{level}")(low2)
        up2 = interpolate_bicubic(low3, (low3.shape[2] * 2, low3.shape[3] * 2), align_corners=True)
        return up1 + up2

    def forward(self, x):
        return self._forward(self.depth, x)


class HGFilter(nn.Module):
    """Stacked hourglass filter, ave_pool stem (HGFilters.py:70-188):
    [B, C_in, H, W] -> the last stack's [B, hourglass_dim, H/4, W/4]."""

    def __init__(self, in_channels: int = 64, num_stack: int = 4, num_hourglass: int = 2,
                 hourglass_dim: int = 256):
        super().__init__()
        self.num_stack = num_stack
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3)
        self.bn1 = group_norm(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_stack):
            self.add_module(f"m{i}", HourGlass(num_hourglass, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", group_norm(256))
            self.add_module(f"l{i}", Conv2d(256, hourglass_dim, 1))
            if i < num_stack - 1:
                self.add_module(f"bl{i}", Conv2d(256, 256, 1))
                self.add_module(f"al{i}", Conv2d(hourglass_dim, 256, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = F.avg_pool2d(self.conv2(h), 2)
        h = self.conv4(self.conv3(h))
        previous = h
        out = None
        for i in range(self.num_stack):
            hg = getattr(self, f"m{i}")(previous)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = torch.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            if i < self.num_stack - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) + getattr(self, f"al{i}")(out)
        return out
