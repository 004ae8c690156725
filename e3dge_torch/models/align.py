"""Alignment and fusion of the E1 local branch; counterpart of `ResnetBlockFC`,
`FuseSftMLP` and `ResidualAligner` in `e3dge_tpu/models/align.py` (reference
helper_modules/resnetfc.py, sft.py:84-109, alignment_old.py:316-398). The
ablation variants (FeatureAligner, DemodulatedConv2d, FuseSftBlock,
AlignInpainterFusionBlock, ResidualEncoder) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from e3dge_torch.models.encoders.fpn import BatchNorm2d, BottleneckIR, Conv2d, PReLU
from e3dge_torch.ops import interpolate_bilinear


class Linear(nn.Linear):
    """nn.Linear computing in the input dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class ResnetBlockFC(nn.Module):
    """relu -> fc_0 -> relu -> fc_1, plus the (linear) shortcut (resnetfc.py:6-59).

    A tuple input is the unmaterialised concat of its parts: the input matmuls
    split by weight columns (the JAX package's form). zero_init is the released
    modulation-head init: an exact no-op producer until trained."""

    def __init__(self, size_in: int, size_out: int, size_h: int | None = None, zero_init: bool = False):
        super().__init__()
        size_h = size_h or min(size_in, size_out)
        self.size_in, self.size_out = size_in, size_out
        self.fc_0 = Linear(size_in, size_h)
        self.fc_1 = Linear(size_h, size_out)
        self.shortcut = Linear(size_in, size_out, bias=False) if size_in != size_out else None
        with torch.no_grad():
            for lin in (self.fc_0, self.shortcut):
                if lin is not None:
                    if zero_init:
                        lin.weight.zero_()
                    else:
                        nn.init.kaiming_normal_(lin.weight, a=0.0, mode="fan_in")
            self.fc_0.bias.zero_()
            self.fc_1.weight.zero_()
            self.fc_1.bias.zero_()

    def forward(self, x: torch.Tensor | tuple[torch.Tensor, ...]) -> torch.Tensor:
        parts = x if isinstance(x, tuple) else (x,)
        dt = parts[0].dtype

        def split_matmul(w, pre=None):
            acc, col = None, 0
            for p in parts:
                d = p.shape[-1]
                q = (pre(p) if pre else p) @ w[:, col : col + d].to(dt).t()
                acc = q if acc is None else acc + q
                col += d
            return acc

        net = split_matmul(self.fc_0.weight, pre=torch.relu) + self.fc_0.bias.to(dt)
        dx = self.fc_1(torch.relu(net))
        if self.shortcut is None:
            xs = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        else:
            xs = split_matmul(self.shortcut.weight)
        return xs + dx


class FuseSftMLP(nn.Module):
    """SFT fusion dec + w * (dec * scale(enc') + shift(enc')), enc' =
    ResnetBlockFC(cat(enc, dec)), on last-axis feature vectors (sft.py:84-109)."""

    def __init__(self, in_ch: int, out_ch: int = 256):
        super().__init__()
        self.encode_enc = ResnetBlockFC(in_ch, out_ch)
        # reference Sequential(Linear, LeakyReLU(0.2), Linear): indices 0 and 2
        self.scale = nn.Sequential(Linear(out_ch, out_ch), nn.LeakyReLU(0.2), Linear(out_ch, out_ch))
        self.shift = nn.Sequential(Linear(out_ch, out_ch), nn.LeakyReLU(0.2), Linear(out_ch, out_ch))

    def forward(self, enc_feat: torch.Tensor, dec_feat: torch.Tensor, w: float = 1.0) -> torch.Tensor:
        h = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=-1))
        return dec_feat + w * (dec_feat * self.scale(h) + self.shift(h))


class ResidualAligner(nn.Module):
    """ADA: the occlusion-aware 2D residual alignment U-net
    (alignment_old.py:316-398): cat(residual, query thumb) 6ch -> encoder
    16/32/48/64 bottleneck_IR stages -> decoder with skips -> 3ch."""

    def __init__(self, in_ch: int = 6):
        super().__init__()
        self.conv_layer1 = nn.Sequential(Conv2d(in_ch, 16, 3, padding=1, bias=False), BatchNorm2d(16), PReLU(16))

        def stage(in_c, chans):
            blocks = []
            for depth, stride in chans:
                blocks.append(BottleneckIR(in_c, depth, stride, se=False))
                in_c = depth
            return nn.Sequential(*blocks)

        self.conv_layer2 = stage(16, [(32, 2), (32, 1), (32, 1)])
        self.conv_layer3 = stage(32, [(48, 2), (48, 1), (48, 1)])
        self.conv_layer4 = stage(48, [(64, 2), (64, 1), (64, 1)])
        self.dconv_layer1 = stage(64 + 48, [(64, 1), (32, 1), (32, 1)])
        self.dconv_layer2 = stage(32 + 32, [(32, 1), (16, 1), (16, 1)])
        self.dconv_layer3 = stage(16 + 16, [(16, 1), (3, 1), (3, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x.shape[-1]
        feat1 = self.conv_layer1(x)
        feat2 = self.conv_layer2(feat1)
        feat3 = self.conv_layer3(feat2)
        feat4 = self.conv_layer4(feat3)
        feat4 = interpolate_bilinear(feat4, (res // 4, res // 4), align_corners=False)
        dfea1 = self.dconv_layer1(torch.cat([feat4, feat3], 1))
        dfea1 = interpolate_bilinear(dfea1, (res // 2, res // 2), align_corners=False)
        dfea2 = self.dconv_layer2(torch.cat([dfea1, feat2], 1))
        dfea2 = interpolate_bilinear(dfea2, (res, res), align_corners=False)
        return self.dconv_layer3(torch.cat([dfea2, feat1], 1))
