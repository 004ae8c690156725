"""E0 — the pSp-style FPN encoder over an IR-SE-50 backbone; counterpart of
`e3dge_tpu/models/encoders/fpn.py` (reference `HybridGradualStyleEncoder_V2`,
fpn_encoders.py:266-432, and the IR-SE blocks of helpers.py:104-224), with the
reference's state_dict names.

Taps c128@block2, c64@block6, c32@block20, c16@block23 feed an FPN
(p32/p64/p128: 1x1 laterals + bilinear upsample-add); 9 renderer W+ rows come
from p32 and 10 decoder rows from one block on p128, repeated. Outputs are
offsets that `E3DGE.image2latents` adds to the mean latents.

BatchNorm follows flax's: running statistics in eval mode, batch statistics
and a running-stat update in train mode (stage-1 training). The dtype-following
primitives here (`Conv2d`, `BatchNorm2d`, `PReLU`) compute in their input's
dtype from f32 parameters, as every layer of the JAX package does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.config import EncoderConfig
from port_bench.reference.models.layers import EqualLinear
from port_bench.reference.ops import interpolate_bilinear


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input dtype (f32 parameters cast at use).
    A bf16 convolution on the CPU runs as the f32 convolution of its bf16
    operands, rounded to bf16 (f32 accumulation, as the bf16 kernels do): the
    CPU's own bf16 convolution returns a wrong weight gradient for a 1x1
    input at stride 2 (E0's last map2style conv at tiny sizes; torch 2.13)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        padding = self.padding
        if self.padding_mode != "zeros":
            x, padding = F.pad(x, self._reversed_padding_repeated_twice, mode=self.padding_mode), 0
        if x.dtype == torch.bfloat16 and x.device.type == "cpu":
            return F.conv2d(x.float(), w.float(), None if b is None else b.float(), self.stride, padding,
                            self.dilation, self.groups).to(x.dtype)
        return F.conv2d(x, w, b, self.stride, padding, self.dilation, self.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with `flax.linen.BatchNorm`'s semantics (momentum 0.9,
    `e3dge_tpu/models/encoders/fpn.py:88-112`), f32 arithmetic, output in the
    input dtype. Eval mode normalises by the running statistics. Train mode
    normalises by the batch's mean and BIASED variance and folds both into the
    running statistics as 0.9 * running + 0.1 * batch (torch's own train mode
    folds in the unbiased variance, which flax does not). The variance is
    torch's `var_mean`, the statistic flax takes as E[x^2] - E[x]^2, with
    less cancellation. One rank: the batch is the whole batch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class PReLU(nn.PReLU):
    """Per-channel PReLU on axis 1 in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype).reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x >= 0, x, a * x)


class BlockSpecIR(NamedTuple):
    in_channel: int
    depth: int
    stride: int


def get_blocks(num_layers: int) -> list[BlockSpecIR]:
    """IR-SE bottleneck layout (helpers.py:104-130), flattened."""
    table = {
        50: [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)],
        100: [(64, 64, 3), (64, 128, 13), (128, 256, 30), (256, 512, 3)],
        152: [(64, 64, 3), (64, 128, 8), (128, 256, 36), (256, 512, 3)],
    }
    blocks = []
    for in_ch, depth, num_units in table[num_layers]:
        blocks.append(BlockSpecIR(in_ch, depth, 2))
        blocks.extend(BlockSpecIR(depth, depth, 1) for _ in range(num_units - 1))
    return blocks


class SEModule(nn.Module):
    """Squeeze-and-excitation gate (helpers.py:133-160)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc1 = Conv2d(channels, mid, 1, bias=False)
        self.fc2 = Conv2d(mid, channels, 1, bias=False)

    def forward(self, x):
        s = torch.mean(x, dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class BottleneckIR(nn.Module):
    """bottleneck_IR(_SE) (helpers.py:162-224): res_layer = [bn, conv3x3, prelu,
    conv3x3/stride, bn, (se)]; shortcut = strided identity (MaxPool2d(1, s)) or
    [conv1x1/stride, bn]."""

    def __init__(self, in_channel: int, depth: int, stride: int, se: bool = True):
        super().__init__()
        self.stride = stride
        if in_channel == depth:
            self.shortcut_layer = None
        else:
            self.shortcut_layer = nn.Sequential(
                Conv2d(in_channel, depth, 1, stride=stride, bias=False), BatchNorm2d(depth)
            )
        layers = [
            BatchNorm2d(in_channel),
            Conv2d(in_channel, depth, 3, padding=1, bias=False),
            PReLU(depth),
            Conv2d(depth, depth, 3, stride=stride, padding=1, bias=False),
            BatchNorm2d(depth),
        ]
        if se:
            layers.append(SEModule(depth))
        self.res_layer = nn.Sequential(*layers)

    def forward(self, x):
        if self.shortcut_layer is None:
            shortcut = x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


class GradualStyleBlock(nn.Module):
    """map2style: log2(spatial) stride-2 convs + LeakyReLU(0.01) to 1x1, then
    EqualLinear (helpers.py:472-497); conv indices 0, 2, 4, ... as upstream."""

    def __init__(self, in_c: int, out_c: int, spatial: int):
        super().__init__()
        layers: list[nn.Module] = []
        for i in range(int(math.log2(spatial))):
            layers += [Conv2d(in_c if i == 0 else out_c, out_c, 3, stride=2, padding=1), nn.LeakyReLU(0.01)]
        self.convs = nn.Sequential(*layers)
        self.linear = EqualLinear(out_c, out_c)
        self.out_c = out_c

    def forward(self, x):
        return self.linear(self.convs(x).reshape(x.shape[0], self.out_c))


class HybridGradualStyleEncoderV2(nn.Module):
    """The released E0 (fpn_encoders.py:266-432)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = c = cfg
        self.input_layer = nn.Sequential(
            Conv2d(c.input_nc, 64, 3, padding=1, bias=False), BatchNorm2d(64), PReLU(64)
        )
        self.body = nn.Sequential(
            *[BottleneckIR(s.in_channel, s.depth, s.stride, se=(c.mode == "ir_se")) for s in get_blocks(c.num_layers)]
        )
        self.latlayer256 = Conv2d(256, 512, 1)
        self.latlayer128 = Conv2d(128, 512, 1)
        self.styles_pigan = nn.ModuleList(
            [GradualStyleBlock(512, c.style_dim, c.fpn_pigan_geo_layer_dim) for _ in range(c.pigan_geo_layer)]
            + [GradualStyleBlock(512, c.style_dim, c.fpn_pigan_tex_layer_dim)
               for _ in range(c.pigan_geo_layer, c.pigan_tex_layer)]
        )
        if c.full_pipeline:
            self.latlayer64 = Conv2d(64, 512, 1)
            # the V2 forward uses block 0 on p128, repeated (fpn_encoders.py:417-419)
            self.styles_stylegan = nn.ModuleList([GradualStyleBlock(512, c.decoder_style_dim, c.input_res // 2)])

    def forward(self, x: torch.Tensor, return_featmap: bool = False):
        c = self.cfg
        h = self.input_layer(x)
        taps = {}
        for i, block in enumerate(self.body):
            h = block(h)
            if i == 2:
                taps["c128"] = h
            elif i == 6:
                taps["c64"] = h
            elif i == 20:
                taps["c32"] = h
            elif i == 23:
                taps["c16"] = h

        def upsample_add(a, b):
            return interpolate_bilinear(a, b.shape[2:], align_corners=True) + b

        p32 = upsample_add(taps["c16"], self.latlayer256(taps["c32"]))
        p64 = upsample_add(p32, self.latlayer128(taps["c64"]))
        latents = []
        for j, block in enumerate(self.styles_pigan):
            # tex styles read p64 only when the tex dim is literally 64 (fpn_encoders.py:407)
            src = p64 if j >= c.pigan_geo_layer and c.fpn_pigan_tex_layer_dim == 64 else p32
            latents.append(block(src))
        thumb_out = torch.stack(latents, dim=1)
        stylegan_out = None
        if c.full_pipeline:
            p128 = upsample_add(p64, self.latlayer64(taps["c128"]))
            s0 = self.styles_stylegan[0](p128)
            stylegan_out = s0[:, None].expand(-1, c.n_styles_decoder, -1)
        if return_featmap:
            return {"pred_latents": [thumb_out, stylegan_out], "feat_maps": p64, "p32": p32}
        return [thumb_out, stylegan_out]
