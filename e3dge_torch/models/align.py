"""Alignment and fusion of the E1 local branch; counterpart of
`e3dge_tpu/models/align.py` (reference helper_modules/resnetfc.py, sft.py,
helpers.py, alignment_old.py), under the reference's state_dict names.

The live path's modules: `ResnetBlockFC`, `FuseSftMLP` and the ADA
`ResidualAligner`. The ablation variants: the HFGI `ResidualEncoder` and its
plain bottleneck (`BottleneckIRPlain`), the dense-correspondence
`FeatureAligner` with `feature_l2_norm` and `correlation_volume`,
`DemodulatedConv2d`, the conv SFT fusion (`ConvResBlock`, `FuseSftBlock`),
`ResidualConvBlock` and `AlignInpainterFusionBlock`. Their BatchNorm is
`fpn.BatchNorm2d`: flax's semantics, and in train mode inside a
data-parallel step (`parallel.mesh.sharded`) the global batch's statistics.
The JAX package computes every one of them outside any Pallas kernel, so
they are convolutions (cuDNN on the card) and one batched product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from e3dge_torch.models.encoders.fpn import BatchNorm2d, BottleneckIR, Conv2d, PReLU
from e3dge_torch.models.layers import EqualConv2d
from e3dge_torch.ops import interpolate_bilinear, scaled_leaky_relu


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


def _norm(channels: int, norm: str) -> nn.Module:
    """BatchNorm2d (flax semantics, rank-synced in train mode) for "batch", no
    normalisation for "none"."""
    return {"batch": BatchNorm2d, "none": lambda c: nn.Identity()}[norm](channels)


class BottleneckIRPlain(nn.Module):
    """bottleneck_IR without SE, its norm selectable (`align.py:108`,
    helpers.py:162-198): res_layer = [norm, conv3x3, prelu, conv3x3/stride,
    norm]; shortcut = strided identity or [conv1x1/stride, norm]. With norm
    "none" the norms are identities in their places (the same indices)."""

    def __init__(self, in_channel: int, depth: int, stride: int, norm: str = "batch"):
        super().__init__()
        self.stride = stride
        self.shortcut_layer = None if in_channel == depth else nn.Sequential(
            Conv2d(in_channel, depth, 1, stride=stride, bias=False), _norm(depth, norm))
        self.res_layer = nn.Sequential(
            _norm(in_channel, norm), Conv2d(in_channel, depth, 3, padding=1, bias=False), PReLU(depth),
            Conv2d(depth, depth, 3, stride=stride, padding=1, bias=False), _norm(depth, norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x[:, :, :: self.stride, :: self.stride] if self.shortcut_layer is None else self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


def _stage(in_c: int, chans, norm: str) -> nn.Sequential:
    blocks = []
    for depth, stride in chans:
        blocks.append(BottleneckIRPlain(in_c, depth, stride, norm))
        in_c = depth
    return nn.Sequential(*blocks)


def _stem(in_c: int, out_c: int, norm: str) -> nn.Sequential:
    """conv3x3 -> norm -> PReLU, the reference's `conv_layer1` (indices 0, 1, 2)."""
    return nn.Sequential(Conv2d(in_c, out_c, 3, padding=1, bias=False), _norm(out_c, norm), PReLU(out_c))


class ResidualEncoder(nn.Module):
    """The HFGI consultation encoder (`align.py:138`, alignment_old.py:
    402-452): the aligned residual [B, 3, H, W] -> (scale, shift), each [B,
    cond_channels, cond_res, cond_res], the conditions of the decoder's
    feature pyramid (the Decoder condition hook, stylesdf_model.py:777-778)."""

    def __init__(self, cond_channels: int = 512, cond_res: int = 64, norm: str = "batch"):
        super().__init__()
        self.cond_res = cond_res
        self.conv_layer1 = _stem(3, 32, norm)
        self.conv_layer2 = _stage(32, [(48, 2), (48, 1), (48, 1)], norm)
        self.conv_layer3 = _stage(48, [(64, 2), (64, 1), (64, 1)], norm)
        for name in ("condition_scale3", "condition_shift3"):
            # the reference's Sequential(EqualConv2d, ScaledLeakyReLU, EqualConv2d): indices 0 and 2
            setattr(self, name, nn.Sequential(EqualConv2d(64, cond_channels, 3, padding=1), _ScaledLeakyReLU(),
                                              EqualConv2d(cond_channels, cond_channels, 3, padding=1)))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.conv_layer3(self.conv_layer2(self.conv_layer1(x)))
        size = (self.cond_res, self.cond_res)
        return (interpolate_bilinear(self.condition_scale3(h), size, align_corners=False),
                interpolate_bilinear(self.condition_shift3(h), size, align_corners=False))


class _ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return scaled_leaky_relu(x)


def feature_l2_norm(feature: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Channel-wise L2 normalisation (`align.py:210`, reference FeatureL2Norm,
    alignment_old.py:65-79)."""
    return feature / torch.sqrt(torch.sum(feature**2, dim=1, keepdim=True) + eps)


def correlation_volume(feature_a: torch.Tensor, feature_b: torch.Tensor) -> torch.Tensor:
    """The dense correlation volume (`align.py:217`, reference
    CorrelationVolume, alignment_old.py:43-63): [B, C, H, W] x [B, C, H, W]
    -> [B, H*W, H, W], out[b, q, i, j] = <feature_a[b, :, q's pixel],
    feature_b[b, :, i, j]>, where q runs over feature_a's pixels in
    column-major order (q = w * H + h), as the reference's transpose does."""
    b, c, h, w = feature_a.shape
    fa = feature_a.transpose(2, 3).reshape(b, c, h * w)  # column-major
    fb = feature_b.reshape(b, c, h * w).transpose(1, 2)  # [B, HW, C]
    return torch.bmm(fb, fa).reshape(b, h, w, h * w).permute(0, 3, 1, 2)


class FeatureAligner(nn.Module):
    """The dense-correspondence ablation aligner (`align.py:228`, reference
    FeatureAligner, alignment_old.py:500-612): context convs of the residual
    (3 ch), the ref features (ref_feats_dim ch, one 3x3 conv; none when
    None), the query depth (1 ch) and the query thumb (3 ch), each to
    context_dim, concatenated, through a small U-net -> a 32-ch map at the
    input resolution. A forward passes the inputs the constructor named."""

    def __init__(self, norm: str = "batch", context_dim: int = 8, ref_feats_dim: int | None = None,
                 with_depth: bool = True, with_thumb: bool = True):
        super().__init__()
        from e3dge_torch.models.pifu.local_net import context_conv

        d = context_dim
        self.residual_conv = context_conv(3, d)
        self.downsample_channel_conv = None if ref_feats_dim is None else Conv2d(ref_feats_dim, d, 3, padding=1,
                                                                                  bias=False)
        self.depth_conv = context_conv(1, d) if with_depth else None
        self.que_thumb_conv = context_conv(3, d) if with_thumb else None
        n_parts = 1 + sum(m is not None for m in (self.downsample_channel_conv, self.depth_conv, self.que_thumb_conv))
        self.conv_layer1 = _stem(d * n_parts, 32, norm)
        self.conv_layer2 = _stage(32, [(48, 2), (48, 1), (48, 1)], norm)
        self.conv_layer3 = _stage(48, [(64, 2), (64, 1), (64, 1)], norm)
        self.dconv_layer1 = _stage(64 + 48, [(64, 1), (32, 1), (32, 1)], norm)
        self.dconv_layer2 = _stage(32 + 32, [(32, 1), (32, 1)], norm)

    def forward(self, residual_images: torch.Tensor, que_depth: torch.Tensor | None = None,
                ref_feats: torch.Tensor | None = None, que_thumb_images: torch.Tensor | None = None) -> torch.Tensor:
        parts = [self.residual_conv(residual_images)]
        for conv, x in ((self.downsample_channel_conv, ref_feats), (self.depth_conv, que_depth),
                        (self.que_thumb_conv, que_thumb_images)):
            if (conv is None) != (x is None):
                raise ValueError("FeatureAligner: pass exactly the inputs its constructor named")
            if conv is not None:
                parts.append(conv(x))
        h = torch.cat(parts, dim=1)
        res = h.shape[-1]
        feat1 = self.conv_layer1(h)
        feat2 = self.conv_layer2(feat1)
        feat3 = interpolate_bilinear(self.conv_layer3(feat2), (res // 2, res // 2), align_corners=False)
        dfea1 = interpolate_bilinear(self.dconv_layer1(torch.cat([feat3, feat2], 1)), (res, res), align_corners=False)
        return self.dconv_layer2(torch.cat([dfea1, feat1], 1))


class DemodulatedConv2d(nn.Module):
    """The style-free demodulated conv (`align.py:282`, reference
    helper_modules/helpers.py:14-80, the ADA aligner's `--ada_norm_layer
    demodulate`): weight [1, out, in, k, k] ~ N(0, 1), each output channel's
    kernel scaled to unit norm (rsqrt(sum w^2 + 1e-8)); without a style
    every batch entry shares it, so one convolution."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 bias: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.randn(1, out_channel, in_channel, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.randn(out_channel)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[0] * torch.rsqrt(torch.sum(self.weight**2, dim=(2, 3, 4)) + 1e-8)[0][:, None, None, None]
        out = F.conv2d(x, w.to(x.dtype), stride=self.stride, padding=self.padding)
        return out if self.bias is None else out + self.bias.to(out.dtype).reshape(1, -1, 1, 1)


class _GroupNorm(nn.GroupNorm):
    """GroupNorm with f32 statistics and the input's dtype out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class ConvResBlock(nn.Module):
    """CodeFormer's conv ResBlock (`align.py:315`, reference
    helper_modules/sft.py:18-54): GroupNorm(32) (min(4, C) groups for a
    width 32 does not divide, the JAX package's rule), swish, 3x3 conv,
    twice, plus the input (1x1 `conv_out` when the widths differ)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()

        def norm(c):
            return _GroupNorm(32 if c % 32 == 0 and c >= 32 else min(4, c), c, eps=1e-6)

        self.norm1, self.conv1 = norm(in_channels), Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2, self.conv2 = norm(out_channels), Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_out = Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        h = self.conv1(h * torch.sigmoid(h))
        h = self.norm2(h)
        h = self.conv2(h * torch.sigmoid(h))
        return h + (x if self.conv_out is None else self.conv_out(x))


class FuseSftBlock(nn.Module):
    """The conv variant of the SFT fusion (`align.py:343`, reference
    Fuse_sft_block, sft.py:56-80): dec + w * (dec * scale(h) + shift(h)),
    h = ConvResBlock(cat(enc, dec)), each branch conv3x3 -> LeakyReLU(0.2)
    -> conv3x3 (indices 0 and 2)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.encode_enc = ConvResBlock(in_ch, out_ch)
        self.scale = nn.Sequential(Conv2d(out_ch, out_ch, 3, padding=1), nn.LeakyReLU(0.2),
                                   Conv2d(out_ch, out_ch, 3, padding=1))
        self.shift = nn.Sequential(Conv2d(out_ch, out_ch, 3, padding=1), nn.LeakyReLU(0.2),
                                   Conv2d(out_ch, out_ch, 3, padding=1))

    def forward(self, enc_feat: torch.Tensor, dec_feat: torch.Tensor, w: float = 1.0) -> torch.Tensor:
        h = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=1))
        return dec_feat + w * (dec_feat * self.scale(h) + self.shift(h))


class ResidualConvBlock(nn.Module):
    """norm -> relu -> reflect-padded 3x3 conv, twice, plus the input (1x1
    `short_cut` when the widths differ) (`align.py:363`, reference
    helpers.py:318-397; the instance norm a per-channel GroupNorm)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.norm1 = _GroupNorm(dim_in, dim_in, eps=1e-5)
        self.conv1 = Conv2d(dim_in, dim_out, 3, padding=1, padding_mode="reflect", bias=False)
        self.norm2 = _GroupNorm(dim_out, dim_out, eps=1e-5)
        self.conv2 = Conv2d(dim_out, dim_out, 3, padding=1, padding_mode="reflect", bias=False)
        self.short_cut = Conv2d(dim_in, dim_out, 1, bias=False) if dim_in != dim_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(torch.relu(self.norm1(x)))
        h = self.conv2(torch.relu(self.norm2(h)))
        return h + (x if self.short_cut is None else self.short_cut(x))


class AlignInpainterFusionBlock(nn.Module):
    """The visibility-mask lerp of 3D-projected and inpainted 2D features,
    then a `ResidualConvBlock` (`align.py:390`, reference alignment_old.py:
    455-496; a fusion ablation). proj_3dfeats, inpainted_2dfeats [B, C, H,
    W], visibility_mask broadcastable; reshape returns [B, H, W, 1, C], the
    reference's permute and unsqueeze."""

    def __init__(self, channels: int):
        super().__init__()
        self.fusionBlock = ResidualConvBlock(channels, channels)

    def forward(self, proj_3dfeats: torch.Tensor, inpainted_2dfeats: torch.Tensor, visibility_mask: torch.Tensor,
                reshape: bool = True) -> torch.Tensor:
        fused = visibility_mask * proj_3dfeats + (1.0 - visibility_mask) * inpainted_2dfeats
        fused = self.fusionBlock(fused)
        return fused.permute(0, 2, 3, 1)[:, :, :, None, :] if reshape else fused
