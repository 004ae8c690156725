"""E1 local network (netLocal): residual + depth context convs, the stacked
hourglass filter, the pixel-aligned query and the zero-init SFT modulation
head; counterpart of `e3dge_tpu/models/pifu/local_net.py` (reference
HGPIFuGANNet.py, HGPIFuGANNetResidualInputResnetFC.py:19-104,
HGPIFuGANNetResidualInput.py:19-103). Two variants, as JAX's: "resnetfc",
the released `HGPIFuNetGANResidualResnetFC` (InstanceNorm context convs,
zero-init ResnetBlockFC texture head), and "bn", `HGPIFuNetGANResidual` (the
stage2.2.sh netLocal_type: BatchNorm context convs, flax semantics and
rank-synced in a data-parallel step, and a zero-init EqualLinear texture
head). Optional heads: the geometry modulations (zero-init EqualLinear) and
the SurfaceClassifier of the netLocal 3D pretraining (`predict_sdf`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from e3dge_torch.config import PifuConfig
from e3dge_torch.models.align import ResnetBlockFC
from e3dge_torch.models.encoders.fpn import BatchNorm2d, Conv2d
from e3dge_torch.models.layers import EqualLinear
from e3dge_torch.models.pifu.hourglass import HGFilter
from e3dge_torch.ops import grid_sample
from e3dge_torch.render.camera import project_points
from e3dge_torch.utils.trace import span


class InstanceNorm(nn.InstanceNorm2d):
    """InstanceNorm2d(affine=True, no running stats), f32 statistics, output in
    the input dtype."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x.float(), weight=self.weight, bias=self.bias, eps=self.eps).to(x.dtype)


class _ResidualBlock(nn.Module):
    """norm -> relu -> conv3x3(reflect) -> norm -> relu -> conv3x3(reflect), plus x
    (helpers.py:318-358); `conv` indices 0..5 as upstream. norm "in" is
    InstanceNorm, "bn" BatchNorm (flax semantics, `fpn.BatchNorm2d`)."""

    def __init__(self, dim: int, norm: str = "in"):
        super().__init__()
        make = {"in": InstanceNorm, "bn": BatchNorm2d}[norm]
        self.conv = nn.Sequential(
            make(dim), nn.ReLU(), Conv2d(dim, dim, 3, padding=1, padding_mode="reflect", bias=False),
            make(dim), nn.ReLU(), Conv2d(dim, dim, 3, padding=1, padding_mode="reflect", bias=False),
        )

    def forward(self, x):
        return x + self.conv(x)


def context_conv(in_ch: int, dim: int = 32, norm: str = "in") -> nn.Sequential:
    """conv3x3(reflect) -> ResidualBlock -> conv1x1: the residual / depth context
    encoders (HGPIFuGANNetResidualInputResnetFC.py:36-45; with norm "bn",
    HGPIFuGANNetResidualInput.py:37-48)."""
    return nn.Sequential(
        Conv2d(in_ch, dim, 3, padding=1, padding_mode="reflect", bias=False),
        _ResidualBlock(dim, norm),
        Conv2d(dim, dim, 1, bias=False),
    )


class TexEqualLinear(EqualLinear):
    """The "bn" variant's texture head: an EqualLinear that also takes the
    tuple of parts `tex_modulations` gets (the fused features and the PE),
    as their concatenation."""

    def forward(self, x: torch.Tensor | tuple[torch.Tensor, ...]) -> torch.Tensor:
        return super().forward(torch.cat(x, dim=-1) if isinstance(x, tuple) else x)


class SurfaceClassifier(nn.Module):
    """Per-point SDF MLP with input skips (SurfaceClassifier.py:6-68): the
    reference's conv1d stack [C_in, 1024, 512, 256, 128, 1], layers 1..4 taking
    the input features again, leaky ReLU 0.01 between; weights [out, in, 1] as
    the reference's Conv1d, applied to [..., C_in] point features."""

    def __init__(self, in_ch: int, filter_channels: tuple[int, ...] = (1024, 512, 256, 128, 1)):
        super().__init__()
        prev = 0
        for i, ch in enumerate(filter_channels):
            self.add_module(f"conv{i}", nn.Conv1d(in_ch + prev, ch, 1))
            prev = ch
        self.n = len(filter_channels)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        y = feats
        for i in range(self.n):
            conv = getattr(self, f"conv{i}")
            inp = y if i == 0 else torch.cat([y, feats], dim=-1)
            y = inp @ conv.weight[..., 0].to(inp.dtype).t() + conv.bias.to(inp.dtype)
            if i != self.n - 1:
                y = F.leaky_relu(y, 0.01)
        return y


def depth_normalize(z: torch.Tensor, load_size: int = 256, z_size: float = 1.12) -> torch.Tensor:
    """z * (loadSize / 2) / z_size (DepthNormalizer.py:4-17)."""
    return z * (load_size // 2) / z_size


def points_in_image(points: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    """In-image mask of the projected points, [B, 3, N] -> bool [B, N]."""
    xyz = project_points(points, calibs)
    u, v = xyz[:, 0], xyz[:, 1]
    return (u >= -1.0) & (u <= 1.0) & (v >= -1.0) & (v <= 1.0)


def query_features(im_feat, points, calibs, load_size: int = 256, z_size: float = 1.12) -> dict:
    """Pixel-aligned lookup (HGPIFuGANNet.py:85-211): project [B, 3, N] world
    points, flip y to the grid_sample convention, bilinear-sample [B, C, Hf, Wf].
    Returns feats [B, C, N], z_condition [B, 1, N], proj_xy [B, 2, N],
    depth [B, 1, N], in_img [B, N]."""
    xyz = project_points(points, calibs)
    xy = torch.stack([xyz[:, 0], -xyz[:, 1]], dim=1)
    z = xyz[:, 2:3]
    in_img = (xy[:, 0] >= -1.0) & (xy[:, 0] <= 1.0) & (xy[:, 1] >= -1.0) & (xy[:, 1] <= 1.0)
    grid = xy.permute(0, 2, 1)[:, :, None, :]  # [B, N, 1, 2]
    feats = grid_sample(im_feat, grid)[..., 0]
    return {
        "feats": feats,
        "z_condition": depth_normalize(z, load_size, z_size),
        "proj_xy": xy,
        "depth": z,
        "in_img": in_img,
    }


class LocalFeatureNet(nn.Module):
    """netLocal. variant "resnetfc" is the released
    `HGPIFuNetGANResidualResnetFC` (InstanceNorm context convs + zero-init
    ResnetBlockFC texture head), "bn" is `HGPIFuNetGANResidual` (BatchNorm
    context convs + zero-init EqualLinear texture head); `E3DGE` picks it from
    `pifu.netLocal_type`, as JAX's. The BatchNorms follow the module's mode:
    `E3DGE._mode` puts the net in train mode for a training call."""

    def __init__(self, cfg: PifuConfig, modulation_width: int = 256, local_feats_dim: int = 256 + 45,
                 variant: str = "resnetfc", enable_geo_modulations: bool = False,
                 enable_surface_classifier: bool = False):
        super().__init__()
        if variant not in ("resnetfc", "bn"):
            raise ValueError(f"unknown netLocal variant {variant!r}")
        self.cfg, self.variant = cfg, variant
        self.modulation_width = modulation_width
        norm = "bn" if variant == "bn" else "in"
        self.residual_conv = context_conv(3, norm=norm)
        self.with_depth = "depth" in cfg.residual_context_feats
        if self.with_depth:
            self.depth_conv = context_conv(1, norm=norm)
        self.image_filter = HGFilter(
            in_channels=64 if self.with_depth else 32, num_stack=cfg.num_stack,
            num_hourglass=cfg.num_hourglass, hourglass_dim=cfg.hourglass_dim,
        )
        # zero-init: the modulations are an exact no-op at init
        if variant == "bn":
            self.local_feat_to_tex_modulations_linear = TexEqualLinear(
                local_feats_dim, modulation_width * 2, zero_init=True)
        else:
            self.local_feat_to_tex_modulations_linear = ResnetBlockFC(
                local_feats_dim, modulation_width * 2, zero_init=True)
        if enable_geo_modulations:  # the L_pred_geo_modulations ablation (HGPIFuGANNet.py:67-72)
            self.local_feat_to_geo_modulations_linear = EqualLinear(
                local_feats_dim, modulation_width * 2, zero_init=True)
        if enable_surface_classifier:  # the netLocal 3D pretraining head
            self.surface_classifier = SurfaceClassifier(cfg.hourglass_dim + 1)

    def filter(self, residual_images: torch.Tensor, depth_feat: torch.Tensor | None = None) -> torch.Tensor:
        """[B, 3, H, W] residual (+ [B, 1, H, W] depth) -> [B, hourglass_dim, H/4, W/4]."""
        feats = self.residual_conv(residual_images)
        if depth_feat is not None:
            feats = torch.cat([feats, self.depth_conv(depth_feat)], dim=1)
        with span("e1.filter"):
            return self.image_filter(feats)

    def query(self, im_feat, points, calibs) -> dict:
        return query_features(im_feat, points, calibs, self.cfg.load_size, self.cfg.z_size)

    def query_pair(self, feat_a, feat_b, points, calibs) -> dict:
        """One lookup for two feature volumes sharing the same projection (the
        same-view case): a channel-concat sample split back into feats_a/feats_b."""
        ca = feat_a.shape[1]
        q = self.query(torch.cat([feat_a, feat_b.to(feat_a.dtype)], dim=1), points, calibs)
        q["feats_a"] = q["feats"][:, :ca]
        q["feats_b"] = q["feats"][:, ca:]
        return q

    def tex_modulations(self, local_feats) -> tuple[torch.Tensor, torch.Tensor]:
        """[..., local_feats_dim] (or a tuple of its parts) -> (alpha, beta), each
        [..., modulation_width]."""
        m = self.local_feat_to_tex_modulations_linear(local_feats)
        return m[..., : self.modulation_width], m[..., self.modulation_width :]

    def geo_modulations(self, local_feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[..., local_feats_dim] -> the geometry SFT (alpha, beta), each
        [..., modulation_width] (needs enable_geo_modulations)."""
        m = self.local_feat_to_geo_modulations_linear(local_feats)
        return m[..., : self.modulation_width], m[..., self.modulation_width :]

    def predict_sdf(self, im_feat: torch.Tensor, points: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
        """The netLocal pretraining's SDF (HGPIFuGANNet.py:153-196): the
        pixel-aligned features and the z condition of [B, 3, N] points through
        the SurfaceClassifier, masked to the in-image points -> [B, N, 1]
        (needs enable_surface_classifier)."""
        q = self.query(im_feat, points, calibs)
        feats = torch.cat([q["feats"], q["z_condition"]], dim=1)  # promotes, as jnp.concatenate
        pred = self.surface_classifier(feats.permute(0, 2, 1))
        return pred * q["in_img"][..., None].to(pred.dtype)
