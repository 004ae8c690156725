"""E1 local network (netLocal): residual + depth context convs, the stacked
hourglass filter, the pixel-aligned query and the zero-init SFT modulation
head; counterpart of `e3dge_tpu/models/pifu/local_net.py` (reference
HGPIFuGANNet.py, HGPIFuGANNetResidualInputResnetFC.py:19-104), the released
`resnetfc` variant. The 'bn' variant, geometry modulations and the surface
classifier are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from e3dge_torch.config import PifuConfig
from e3dge_torch.models.align import ResnetBlockFC
from e3dge_torch.models.encoders.fpn import Conv2d
from e3dge_torch.models.pifu.hourglass import HGFilter
from e3dge_torch.ops import grid_sample
from e3dge_torch.render.camera import project_points


class InstanceNorm(nn.InstanceNorm2d):
    """InstanceNorm2d(affine=True, no running stats), f32 statistics, output in
    the input dtype."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x.float(), weight=self.weight, bias=self.bias, eps=self.eps).to(x.dtype)


class _ResidualBlock(nn.Module):
    """norm -> relu -> conv3x3(reflect) -> norm -> relu -> conv3x3(reflect), plus x
    (helpers.py:318-358); `conv` indices 0..5 as upstream."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Sequential(
            InstanceNorm(dim), nn.ReLU(), Conv2d(dim, dim, 3, padding=1, padding_mode="reflect", bias=False),
            InstanceNorm(dim), nn.ReLU(), Conv2d(dim, dim, 3, padding=1, padding_mode="reflect", bias=False),
        )

    def forward(self, x):
        return x + self.conv(x)


def context_conv(in_ch: int, dim: int = 32) -> nn.Sequential:
    """conv3x3(reflect) -> ResidualBlock -> conv1x1: the residual / depth context
    encoders (HGPIFuGANNetResidualInputResnetFC.py:36-45)."""
    return nn.Sequential(
        Conv2d(in_ch, dim, 3, padding=1, padding_mode="reflect", bias=False),
        _ResidualBlock(dim),
        Conv2d(dim, dim, 1, bias=False),
    )


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
    """netLocal, `HGPIFuNetGANResidualResnetFC`: InstanceNorm context convs +
    zero-init ResnetBlockFC texture-modulation head."""

    def __init__(self, cfg: PifuConfig, modulation_width: int = 256, local_feats_dim: int = 256 + 45):
        super().__init__()
        if cfg.netLocal_type != "HGPIFuNetGANResidualResnetFC":
            raise NotImplementedError(f"netLocal {cfg.netLocal_type!r} is not ported (resnetfc only)")
        self.cfg = cfg
        self.modulation_width = modulation_width
        self.residual_conv = context_conv(3)
        self.with_depth = "depth" in cfg.residual_context_feats
        if self.with_depth:
            self.depth_conv = context_conv(1)
        self.image_filter = HGFilter(
            in_channels=64 if self.with_depth else 32, num_stack=cfg.num_stack,
            num_hourglass=cfg.num_hourglass, hourglass_dim=cfg.hourglass_dim,
        )
        self.local_feat_to_tex_modulations_linear = ResnetBlockFC(
            local_feats_dim, modulation_width * 2, zero_init=True
        )

    def filter(self, residual_images: torch.Tensor, depth_feat: torch.Tensor | None = None) -> torch.Tensor:
        """[B, 3, H, W] residual (+ [B, 1, H, W] depth) -> [B, hourglass_dim, H/4, W/4]."""
        feats = self.residual_conv(residual_images)
        if depth_feat is not None:
            feats = torch.cat([feats, self.depth_conv(depth_feat)], dim=1)
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
