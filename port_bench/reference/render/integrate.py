"""SDF-aware alpha compositing — counterpart of `e3dge_tpu/render/integrate.py`
(reference `volume_integration`, volume_renderer.py:809-943):

  sigma = sigmoid(-sdf / beta) / beta ;  alpha = 1 - exp(-sigma * delta)
  T_i = prod_{j<i} (1 - alpha_j + 1e-10) ;  w_i = alpha_i * T_i
  force_background: w_S = 1 - sum_{i<S} w_i
  rgb = -1 + 2 * sum_i w_i sigmoid(rgb_i) ; feat/xyz/depth = sum_i w_i * (.)
  mask = depth < fg_mask_threshold
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF_DIST = 1e10


class IntegrationOut(NamedTuple):
    rgb: torch.Tensor                # [B, H, W, 3] in [-1, 1]
    features: torch.Tensor | None    # [B, H, W, F]
    sdf: torch.Tensor                # [B, H, W, S, 1]
    mask: torch.Tensor               # [B, H, W, 1, 1]
    xyz: torch.Tensor                # [B, H, W, 3]
    depth: torch.Tensor              # [B, H, W, 1, 1]
    weights: torch.Tensor            # [B, H, W, S, 1] hit probability
    visibility: torch.Tensor         # [B, H, W, S, 1]
    dists: torch.Tensor              # [B, H, W, S]


def sdf_to_density(sdf: torch.Tensor, sigmoid_beta: torch.Tensor) -> torch.Tensor:
    """sigmoid-Laplace density sigmoid(-sdf/beta)/beta (volume_renderer.py:804-807)."""
    return torch.sigmoid(-sdf / sigmoid_beta) / sigmoid_beta


def volume_integrate(
    rgb_raw: torch.Tensor,              # [B, H, W, S, 3]
    sdf: torch.Tensor,                  # [B, H, W, S, 1]
    features: torch.Tensor | None,      # [B, H, W, S, F]
    z_vals: torch.Tensor,               # [B, H, W, S]
    rays_d: torch.Tensor,               # [B, H, W, 3]
    pts: torch.Tensor,                  # [B, H, W, S, 3]
    sigmoid_beta: torch.Tensor,
    force_background: bool = True,
    no_force_stop: bool = False,
    fg_mask_threshold: float = 1.08,
) -> IntegrationOut:
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    rays_d_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if not no_force_stop:
        last = torch.full_like(rays_d_norm, INF_DIST)
    else:
        last = dists[..., 0:1]
    dists = torch.cat([dists, last], dim=-1) * rays_d_norm

    alpha = 1.0 - torch.exp(-sdf_to_density(sdf, sigmoid_beta) * dists[..., None])
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-2)
    visibility = torch.cat([torch.ones_like(alpha[..., :1, :]), trans[..., :-1, :]], dim=-2)
    weights = alpha * visibility
    if force_background and not no_force_stop:
        w_last = 1.0 - torch.sum(weights[..., :-1, :], dim=-2, keepdim=True)
        weights = torch.cat([weights[..., :-1, :], w_last], dim=-2)

    rgb = -1.0 + 2.0 * torch.sum(weights * torch.sigmoid(rgb_raw), dim=-2)
    feature_map = None if features is None else torch.sum(weights * features, dim=-2)
    xyz = torch.sum(weights * pts, dim=-2)
    depth = torch.sum(weights * z_vals[..., None], dim=-2, keepdim=True)
    mask = (depth < fg_mask_threshold).to(weights.dtype)
    return IntegrationOut(rgb, feature_map, sdf, mask, xyz, depth, weights, visibility, dists)
