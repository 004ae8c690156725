"""Rays and depth samples — counterpart of `e3dge_tpu/render/rays.py`
(reference volume_renderer.py:768-794, 1211-1233). Serving only: z-values are
not jittered (the perturbed training path is not ported yet)."""

from __future__ import annotations

import torch


def get_rays(focal: torch.Tensor, c2w: torch.Tensor, res: int, static_viewdirs: bool = False):
    """World rays through every pixel centre -> rays_o, rays_d, viewdirs, each
    [B, res, res, 3]. static_viewdirs keeps the view directions in camera space
    (the released models' setting, base_setup.py:54)."""
    b = focal.shape[0]
    coords = torch.linspace(0.5, res - 0.5, res, device=focal.device)
    i = coords[None, None, :].expand(b, res, res)  # x along the last axis
    j = coords[None, :, None].expand(b, res, res)  # y along rows
    f = focal.reshape(b, 1, 1)
    dirs = torch.stack([(i - res * 0.5) / f, -(j - res * 0.5) / f, -torch.ones_like(i)], dim=-1)
    rays_d = torch.einsum("bhwi,bji->bhwj", dirs, c2w[:, :3, :3])
    rays_o = c2w[:, None, None, :3, 3].expand_as(rays_d)
    vd = dirs if static_viewdirs else rays_d
    viewdirs = vd / torch.linalg.norm(vd, dim=-1, keepdim=True)
    return rays_o, rays_d, viewdirs


def sample_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    shape: tuple[int, int, int],
    n_samples: int,
    offset_sampling: bool = True,
) -> torch.Tensor:
    """Depths along each ray [B, H, W, S] on the offset grid t = {0, 1/S, ...}
    (eq. (3)) or the stratified grid linspace(0, 1, S), without jitter.
    near/far are per-batch ([B, ...] with B elements) or per-ray ([B, H, W])."""
    b, h, w = shape
    near = near.reshape(b, h, w, 1) if near.numel() == b * h * w else near.reshape(b, 1, 1, 1)
    far = far.reshape(b, h, w, 1) if far.numel() == b * h * w else far.reshape(b, 1, 1, 1)
    end = 1.0 - 1.0 / n_samples if offset_sampling else 1.0
    t_vals = torch.linspace(0.0, end, n_samples, device=near.device).reshape(1, 1, 1, -1)
    return (near * (1.0 - t_vals) + far * t_vals).expand(b, h, w, n_samples)


def rays_to_points(rays_o: torch.Tensor, rays_d: torch.Tensor, z_vals: torch.Tensor) -> torch.Tensor:
    """pts[b, h, w, s] = o + t * d -> [B, H, W, S, 3]."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
