"""Camera parameters and projection — counterpart of `e3dge_tpu/render/camera.py`
(reference `generate_camera_params`, camera_utils.py:8-155): cameras on the unit
sphere looking at the origin, near/far = 1 -/+ dist_radius, PIFu-style calibs
mapping world points to [-1, 1] uv space."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from e3dge_torch.config import CameraConfig


class CameraParams(NamedTuple):
    """Field for field the JAX `CameraParams` (camera_utils.py:141-153)."""

    poses: torch.Tensor       # [B, 3, 4] c2w
    extrinsics: torch.Tensor  # [B, 3, 4] w2c
    focal: torch.Tensor       # [B, 1, 1]
    near: torch.Tensor        # [B, 1, 1]
    far: torch.Tensor         # [B, 1, 1]
    viewpoint: torch.Tensor   # [B, 2] (azim, elev)
    calibs: torch.Tensor      # [B, 4, 4] homogeneous uv-space calib


def _normalize(v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # F.normalize semantics: v / max(||v||, eps)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def camera_params_from_angles(
    azim: torch.Tensor,
    elev: torch.Tensor,
    resolution: int,
    fov_ang: float = 6.0,
    dist_radius: float = 0.12,
) -> CameraParams:
    """Full camera parameters from [B] azimuth / elevation angles (radians)."""
    azim = azim.reshape(-1).float()
    elev = elev.reshape(-1).float()
    batch, dev = azim.shape[0], azim.device

    # constants built on the device: no host copy, so a CUDA graph can capture this
    zeros, ones = torch.zeros(batch, device=dev), torch.ones(batch, device=dev)
    dist = ones
    near = (dist - dist_radius).reshape(batch, 1, 1)
    far = (dist + dist_radius).reshape(batch, 1, 1)
    fov = torch.full((batch,), float(fov_ang), device=dev) * math.pi / 180.0
    focal = (0.5 * resolution / torch.tan(fov)).reshape(batch, 1, 1)

    camera_dir = torch.stack(
        [torch.cos(elev) * torch.sin(azim), torch.sin(elev), torch.cos(elev) * torch.cos(azim)], dim=-1
    )
    camera_loc = dist[:, None] * camera_dir

    up = torch.stack([zeros, ones, zeros], dim=-1)
    z_axis = _normalize(camera_dir)
    x_axis = _normalize(torch.linalg.cross(up, z_axis, dim=-1))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis, dim=-1))
    # degenerate pole (camera_utils.py:97-101): rebuild x from y x z
    is_close = torch.all(torch.abs(x_axis) < 5e-3, dim=-1, keepdim=True)
    x_axis = torch.where(is_close, _normalize(torch.linalg.cross(y_axis, z_axis, dim=-1)), x_axis)

    w2c_R = torch.stack([x_axis, y_axis, z_axis], dim=1)  # [B, 3, 3] rows
    c2w_R = w2c_R.transpose(1, 2)
    T = camera_loc[:, :, None]
    poses = torch.cat([c2w_R, T], dim=-1)
    extrinsics = torch.cat([w2c_R, -w2c_R @ T], dim=-1)

    f_uv = focal.reshape(batch) / (resolution / 2.0)
    intrinsics = torch.stack(
        [
            torch.stack([f_uv, zeros, zeros], -1),
            torch.stack([zeros, f_uv, zeros], -1),
            torch.stack([zeros, zeros, ones], -1),
        ],
        dim=1,
    )
    homo = torch.stack([zeros, zeros, zeros, ones], dim=-1)[:, None]
    calibs = torch.cat([intrinsics @ extrinsics, homo], dim=1)
    viewpoint = torch.stack([azim, elev], dim=-1)
    return CameraParams(poses, extrinsics, focal, near, far, viewpoint, calibs)


def sample_camera_params(generator: torch.Generator, batch: int, resolution: int,
                         cfg: CameraConfig = CameraConfig()) -> CameraParams:
    """Random viewpoints (`e3dge_tpu/render/camera.py:105`, which takes a key
    where this takes a generator): azimuth and elevation around their means,
    gaussian with the ranges as std, or uniform within +-range with
    cfg.uniform, drawn from `generator` on its device, azimuths first."""
    def draw(scale: float) -> torch.Tensor:
        if cfg.uniform:
            return (torch.rand(batch, generator=generator, device=generator.device) * 2 - 1) * scale
        return scale * torch.randn(batch, generator=generator, device=generator.device)

    azim, elev = draw(cfg.azim_range), draw(cfg.elev_range)
    return camera_params_from_angles(cfg.azim_mean + azim, cfg.elev_mean + elev, resolution, cfg.fov_ang,
                                     cfg.dist_radius)


def sweep_camera_params(batch: int, resolution: int, cfg: CameraConfig = CameraConfig(),
                        n_views: int = 8) -> CameraParams:
    """The deterministic azimuth sweep at elevation 0 of the novel-view
    trajectories (`e3dge_tpu/render/camera.py:124`): n_views azimuths over
    [-range, +range] inclusive, the whole sweep repeated for each of `batch`
    items ([batch * n_views] cameras)."""
    azim = (-cfg.azim_range + (2 * cfg.azim_range / (n_views - 1)) * torch.arange(n_views)).repeat(batch)
    return camera_params_from_angles(cfg.azim_mean + azim, cfg.elev_mean + torch.zeros_like(azim), resolution,
                                     cfg.fov_ang, cfg.dist_radius)


def project_points(points: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    """[B, 3, N] world points -> [B, 3, N] (u, v, depth), depth = -z_cam
    (reference `geometry.perspective`)."""
    homo = calibs[:, :3, :3] @ points + calibs[:, :3, 3:4]
    depth = -homo[:, 2:3]
    xy = homo[:, :2] / torch.where(torch.abs(depth) < 1e-8, torch.full_like(depth, 1e-8), depth)
    return torch.cat([xy, depth], dim=1)


def project_points_orthogonal(points: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    """[B, 3, N] world points -> [B, 3, N] (u, v, z) by the calibs' affine
    map without the perspective divide (`e3dge_tpu/render/camera.py:159`,
    reference `geometry.orthogonal`, vendor/pifu/lib/geometry.py:83-99)."""
    return calibs[:, :3, :3] @ points + calibs[:, :3, 3:4]
