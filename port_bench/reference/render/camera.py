"""Camera parameters and projection — counterpart of `e3dge_tpu/render/camera.py`
(reference `generate_camera_params`, camera_utils.py:8-155): cameras on the unit
sphere looking at the origin, near/far = 1 -/+ dist_radius, PIFu-style calibs
mapping world points to [-1, 1] uv space."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch



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

    dist = torch.ones(batch, device=dev)
    near = (dist - dist_radius).reshape(batch, 1, 1)
    far = (dist + dist_radius).reshape(batch, 1, 1)
    fov = torch.full((batch,), float(fov_ang), device=dev) * math.pi / 180.0
    focal = (0.5 * resolution / torch.tan(fov)).reshape(batch, 1, 1)

    camera_dir = torch.stack(
        [torch.cos(elev) * torch.sin(azim), torch.sin(elev), torch.cos(elev) * torch.cos(azim)], dim=-1
    )
    camera_loc = dist[:, None] * camera_dir

    up = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(batch, 3)
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
    zeros, ones = torch.zeros(batch, device=dev), torch.ones(batch, device=dev)
    intrinsics = torch.stack(
        [
            torch.stack([f_uv, zeros, zeros], -1),
            torch.stack([zeros, f_uv, zeros], -1),
            torch.stack([zeros, zeros, ones], -1),
        ],
        dim=1,
    )
    homo = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev).expand(batch, 1, 4)
    calibs = torch.cat([intrinsics @ extrinsics, homo], dim=1)
    viewpoint = torch.stack([azim, elev], dim=-1)
    return CameraParams(poses, extrinsics, focal, near, far, viewpoint, calibs)


def project_points(points: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    """[B, 3, N] world points -> [B, 3, N] (u, v, depth), depth = -z_cam
    (reference `geometry.perspective`)."""
    homo = calibs[:, :3, :3] @ points + calibs[:, :3, 3:4]
    depth = -homo[:, 2:3]
    xy = homo[:, :2] / torch.where(torch.abs(depth) < 1e-8, torch.full_like(depth, 1e-8), depth)
    return torch.cat([xy, depth], dim=1)

