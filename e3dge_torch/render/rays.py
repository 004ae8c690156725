"""Rays and depth samples — counterpart of `e3dge_tpu/render/rays.py`
(reference volume_renderer.py:768-794, 1211-1233), the training jitter of the
depth samples included, and the secant search for the surface along rays."""

from __future__ import annotations

import torch

from e3dge_torch.parallel import mesh


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
    perturb: bool = False,
    jitter: str = "auto",
    generator: torch.Generator | None = None,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Depths along each ray [B, H, W, S] on the offset grid t = {0, 1/S, ...}
    (eq. (3)) or the stratified grid linspace(0, 1, S). near/far are per-batch
    ([B, ...] with B elements) or per-ray ([B, H, W]).

    perturb jitters them (`e3dge_tpu/render/rays.py:86-96`): jitter="auto" on
    the offset grid shifts each ray's samples by one shared uniform draw [B, H,
    W, 1] of an interval; otherwise (the stratified grid, or jitter="mids")
    each sample moves within its bin between the midpoints by its own draw
    [B, H, W, S]. `u` is that uniform draw, else it comes from `generator` on
    near's device (the global RNG when None)."""
    b, h, w = shape
    near = near.reshape(b, h, w, 1) if near.numel() == b * h * w else near.reshape(b, 1, 1, 1)
    far = far.reshape(b, h, w, 1) if far.numel() == b * h * w else far.reshape(b, 1, 1, 1)
    end = 1.0 - 1.0 / n_samples if offset_sampling else 1.0
    t_vals = torch.linspace(0.0, end, n_samples, device=near.device).reshape(1, 1, 1, -1)
    z_vals = (near * (1.0 - t_vals) + far * t_vals).expand(b, h, w, n_samples)
    if not perturb:
        return z_vals
    if offset_sampling and jitter == "auto":
        upper = torch.cat([z_vals[..., 1:], far.expand(b, h, w, 1)], dim=-1)
        lower = z_vals
        u_shape = (b, h, w, 1)
    else:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        u_shape = (b, h, w, n_samples)
    if u is None:  # in a data-parallel step, this rank's rows of the global draw
        u = mesh.draw_rows(lambda s: torch.rand(s, device=near.device, generator=generator), u_shape)
    if tuple(u.shape) != u_shape:
        raise ValueError(f"the jitter draw has shape {tuple(u.shape)}, expected {u_shape}")
    return lower + (upper - lower) * u


def rays_to_points(rays_o: torch.Tensor, rays_d: torch.Tensor, z_vals: torch.Tensor) -> torch.Tensor:
    """pts[b, h, w, s] = o + t * d -> [B, H, W, S, 3]."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]


def find_surface_secant(
    sdf_fn,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float | torch.Tensor,
    far: float | torch.Tensor,
    n_coarse: int = 24,
    n_secant: int = 8,
    level: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The surface along rays by the secant method (`e3dge_tpu/render/rays.py:
    105`, reference `geometry.render_functions.perform_ray_marching` /
    `run_Secant_method`, vendor/pifu/lib/geometry.py:132-330, for an SDF at
    `level`): n_coarse samples from near to far bracket the first
    outside-to-inside sign change, then n_secant secant steps refine the
    root. The counts are fixed and no branch reads the data: masks choose the
    values, so one call runs sdf_fn once at [..., n_coarse] points and
    n_secant times at [...] points.

    rays_o, rays_d [..., 3]; near, far broadcastable to [...]; sdf_fn(pts
    [..., 3]) -> [..., 1] (e.g. `VolumeFeatureRenderer.query_sdf` with its
    styles bound: one field launch per call on the card, without grad).
    Returns (z_surf [...], far where a ray does not hit; hit [...] bool)."""
    shape = rays_o.shape[:-1]
    dev, dt = rays_o.device, rays_o.dtype
    t = torch.linspace(0.0, 1.0, n_coarse, device=dev, dtype=dt)
    near = torch.as_tensor(near, device=dev, dtype=dt).expand(shape)
    far = torch.as_tensor(far, device=dev, dtype=dt).expand(shape)
    z = near[..., None] * (1.0 - t) + far[..., None] * t  # [..., C]
    f = sdf_fn(rays_o[..., None, :] + rays_d[..., None, :] * z[..., None])[..., 0] - level

    crossing = (f[..., :-1] > 0) & (f[..., 1:] <= 0)
    hit = crossing.any(dim=-1)
    idx = torch.argmax(crossing.to(torch.uint8), dim=-1, keepdim=True)  # the first bracket

    z_low, f_low = z.gather(-1, idx)[..., 0], f.gather(-1, idx)[..., 0]
    z_high, f_high = z.gather(-1, idx + 1)[..., 0], f.gather(-1, idx + 1)[..., 0]
    z_pred = z_low - f_low * (z_high - z_low) / (f_high - f_low - 1e-12)
    for _ in range(n_secant):
        f_mid = sdf_fn(rays_o + z_pred[..., None] * rays_d)[..., 0] - level
        outside = f_mid > 0
        z_low = torch.where(outside, z_pred, z_low)
        f_low = torch.where(outside, f_mid, f_low)
        z_high = torch.where(outside, z_high, z_pred)
        f_high = torch.where(outside, f_high, f_mid)
        z_pred = z_low - f_low * (z_high - z_low) / (f_high - f_low - 1e-12)
    return torch.where(hit, z_pred, far), hit
