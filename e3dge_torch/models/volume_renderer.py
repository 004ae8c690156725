"""VolumeFeatureRenderer — the G0 render (SIREN field + SDF compositing);
counterpart of `e3dge_tpu/models/volume_renderer.py` (reference
volume_renderer.py:636-2043), serving path only.

  rays -> z samples -> field kernel over the flattened [B, H*W*S] samples ->
  volume integration

Both field passes of `image2image` go through the hand-written kernel
(`ops/siren_field.py`): `forward` launches `siren_field_full` (writing the
backbone hidden `raw_h` when asked) and `render_from_backbone` launches
`siren_field_tex` on that cache. On CPU tensors the same wrappers run their
plain versions. Not ported yet: the occlusion queries and 3D-supervision
sampling (`volume_renderer.py:291-602`), and z-jitter for training.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from e3dge_torch.config import RendererConfig
from e3dge_torch.models.siren import SirenGenerator
from e3dge_torch.ops.siren_field import io_dtype, siren_field_full, siren_field_tex
from e3dge_torch.render.camera import CameraParams
from e3dge_torch.render.integrate import volume_integrate
from e3dge_torch.render.rays import get_rays, rays_to_points, sample_z_vals


def field_precision(field_dtype: str | torch.dtype) -> str:
    """field dtype -> the kernel's precision ("bfloat16" serves in "serving")."""
    bf16 = field_dtype in ("bfloat16", torch.bfloat16)
    if not bf16 and field_dtype not in ("float32", torch.float32):
        raise ValueError(f"unsupported field dtype {field_dtype!r}")
    return "serving" if bf16 else "highest"


class VolumeFeatureRenderer(nn.Module):
    def __init__(self, cfg: RendererConfig, camera_dist_radius: float = 0.12):
        super().__init__()
        self.cfg = cfg
        self.camera_dist_radius = camera_dist_radius
        self.network = SirenGenerator(cfg.depth, cfg.width, cfg.style_dim, output_features=cfg.output_features)
        if not cfg.with_sdf:
            raise NotImplementedError("raw-density renderers (with_sdf=False) are not ported")
        self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))

    def forward(
        self,
        camera: CameraParams,
        styles: torch.Tensor,
        conditions: tuple[torch.Tensor, torch.Tensor] | None = None,
        return_raw_h: bool = False,
    ) -> dict[str, Any]:
        """Render a batch of views (the reference `sample_batch` dict, JAX
        layouts: NCHW images/features, [B, H, W, S, C] per-sample tensors).

        styles: [B, depth+1, style_dim] W+; conditions: optional local SFT
        (alpha, beta), each [B, H, W, S, width] in the field's io dtype;
        return_raw_h keeps the backbone hidden for `render_from_backbone`."""
        c = self.cfg
        res = c.out_im_res
        rays_o, rays_d, viewdirs = get_rays(camera.focal, camera.poses, res, static_viewdirs=c.static_viewdirs)
        b = rays_o.shape[0]
        z_vals = sample_z_vals(camera.near, camera.far, (b, res, res), c.n_samples, c.offset_sampling)
        pts = rays_to_points(rays_o, rays_d, z_vals)  # [B, H, W, S, 3]
        shp = pts.shape[:-1]
        n = shp[1] * shp[2] * shp[3]

        precision = field_precision(c.field_dtype)
        # JAX casts the styles to the field dtype before the FiLM heads
        q_styles = styles.to(torch.bfloat16) if precision == "serving" else styles
        gamma, beta = self.network.film_vectors(q_styles)
        q_pts = (pts * (1.0 / self.camera_dist_radius)).reshape(b, n, 3)  # UniformBoxWarp
        q_dirs = viewdirs[..., None, :].expand(pts.shape).reshape(b, n, 3)
        alpha = lbeta = None
        if conditions is not None:
            alpha, lbeta = (t.reshape(b, n, c.width).to(io_dtype(precision)).contiguous() for t in conditions)
        feat, rgb_sdf, raw_h = siren_field_full(
            q_pts.contiguous(), q_dirs.contiguous(), self.network.pack(precision), gamma, beta,
            alpha, lbeta, precision=precision, return_raw_h=return_raw_h,
        )
        rgb_sdf = rgb_sdf.reshape(*shp, 4)
        features = feat.reshape(*shp, c.width).float() if c.output_features else None
        out = volume_integrate(
            rgb_sdf[..., :3], rgb_sdf[..., 3:4], features, z_vals, rays_d, pts, self.sigmoid_beta,
            force_background=c.force_background, fg_mask_threshold=c.fg_mask_threshold,
        )
        result = {
            "gen_thumb_imgs": out.rgb.permute(0, 3, 1, 2),
            "features": None if out.features is None else out.features.permute(0, 3, 1, 2),
            "sdf": out.sdf,
            "mask": out.mask,
            "xyz": out.xyz,
            "depth": out.depth,
            "hit_prob": out.weights,
            "visibility": out.visibility,
            "points": pts,
            "dists": out.dists,
            "z_vals": z_vals,
            "rays_o": rays_o,
            "rays_d": rays_d,
            "viewdirs": viewdirs,
            "near": camera.near,
            "far": camera.far,
        }
        if raw_h is not None:
            result["raw_h"] = raw_h.reshape(*shp, c.width)
        return result

    def render_from_backbone(
        self,
        cached: dict[str, Any],
        styles: torch.Tensor,
        conditions: tuple[torch.Tensor, torch.Tensor] | None,
    ) -> dict[str, Any]:
        """Texture-head-only re-render on the cached backbone hidden (the
        same-view E1 re-render): the texture SFT leaves the backbone, sdf and
        integration weights of pass 1 unchanged, so only the view layer, the rgb
        head and the weighted sums run again — `siren_field_tex`."""
        h = cached["raw_h"]
        shp = h.shape[:-1]
        b, width = shp[0], h.shape[-1]
        n = shp[1] * shp[2] * shp[3]
        precision = field_precision(h.dtype)
        q_styles = styles.to(torch.bfloat16) if precision == "serving" else styles
        gamma, beta = self.network.film_vectors(q_styles)
        dirs = cached["viewdirs"][..., None, :].expand(*shp, 3).reshape(b, n, 3)
        alpha = lbeta = None
        if conditions is not None:
            alpha, lbeta = (t.reshape(b, n, width).to(h.dtype).contiguous() for t in conditions)
        feat, rgb_raw = siren_field_tex(
            h.reshape(b, n, width), dirs.contiguous(), self.network.pack(precision),
            gamma[:, -1].contiguous(), beta[:, -1].contiguous(), alpha, lbeta, precision=precision,
        )
        weights = cached["hit_prob"]
        rgb = -1.0 + 2.0 * torch.sum(weights * torch.sigmoid(rgb_raw.reshape(*shp, 3)), dim=-2)
        out = dict(cached)
        out["gen_thumb_imgs"] = rgb.permute(0, 3, 1, 2)
        if self.cfg.output_features:
            out["features"] = torch.sum(weights * feat.reshape(*shp, width).float(), dim=-2).permute(0, 3, 1, 2)
        return out
