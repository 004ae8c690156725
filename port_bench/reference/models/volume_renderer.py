"""VolumeFeatureRenderer — the G0 render (SIREN field + SDF compositing);
counterpart of `e3dge_tpu/models/volume_renderer.py` (reference
volume_renderer.py:636-2043).

  rays -> z samples -> field over the flattened [B, H*W*S] samples ->
  volume integration

Every field evaluation picks its route by one rule (`_field`): a call that
needs a gradient evaluates the eager twin (`models/siren.py`) under autograd,
in the precision the JAX network would use (rematerialised in the backward
under `remat_field`); every other call launches the hand-written kernel
(`ops/siren_field.py`), which has no backward. So `forward`,
`query_raw`/`query_sdf`, the occlusion queries
`query_hit_prob`/`query_hit_prob_adapted` (one launch per chunk) and
`render_sdf_grid` launch `siren_field_full` when serving or sampling
training data, and `render_from_backbone` launches `siren_field_tex` on the
cached backbone (or, for a stage-2 re-render whose texture modulations need
a gradient, runs the twin's texture head alone on it). On CPU tensors the
same wrappers run their plain versions. The training parts: z-jitter (`forward(train=, generator=)`), the
3D-supervision samplers and the module function `eikonal_term`.

Under the ray split of a stage-2 cycle step (`parallel.mesh.sharded(world,
rays=True)` on an sp axis > 1) `forward` and `render_from_backbone` run the
rank's rows of the rays only (drawn at the whole image, `mesh.own_rays`):
their per-ray and per-sample outputs hold those rows, and the image maps
(`IMAGE_MAPS`) come back whole, gathered along H with autograd.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from port_bench.reference.config import RendererConfig
from port_bench.reference.models.siren import SirenGenerator
from port_bench.reference.ops import grid_sample
from port_bench.reference.ops.siren_field import io_dtype, siren_field_full, siren_field_tex
from port_bench.reference.parallel import mesh
from port_bench.reference.render.camera import CameraParams
from port_bench.reference.render.integrate import volume_integrate
from port_bench.reference.render.rays import get_rays, rays_to_points, sample_z_vals


def field_precision(field_dtype: str | torch.dtype) -> str:
    """field dtype -> the kernel's precision ("bfloat16" serves in "serving")."""
    bf16 = field_dtype in ("bfloat16", torch.bfloat16)
    if not bf16 and field_dtype not in ("float32", torch.float32):
        raise ValueError(f"unsupported field dtype {field_dtype!r}")
    return "serving" if bf16 else "highest"


def _t_vals(n: int, offset_sampling: bool, device) -> torch.Tensor:
    return torch.linspace(0.0, 1.0 - 1.0 / n if offset_sampling else 1.0, n, device=device)


# the differentiable field's evaluations by the eager twin, by part ("field":
# the whole field, `_twin_field`; "texture": the texture head on a cached
# backbone, `render_from_backbone`) and precision, counted beside the field
# kernel's launches (`ops.siren_field.launch_counts`)
twin_counts = {(part, p): 0 for part in ("field", "texture") for p in ("serving", "highest")}


# the image maps of a render and their height axis, gathered whole under the
# ray split (`_whole_maps`)
IMAGE_MAPS = {"gen_thumb_imgs": 2, "features": 2, "depth": 1, "mask": 1}


def _whole_maps(out: dict[str, Any]) -> dict[str, Any]:
    """Under the ray split (`parallel.mesh.ray_split`) a render's image maps,
    which 2D layers and losses read, gathered whole along H with autograd;
    its per-ray and per-sample outputs keep the rank's rows."""
    for k, dim in IMAGE_MAPS.items():
        if out.get(k) is not None:
            out[k] = mesh.gather_rays(out[k], dim=dim)
    return out


class VolumeFeatureRenderer(nn.Module):
    def __init__(self, cfg: RendererConfig, camera_dist_radius: float = 0.12):
        super().__init__()
        self.cfg = cfg
        self.camera_dist_radius = camera_dist_radius
        self.network = SirenGenerator(cfg.depth, cfg.width, cfg.style_dim, output_features=cfg.output_features)
        if cfg.with_sdf:  # a raw-density renderer integrates with beta = 1 (JAX's `volume_renderer.py:49`)
            self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))

    # -- field queries -------------------------------------------------------

    def field_args(
        self, pts: torch.Tensor, dirs: torch.Tensor | None, styles: torch.Tensor, precision: str
    ) -> tuple[torch.Tensor, ...]:
        """The field kernel's operands for world points pts [B, ..., 3] and view
        dirs of the same shape (None: zeros, for SDF-only queries): the points
        warped into the [-1, 1] box (UniformBoxWarp, 1/camera_dist_radius) and
        both flattened to [B, N, 3], the precision's weight pack, and the FiLM
        vectors of styles (`_film`)."""
        b = pts.shape[0]
        q_pts = (pts * (1.0 / self.camera_dist_radius)).reshape(b, -1, 3).contiguous()
        q_dirs = torch.zeros_like(q_pts) if dirs is None else dirs.reshape(b, -1, 3).contiguous()
        return (q_pts, q_dirs, self.network.pack(precision), *self._film(styles, precision))

    def _film(self, styles: torch.Tensor, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
        """FiLM vectors gamma, beta [B, D+1, W] f32 of styles, cast to bf16 first
        in serving as JAX casts the styles to the field dtype."""
        return self.network.film_vectors(styles.to(torch.bfloat16) if precision == "serving" else styles)

    def needs_grad(self, *tensors: torch.Tensor | None) -> bool:
        """The route rule: grad mode is on, and a tensor given or a field
        parameter requires grad."""
        if not torch.is_grad_enabled():
            return False
        return any(t is not None and t.requires_grad for t in tensors) or any(
            p.requires_grad for p in self.network.parameters()
        )

    def _field(self, pts, dirs, styles, conditions=None, precision=None, return_raw_h=False):
        """The field over pts [B, ..., 3] (in the precision of `field_dtype`
        unless given) -> feat [B, ..., W] (io dtype; None from the twin for an
        SDF-only call, dirs None), rgb_sdf [B, ..., 4] f32 and raw_h or None,
        in the points' layout. A call that `needs_grad` runs the twin, every
        other one `siren_field_full` launch."""
        precision = precision or field_precision(self.cfg.field_dtype)
        cond = conditions or (None, None)
        if self.needs_grad(pts, dirs, styles, *cond):
            return self._twin_field(pts, dirs, styles, conditions, precision, return_raw_h)
        shp, width = pts.shape[:-1], self.cfg.width
        args = self.field_args(pts, dirs, styles, precision)
        alpha = lbeta = None
        if conditions is not None:
            alpha, lbeta = (t.reshape(shp[0], -1, width).to(io_dtype(precision)).contiguous() for t in conditions)
        feat, rgb_sdf, raw_h = siren_field_full(*args, alpha, lbeta, precision=precision, return_raw_h=return_raw_h)
        return feat.reshape(*shp, width), rgb_sdf.reshape(*shp, 4), None if raw_h is None else raw_h.reshape(*shp, width)

    def _twin_field(self, pts, dirs, styles, conditions, precision, return_raw_h):
        """`_field` through the eager twin under autograd, as the JAX XLA
        network computes it (`volume_renderer.py:193-214`): points, dirs and
        styles cast to the precision's dtype (f32, or bf16 with fast_sin for
        `serving`), the points warped, the network on the flattened [B, N, C]
        samples. `remat_field` wraps it in a non-reentrant checkpoint, which
        recomputes it in the backward (`nn.remat` in JAX)."""
        twin_counts[("field", precision)] += 1
        dt = io_dtype(precision)
        shp, b = pts.shape[:-1], pts.shape[0]
        net = self.network

        def flat(t):
            return t.reshape(b, -1, t.shape[-1])

        def run(p, v, s, alpha, lbeta):
            h = net.backbone(p, s)
            sdf = net.geo_head(h)
            if v is None:
                return None, F.pad(sdf.float(), (3, 0)), h
            rgb, feat = net.tex_head(h, v, s, None if alpha is None else (alpha, lbeta))
            return feat, torch.cat([rgb, sdf], dim=-1).float(), h

        p = flat(pts.to(dt) * (1.0 / self.camera_dist_radius))
        v = None if dirs is None else flat(dirs.to(dt))
        alpha, lbeta = (None, None) if conditions is None else (flat(t) for t in conditions)
        args = (p, v, styles.to(dt), alpha, lbeta)
        feat, rgb_sdf, h = checkpoint(run, *args, use_reentrant=False) if self.cfg.remat_field else run(*args)
        return (None if feat is None else feat.reshape(*shp, -1), rgb_sdf.reshape(*shp, 4),
                h.reshape(*shp, -1) if return_raw_h else None)

    def query_raw(
        self,
        pts: torch.Tensor,
        viewdirs: torch.Tensor,
        styles: torch.Tensor,
        conditions: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """The field at f32 world points pts [B, ..., 3] with view dirs of the
        same shape: concat([rgb, sdf, features]) [B, ..., 4 + W] in f32
        (features only with `output_features`), the JAX layout. Runs in f32
        (`highest`) whatever `field_dtype` says: the JAX network follows its
        inputs' dtype, and only `forward` casts them to the field dtype."""
        feat, rgb_sdf, _ = self._field(pts, viewdirs, styles, conditions, precision="highest")
        return torch.cat([rgb_sdf, feat.float()], dim=-1) if self.cfg.output_features else rgb_sdf

    def query_sdf(self, pts: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
        """SDF [B, ..., 1] f32 at f32 world points [B, ..., 3]: the sdf column
        of one f32 field launch, as `query_raw` (the kernel has no SDF-only
        entry; the JAX kernel neither), or of the twin's backbone and sdf head
        when the call needs a gradient (`eikonal_term`, shape supervision)."""
        _, rgb_sdf, _ = self._field(pts, None, styles, precision="highest")
        return rgb_sdf[..., 3:4]

    def forward(
        self,
        camera: CameraParams,
        styles: torch.Tensor,
        conditions: tuple[torch.Tensor, torch.Tensor] | None = None,
        return_raw_h: bool = False,
        z_vals: torch.Tensor | None = None,
        no_force_stop: bool = False,
        train: bool = False,
        generator: torch.Generator | None = None,
        field_dtype: str | None = None,
    ) -> dict[str, Any]:
        """Render a batch of views (the reference `sample_batch` dict, JAX
        layouts: NCHW images/features, [B, H, W, S, C] per-sample tensors).

        styles: [B, depth+1, style_dim] W+; conditions: optional local SFT
        (alpha, beta), each [B, H, W, S, width] in the field's io dtype;
        return_raw_h keeps the backbone hidden for `render_from_backbone`;
        z_vals [B, H, W, S] fixes the depth samples (the novel-view SFT
        re-render on the query render's samples). The samples are jittered
        only with `cfg.perturb`, `train` and a `generator` (JAX: with a key,
        `volume_renderer.py:180-190`). field_dtype overrides `cfg.field_dtype`
        (the frozen-GAN samples' `sample_field_dtype`)."""
        c = self.cfg
        res = c.out_im_res
        rays_o, rays_d, viewdirs = get_rays(camera.focal, camera.poses, res, static_viewdirs=c.static_viewdirs)
        b = rays_o.shape[0]
        if z_vals is None:
            perturb = c.perturb and train and generator is not None
            z_vals = mesh.own_rays(sample_z_vals(camera.near, camera.far, (b, res, res), c.n_samples,
                                                 c.offset_sampling, perturb=perturb, generator=generator))
        rays_o, rays_d, viewdirs = (mesh.own_rays(t) for t in (rays_o, rays_d, viewdirs))
        pts = rays_to_points(rays_o, rays_d, z_vals)  # [B, H, W, S, 3]
        dirs = viewdirs[..., None, :].expand(pts.shape)
        precision = field_precision(field_dtype or c.field_dtype)
        feat, rgb_sdf, raw_h = self._field(pts, dirs, styles, conditions, precision, return_raw_h)
        features = feat.float() if c.output_features else None
        beta = self.sigmoid_beta if c.with_sdf else 1.0
        out = volume_integrate(
            rgb_sdf[..., :3], rgb_sdf[..., 3:4], features, z_vals, rays_d, pts, beta,
            force_background=c.force_background, no_force_stop=no_force_stop,
            fg_mask_threshold=c.fg_mask_threshold,
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
            result["raw_h"] = raw_h
        return _whole_maps(result)

    def render_from_backbone(
        self,
        cached: dict[str, Any],
        styles: torch.Tensor,
        conditions: tuple[torch.Tensor, torch.Tensor] | None,
    ) -> dict[str, Any]:
        """Texture-head-only re-render on the cached backbone hidden (the
        same-view E1 re-render, and stage 2's conditioned re-render on the
        query render's samples): the texture SFT leaves the backbone, sdf and
        integration weights of pass 1 unchanged, so only the view layer, the rgb
        head and the weighted sums run again — `siren_field_tex`, or, when the
        call `needs_grad` (the conditions in training), the twin's `tex_head`
        under autograd, in raw_h's precision."""
        h = cached["raw_h"]
        shp = h.shape[:-1]
        b, width = shp[0], h.shape[-1]
        n = shp[1] * shp[2] * shp[3]
        dirs = cached["viewdirs"][..., None, :].expand(*shp, 3)
        if self.needs_grad(h, styles, *(conditions or ())):
            twin_counts[("texture", field_precision(h.dtype))] += 1
            rgb_raw, feat = self.network.tex_head(h, dirs.to(h.dtype), styles.to(h.dtype), conditions)
        else:
            precision = field_precision(h.dtype)
            gamma, beta = self._film(styles, precision)
            alpha = lbeta = None
            if conditions is not None:
                alpha, lbeta = (t.reshape(b, n, width).to(h.dtype).contiguous() for t in conditions)
            feat, rgb_raw = siren_field_tex(
                h.reshape(b, n, width), dirs.reshape(b, n, 3).contiguous(), self.network.pack(precision),
                gamma[:, -1].contiguous(), beta[:, -1].contiguous(), alpha, lbeta, precision=precision,
            )
        rgb_raw = rgb_raw.float()
        weights = cached["hit_prob"]
        rgb = -1.0 + 2.0 * torch.sum(weights * torch.sigmoid(rgb_raw.reshape(*shp, 3)), dim=-2)
        out = dict(cached)
        out["gen_thumb_imgs"] = mesh.gather_rays(rgb.permute(0, 3, 1, 2), dim=2)
        if self.cfg.output_features:
            out["features"] = mesh.gather_rays(
                torch.sum(weights * feat.reshape(*shp, width).float(), dim=-2).permute(0, 3, 1, 2), dim=2)
        return out

    # -- occlusion / visibility ------------------------------------------------

    @staticmethod
    def _ref_rays(pts: torch.Tensor, ref_camera: CameraParams) -> tuple[torch.Tensor, torch.Tensor]:
        """Rays from the ref camera through points [B, N, 3]: the camera-space
        direction scaled to z = -1 and the same direction in world space."""
        p_cam = torch.einsum("bij,bnj->bni", ref_camera.extrinsics[:, :, :3], pts) + ref_camera.extrinsics[:, None, :, 3]
        rays_d_ref = p_cam / (-p_cam[..., 2:3])
        return rays_d_ref, torch.einsum("bij,bnj->bni", ref_camera.poses[:, :, :3], rays_d_ref)

    def _occlusion_precision(self) -> str:
        return field_precision(self.cfg.occlusion_field_dtype or self.cfg.field_dtype)

    def query_hit_prob(
        self,
        wd_pts: torch.Tensor,
        ref_camera: CameraParams,
        ref_styles: torch.Tensor,
        return_type: str = "weights",
        n_chunks: int = 16,
    ) -> torch.Tensor:
        """Occlusion query (`volume_renderer.py:291-396`; reference
        `query_hitting_probability_fixed_interval`): re-integrate an
        n_samples-point ray from the REFERENCE camera through every query point
        wd_pts [B, H, W, S, 3] and lerp its hit probability (or transmittance)
        at the point's fractional depth-interval index -> [B, H, W, S, 1].

        The per-point rays run in `n_chunks` chunks, one field launch each, to
        bound memory: the kernel writes `feat` for every field point. The
        field runs in `occlusion_field_dtype or field_dtype`; under
        `static_viewdirs` it sees camera-space directions (reference
        volume_renderer.py:1420-1423)."""
        if return_type not in ("weights", "visibility"):
            raise ValueError(f"return_type must be 'weights' or 'visibility', got {return_type!r}")
        c = self.cfg
        B, H, W, S, _ = wd_pts.shape
        N, S_ray = H * W * S, c.n_samples
        rays_o = ref_camera.poses[:, :, 3]
        pts = wd_pts.reshape(B, N, 3)
        rays_d_ref, rays_d_wd = self._ref_rays(pts, ref_camera)
        d_norm = torch.linalg.norm(rays_d_wd, dim=-1, keepdim=True)
        viewdirs = (rays_d_ref if c.static_viewdirs else rays_d_wd) / d_norm
        t = _t_vals(S_ray, c.offset_sampling, pts.device)
        z_vals = ref_camera.near.reshape(B, 1, 1) * (1.0 - t) + ref_camera.far.reshape(B, 1, 1) * t  # [B, 1, S_ray]
        interval = (z_vals[..., 1:2] - z_vals[..., 0:1]) * d_norm  # [B, N, 1]
        # fractional interval index of the query point along its own ray
        q0 = rays_o[:, None] + rays_d_wd * z_vals[..., 0:1]
        idx = torch.linalg.norm(pts - q0, dim=-1, keepdim=True) / interval + 1e-5
        idx_floor = torch.clamp(torch.floor(idx), 0, S_ray - 1)
        idx_ceil = torch.clamp(torch.ceil(idx), 0, S_ray - 1)

        precision = self._occlusion_precision()
        chunk = -(-N // n_chunks)
        occ = []
        for lo in range(0, N, chunk):
            rd, vd = rays_d_wd[:, lo : lo + chunk], viewdirs[:, lo : lo + chunk]
            zv = z_vals.expand(B, rd.shape[1], S_ray)
            q = rays_o[:, None, None] + rd[:, :, None] * zv[..., None]  # [B, chunk, S_ray, 3]
            _, rgb_sdf, _ = self._field(q, vd[:, :, None].expand(q.shape), ref_styles, precision=precision)
            # normalised viewdirs: the dists are scaled by d_norm through interval
            out = volume_integrate(
                rgb_sdf[..., :3], rgb_sdf[..., 3:4], None, zv, vd, q, self.sigmoid_beta,
                force_background=False, no_force_stop=True, fg_mask_threshold=c.fg_mask_threshold,
            )
            occ.append((out.weights if return_type == "weights" else out.visibility)[..., 0])
        occ = torch.cat(occ, dim=1)  # [B, N, S_ray]
        floor_v = torch.gather(occ, -1, idx_floor.long())
        ceil_v = torch.gather(occ, -1, idx_ceil.long())
        return (floor_v + (idx - idx_floor) * (ceil_v - floor_v)).reshape(B, H, W, S, 1)

    def query_hit_prob_texture(
        self, wd_pts: torch.Tensor, ref_camera: CameraParams, ref_hit_prob: torch.Tensor
    ) -> torch.Tensor:
        """Light-field approximation of `query_hit_prob` (`:398-461`, the
        `occlusion_mode="texture"` opt-in): sample the ref render's own weight
        volume ref_hit_prob [B, Hr, Wr, Sr, 1] bilinearly over its ray grid and
        linearly over the canonical depth-interval grid, with no field
        evaluation -> [B, H, W, Sq, 1]."""
        c = self.cfg
        B, H, W, Sq, _ = wd_pts.shape
        N = H * W * Sq
        Hr, Wr, Sr = ref_hit_prob.shape[1:4]
        pts = wd_pts.reshape(B, N, 3)
        p_cam = torch.einsum("bij,bnj->bni", ref_camera.extrinsics[:, :, :3], pts) + ref_camera.extrinsics[:, None, :, 3]
        inv_z = 1.0 / (-p_cam[..., 2])
        # get_rays' pixel convention: torch-style ndc u = 2 * f * x_ndc / res
        f = ref_camera.focal.reshape(B, 1)
        u = 2.0 * f * p_cam[..., 0] * inv_z / Wr
        v = -2.0 * f * p_cam[..., 1] * inv_z / Hr
        grid = torch.stack([u, v], dim=-1)[:, :, None, :]  # [B, N, 1, 2]
        vol = ref_hit_prob[..., 0].permute(0, 3, 1, 2)  # [B, Sr, Hr, Wr]
        occ = grid_sample(vol, grid)[..., 0].permute(0, 2, 1)  # [B, N, Sr]

        # the ray parameter is the camera-space depth (z = -1 directions)
        t = _t_vals(Sr, c.offset_sampling, pts.device)
        near, far = ref_camera.near.reshape(B, 1), ref_camera.far.reshape(B, 1)
        z0 = near * (1.0 - t[0]) + far * t[0]
        z1 = near * (1.0 - t[1]) + far * t[1]
        idx = ((-p_cam[..., 2] - z0) / (z1 - z0) + 1e-5)[..., None]  # [B, N, 1]
        idx_floor = torch.clamp(torch.floor(idx), 0, Sr - 1)
        idx_ceil = torch.clamp(torch.ceil(idx), 0, Sr - 1)
        floor_v = torch.gather(occ, -1, idx_floor.long())
        ceil_v = torch.gather(occ, -1, idx_ceil.long())
        w = torch.clamp(idx - idx_floor, 0.0, 1.0)
        return (floor_v + w * (ceil_v - floor_v)).reshape(B, H, W, Sq, 1)

    def query_hit_prob_adapted(
        self, wd_pts: torch.Tensor, ref_camera: CameraParams, ref_styles: torch.Tensor, n_chunks: int = 16
    ) -> torch.Tensor:
        """Adapted-interval occlusion query (`:463-529`; reference
        `query_hitting_probability_adapted_interval`): n_samples points from
        the ref near plane to each query point, integrated, keeping the last
        sample's hit probability -> [B, H, W, S, 1]. Chunked as
        `query_hit_prob`."""
        c = self.cfg
        B, H, W, S, _ = wd_pts.shape
        N, S_ray = H * W * S, c.n_samples
        rays_o = ref_camera.poses[:, :, 3]
        pts = wd_pts.reshape(B, N, 3)
        rays_d_ref, rays_d_wd = self._ref_rays(pts, ref_camera)
        vd_src = rays_d_ref if c.static_viewdirs else rays_d_wd
        viewdirs = vd_src / torch.linalg.norm(vd_src, dim=-1, keepdim=True)
        near_pts = rays_o[:, None] + rays_d_wd * ref_camera.near.reshape(B, 1, 1)  # [B, N, 3]
        t = torch.linspace(0.0, 1.0, S_ray, device=pts.device)[None, None, :, None]  # no offset sampling (ref :1556)

        precision = self._occlusion_precision()
        chunk = -(-N // n_chunks)
        hp = []
        for lo in range(0, N, chunk):
            np_, p, vd = (x[:, lo : lo + chunk] for x in (near_pts, pts, viewdirs))
            q = np_[:, :, None] * (1.0 - t) + p[:, :, None] * t  # [B, chunk, S_ray, 3]
            zv = torch.linalg.norm(q - rays_o[:, None, None], dim=-1)  # true arc length
            _, rgb_sdf, _ = self._field(q, vd[:, :, None].expand(q.shape), ref_styles, precision=precision)
            out = volume_integrate(
                rgb_sdf[..., :3], rgb_sdf[..., 3:4], None, zv, vd, q, self.sigmoid_beta,
                force_background=False, no_force_stop=True, fg_mask_threshold=c.fg_mask_threshold,
            )
            hp.append(out.weights[..., -1, :])  # the query point's own hit probability
        return torch.cat(hp, dim=1).reshape(B, H, W, S, 1)

    # -- mesh ----------------------------------------------------------------

    def sdf_grid_points(self, camera: CameraParams) -> torch.Tensor:
        """The frustum samples of `render_sdf_grid`: [B, H, W, S, 3] world
        points at out_im_res x n_samples, without jitter."""
        c = self.cfg
        res = c.out_im_res
        rays_o, rays_d, _ = get_rays(camera.focal, camera.poses, res)
        z_vals = sample_z_vals(camera.near, camera.far, (rays_o.shape[0], res, res), c.n_samples, c.offset_sampling)
        return rays_to_points(rays_o, rays_d, z_vals)

    def render_sdf_grid(self, camera: CameraParams, styles: torch.Tensor) -> torch.Tensor:
        """Frustum SDF samples for the mesh (`:584-602`): [B, H, W, S, 1] from
        one field launch at `sdf_grid_points`."""
        return self.query_sdf(self.sdf_grid_points(camera), styles)

    # -- 3D-supervision sampling (DATASETGAN_3D support) -----------------------

    def sample_uniform_grid(
        self, batch: int, n: int, styles: torch.Tensor, generator: torch.Generator | None = None,
        pts: torch.Tensor | None = None,
    ):
        """Uniform points in the [-r, r]^3 box (r = camera_dist_radius) with
        their SDF and an all-ones validity mask (`:533-538`, reference
        volume_renderer.py:945-963). pts [batch, n, 3], if given, are the
        draw; else it comes from `generator` on the styles' device."""
        r = self.camera_dist_radius
        if pts is None:
            pts = (mesh.draw_rows(lambda s: torch.rand(s, device=styles.device, generator=generator), (batch, n, 3))
                   * 2 - 1) * r
        sdf = self.query_sdf(pts, styles)
        return pts, sdf, torch.ones_like(sdf)

    def sample_near_surface_grid(
        self, surface_xyz: torch.Tensor, styles: torch.Tensor, stdv: float = 0.03,
        generator: torch.Generator | None = None, noise: torch.Tensor | None = None,
    ):
        """Surface points [B, H, W, 3] moved by stdv * N(0, 1), their SDF and
        a mask of those inside the box (`:540-549`, reference
        volume_renderer.py:965-1003). noise, if given, is the N(0, 1) draw."""
        if noise is None:
            noise = mesh.draw_rows(lambda s: torch.randn(s, device=surface_xyz.device, generator=generator),
                                   surface_xyz.shape)
        pts = surface_xyz + stdv * noise
        valid = (pts.abs().amax(dim=-1, keepdim=True) < self.camera_dist_radius).to(pts.dtype)
        return pts, self.query_sdf(pts, styles), valid
