"""E3DGE — single-image inversion and novel views; counterpart of
`e3dge_tpu/models/e3dge.py` (reference runners: trainer.py:935-1015,
e3dge_full_runner.py:77-317, e3dge_2dalignonly_runner.py:303).

E0 (FPN encoder) predicts W+ offsets, the volume D's viewpoint head the pose,
G0 renders once keeping the backbone hidden, the E1 branch (hourglass filter on
the residual, ADA aligner, a second filter at the query view, pixel-aligned
lookups, SFT fusion + PE) gives texture modulations, and a conditioned
re-render feeds G1: texture-only on the cached backbone at the reference view
(`image2image`), the whole field with the SFT on the query render's samples at
another (`que_render_given_ref`, `render_multiview`). `image2image_global` is
the global-only path (E0 -> G0 -> G1) of a model built without the local
branch. Every G0 field pass of serving runs the hand-written field kernel on
the card.

Training: `image2latents`, `latent2image`, `image2image_global` (stage 1),
`encode_ref_images` and `que_render_given_ref` (stage 2) take `train=True` —
the caller's grad mode, every BatchNorm (E0's and the aligner's) in train mode
for the call — and a G0 render that then needs a gradient evaluates the eager
twin; so does `query_sdf(train=True)`. In stage 2 only the texture
modulations carry a gradient: the query render launches the kernel and keeps
its backbone, and the conditioned re-render runs the twin's texture head on
it. `synthetic_sample` draws frozen-GAN training data under no_grad, through
the kernel. With `train=False` (the default) the entry points serve under
no_grad.

Under the ray split of a cycle step (`parallel.mesh.sharded(world,
rays=True)`, sp > 1) every G0 render returns its image maps whole and its
per-ray outputs at the rank's rows, so the 2D work (E0, G1, the hourglass
filters, the aligner) runs whole on each sp rank while the per-sample work
(the lookups at the query points, SFT fusion, PE, the occlusion weighting,
the conditioned re-render) runs on the rank's rays only.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, NamedTuple

import torch
from torch import nn

from e3dge_torch.config import E3DGEConfig
from e3dge_torch.models.align import FuseSftMLP, ResidualAligner
from e3dge_torch.models.discriminator import VolumeRenderDiscriminator
from e3dge_torch.models.encoders.fpn import HybridGradualStyleEncoderV2
from e3dge_torch.models.generator import Generator
from e3dge_torch.models.pifu.local_net import LocalFeatureNet, points_in_image
from e3dge_torch.ops import adaptive_avg_pool, pos_encoding, upsample_nearest
from e3dge_torch.parallel import mesh
from e3dge_torch.render.camera import CameraParams, camera_params_from_angles
from e3dge_torch.utils.device import resolve_device
from e3dge_torch.utils.trace import span


class LatentMeans(NamedTuple):
    """W+ mean latents the encoder offsets are added to (train_setup.py:296-308)."""

    renderer: torch.Tensor  # [1, 9, 256]
    decoder: torch.Tensor   # [1, 10, 512]


class E3DGE(nn.Module):
    """The inversion model. `device=None` means the card: with no CUDA device
    the constructor raises; pass device="cpu" to run the plain versions on
    the CPU. The module is built in eval mode (BatchNorm uses running stats).
    Without `renderer.enable_local_model` it has no `local`, `grid_align` or
    `fuse_sft_block` and serves `image2image_global` only."""

    def __init__(self, cfg: E3DGEConfig, device: str | torch.device | None = None):
        super().__init__()
        self.cfg = c = cfg
        self.encoder = HybridGradualStyleEncoderV2(c.encoder)
        self.generator = Generator(c, full_pipeline=c.full_pipeline)
        self.volume_discriminator = VolumeRenderDiscriminator(init_size=c.renderer.out_im_res)
        if c.renderer.enable_local_model:
            self.local = LocalFeatureNet(
                c.pifu, modulation_width=c.renderer.width, local_feats_dim=c.renderer.residual_local_feats_dim,
                variant="bn" if c.pifu.netLocal_type == "HGPIFuNetGANResidual" else "resnetfc",
            )
            self.grid_align = ResidualAligner()
            self.fuse_sft_block = FuseSftMLP(2 * c.pifu.hourglass_dim + 1, out_ch=c.pifu.hourglass_dim)
        self.device = resolve_device(device)
        self.to(self.device)
        self.eval()

    @property
    def compute_dtype(self) -> torch.dtype:
        """Conv-stack activation dtype (config `dtype`); params stay f32."""
        return getattr(torch, self.cfg.dtype)

    @property
    def field_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.renderer.field_dtype)

    @contextmanager
    def _mode(self, train: bool):
        """One call's mode, as flax's `train=`: serving (train False) runs under
        no_grad with every BatchNorm (E0's, the aligner's, the "bn" netLocal's)
        on its running statistics; a training call keeps the caller's grad
        mode and runs them in train mode for the call only (batch statistics,
        running statistics updated), trained or frozen alike, as JAX's steps
        do."""
        mods = [m for m in (self.encoder, getattr(self, "grid_align", None), getattr(self, "local", None))
                if m is not None]
        was = [m.training for m in mods]
        for m in mods:
            m.train(train)
        try:
            with torch.set_grad_enabled(train and torch.is_grad_enabled()):
                yield
        finally:
            for m, w in zip(mods, was):
                m.train(w)

    def mean_latent(self, n: int = 10000, generator: torch.Generator | None = None) -> LatentMeans:
        r_mean, d_mean = self.generator.mean_latent(n, generator)
        c = self.cfg
        return LatentMeans(
            renderer=r_mean[:, None].repeat(1, c.renderer.depth + 1, 1),
            decoder=d_mean[:, None].repeat(1, c.decoder.n_latent, 1),
        )

    # ------------------------------------------------------------------ E0 + pose

    def image2latents(self, images: torch.Tensor, mean_latents: LatentMeans, train: bool = False) -> dict[str, Any]:
        """E0 forward; offsets + mean latents -> the predicted W+ pair (f32).
        train: batch-statistics BatchNorm with the running-stat update, grad kept."""
        c = self.cfg
        with span("e0.encoder"):
            x = adaptive_avg_pool(images, c.encoder.input_res).to(self.compute_dtype)
            with self._mode(train):
                out = self.encoder(x, return_featmap=True)
            off_r, off_d = out["pred_latents"]
            out["pred_latents"] = [mean_latents.renderer + off_r.float(), mean_latents.decoder + off_d.float()]
        return out

    def image2camsettings(self, images: torch.Tensor) -> CameraParams:
        """Pose from the volume D's viewpoint head, in the compute dtype."""
        c = self.cfg
        with span("e0.pose"):
            thumb = adaptive_avg_pool(images, c.renderer.out_im_res).to(self.compute_dtype)
            _, locations = self.volume_discriminator(thumb)
            locations = locations.float()
            return camera_params_from_angles(
                locations[:, 0], locations[:, 1], c.renderer.out_im_res, c.camera.fov_ang, c.camera.dist_radius
            )

    # -------------------------------------------------------------------- render

    def latent2image(
        self,
        pred_latents,
        camera: CameraParams,
        local_conditions: tuple[torch.Tensor, torch.Tensor] | None = None,
        renderer_only: bool = False,
        z_vals: torch.Tensor | None = None,
        noise=None,
        return_raw_h: bool = False,
        generator: torch.Generator | None = None,
        train: bool = False,
    ) -> dict[str, Any]:
        """The generator on a W+ pair: G0 at `camera` (on `z_vals` if given,
        SFT-modulated by `local_conditions`) and, unless renderer_only, G1.
        train keeps the grad (G0 then runs the twin where the latents need
        one) and lets `generator` jitter the depth samples."""
        with self._mode(train):
            return self.generator(
                pred_latents, camera, local_conditions=local_conditions, renderer_only=renderer_only,
                noise=noise, return_raw_h=return_raw_h, generator=generator, z_vals=z_vals, train=train,
            )

    # ------------------------------------------------------------------- E1 path

    def encode_ref_images(
        self, images: torch.Tensor, mean_latents: LatentMeans, camera: CameraParams | None = None,
        train: bool = False,
    ) -> dict[str, Any]:
        """Latents, pose, the global render (with the backbone cache `raw_h`
        when serving: a training query view differs from the ref view), the
        residual (a constant), and the reference-view hourglass feature
        volume. train: see `_mode`."""
        c = self.cfg
        with self._mode(train):
            input_imgs = adaptive_avg_pool(images, c.pifu.load_size)
            encoder_out = self.image2latents(input_imgs, mean_latents, train=train)
            pred_latents = encoder_out["pred_latents"]
            cam = camera if camera is not None else self.image2camsettings(input_imgs)
            render_out = self.latent2image(pred_latents, cam, renderer_only=True, return_raw_h=not train,
                                           train=train)
            thumb_256 = upsample_nearest(render_out["gen_thumb_imgs"], c.pifu.load_size)
            res_gt = (input_imgs - thumb_256).detach()
            depth = render_out["depth"][..., 0].permute(0, 3, 1, 2)  # [B, 1, H, W]
            depth_256 = upsample_nearest(depth, c.pifu.load_size)
            dt = self.compute_dtype
            ref_feat = self.local.filter(res_gt.to(dt), depth_256.to(dt))
        return {
            "ref_view_aligned_feat": ref_feat,
            "imgs": input_imgs,
            "cam_settings": cam,
            "orig_res_gt": res_gt,
            "global_render_out": render_out,
            "res_gt": res_gt,
            "encoder_out": encoder_out,
            "pred_latents": pred_latents,
        }

    def que_render_given_ref(
        self,
        ref_info: dict[str, Any],
        que_camera: CameraParams,
        que_info: dict[str, Any] | None = None,
        fusion_weight: float = 1.0,
        use_ref_view_weight: bool = False,
        reuse_backbone: bool = False,
        same_view: bool = False,
        noise=None,
        generator: torch.Generator | None = None,
        train: bool = False,
    ) -> dict[str, Any]:
        """Render the query view conditioned on the reference residual features
        (`e3dge_tpu/models/e3dge.py:220-418`): 3D-projected ref features + 2D
        query features aligned by ADA + visibility mask -> SFT fusion + PE ->
        texture modulations -> full-pipeline render on the query samples.

        que_info: the query view's global render; None renders it first (one
        field launch). same_view declares que_camera == the ref camera (what
        `image2image` passes): both lookups are ray-constant, fused into one,
        and the visibility mask is all ones. reuse_backbone re-renders the
        texture head only, on que_info's cached `raw_h`; otherwise the whole
        field runs again with the SFT on que_info's z samples.
        use_ref_view_weight weights the 3D-projected features by the
        occlusion of each query point seen from the ref camera
        (`renderer.occlusion_mode`: "exact" re-integrates a ray per point,
        "texture" samples the ref render's weights, falling back to exact when
        ref_info has no `global_render_out`), with the force-background
        correction on the last sample; the weighting is data (no gradient).

        train (stage-2 cycle training, see `_mode`): unless the latents need
        a gradient, the query render keeps its backbone `raw_h` and the
        conditioned re-render runs the texture head only on it, under autograd
        (`render_from_backbone`): the SFT modulates the texture branch alone,
        so on que_info's own samples this equals JAX's full re-render."""
        with self._mode(train):
            c = self.cfg
            pred_latents = ref_info["pred_latents"]
            ref_calibs = ref_info["cam_settings"].calibs

            # 1. the global render at the query view (points, depth, thumb);
            # in training it keeps raw_h when only the texture modulations
            # will need a gradient
            tail_trains = train and not pred_latents[0].requires_grad
            if que_info is None:
                que_info = self.latent2image(pred_latents, que_camera, renderer_only=True, return_raw_h=tail_trains,
                                             train=train)
            que_pts = que_info["points"]
            B, H, W, S, _ = que_pts.shape

            with span("e1.fusion"):
                # 4 (hoisted). ADA 2D alignment at the query view + the hourglass filter on it
                dt = self.compute_dtype
                que_thumb_256 = upsample_nearest(que_info["gen_thumb_imgs"], c.pifu.load_size)
                aligned_res = self.grid_align(torch.cat([ref_info["orig_res_gt"], que_thumb_256], dim=1).to(dt)).float()
                que_depth = que_info["depth"][..., 0].permute(0, 3, 1, 2)
                que_depth_256 = upsample_nearest(que_depth, c.pifu.load_size)
                que_feat = self.local.filter(aligned_res.to(dt), que_depth_256.to(dt))

                # 2. 3D-projected ref features (at the REF calibs) and 4b. query features
                # (at the QUE calibs). The que-side lookup is ray-constant: every sample
                # of a ray projects to the ray's own pixel in the camera that cast it,
                # so it runs on the HW sample-0 points and broadcasts over S.
                pts_ray = que_pts[:, :, :, 0, :].reshape(B, -1, 3).permute(0, 2, 1)
                if same_view:
                    # ref IS the query camera: both lookups share one projection
                    proj = self.local.query_pair(ref_info["ref_view_aligned_feat"], que_feat, pts_ray, ref_calibs)
                    fa = proj["feats_a"].permute(0, 2, 1).reshape(B, H, W, 1, -1)
                    fb = proj["feats_b"].permute(0, 2, 1).reshape(B, H, W, 1, -1)
                    feature_3d = fa.expand(B, H, W, S, fa.shape[-1])
                    feature_2d = fb.expand(B, H, W, S, fb.shape[-1])
                else:
                    # the ref-side lookup is per point: que points projected into the REF view
                    pts_all = que_pts.reshape(B, -1, 3).permute(0, 2, 1)
                    proj = self.local.query(ref_info["ref_view_aligned_feat"], pts_all, ref_calibs)
                    q2 = self.local.query(que_feat, pts_ray, que_camera.calibs)
                    f2 = q2["feats"].permute(0, 2, 1).reshape(B, H, W, 1, -1)
                    feature_2d = f2.expand(B, H, W, S, f2.shape[-1])
                    feature_3d = proj["feats"].permute(0, 2, 1).reshape(B, H, W, S, -1)

                ref_hit_prob = None
                if use_ref_view_weight:
                    ref_hit_prob = self._ref_view_weight(ref_info, que_pts)
                    in_img = proj["in_img"]
                    in_img = in_img.reshape(B, H, W, 1 if in_img.shape[1] == H * W else S, 1)
                    ref_hit_prob = ref_hit_prob * in_img.to(feature_3d.dtype)
                    feature_3d = feature_3d * ref_hit_prob

                # 3. visibility: the query surface xyz projected into the ref view. At
                # the same view each surface point reprojects to its own pixel centre,
                # so the mask is all ones.
                if same_view:
                    vis_mask = torch.ones(B, H, W, S, 1, device=que_pts.device, dtype=que_pts.dtype)
                else:
                    xyz = que_info["xyz"].reshape(B, -1, 3).permute(0, 2, 1)
                    vis_mask = points_in_image(xyz, ref_calibs).reshape(B, H, W, 1, 1).to(que_pts.dtype)
                    vis_mask = vis_mask.expand(B, H, W, S, 1)

                # 5. SFT fusion of (2D feats + visibility) into the 3D feats, + PE; the
                # fusion path runs in the field dtype
                fdt = self.field_dtype
                feature_2d = torch.cat([feature_2d.to(fdt), vis_mask.to(fdt)], dim=-1)
                fused = self.fuse_sft_block(feature_2d, feature_3d.to(fdt), w=fusion_weight)
                pe = pos_encoding(que_pts, n_freqs=7).to(fdt)
                alpha, beta = self.local.tex_modulations((fused, pe))

            # 6. modulations + the conditioned render on the query's samples
            if "raw_h" in que_info and (reuse_backbone or tail_trains):
                res_render_out = self.generator.render_cached(
                    pred_latents, que_info, (alpha, beta), noise=noise, generator=generator
                )
            else:
                res_render_out = self.latent2image(
                    pred_latents, que_camera, local_conditions=(alpha, beta), z_vals=que_info["z_vals"],
                    noise=noise, generator=generator, train=train,
                )
            return {
                "res_render_out": res_render_out,
                "aligned_res": aligned_res,
                # [B, H, W, 1, 1] for the ray-constant same-view lookup, [B, H, W, S, 1] per point
                "in_img_mask": proj["in_img"].reshape(B, H, W, -1, 1),
                "que_info": que_info,
                "ref_hit_prob": ref_hit_prob,
            }

    def _ref_view_weight(self, ref_info: dict[str, Any], que_pts: torch.Tensor) -> torch.Tensor:
        """Occlusion of the query points [B, H, W, S, 3] seen from the ref
        camera, [B, H, W, S, 1] (reference cycle_runner.py:133-161). With
        `force_background` all but the last sample are queried and the last
        takes the leftover mass 1 - sum. Data, as in JAX: the points, styles
        and ref weight volume are detached, so the exact query launches the
        kernel under a training step too."""
        c, renderer = self.cfg.renderer, self.generator.renderer
        cam = ref_info["cam_settings"]
        que_pts = que_pts.detach()
        if c.occlusion_mode == "texture" and "global_render_out" in ref_info:
            # the ref render's whole weight volume: a query point projects anywhere in it
            ref_vol = mesh.gather_rays(ref_info["global_render_out"]["hit_prob"].detach())
            query = lambda p: renderer.query_hit_prob_texture(p, cam, ref_vol)  # noqa: E731
        else:
            styles = ref_info["pred_latents"][0].detach()
            query = lambda p: renderer.query_hit_prob(p, cam, styles)  # noqa: E731
        if not c.force_background:
            return query(que_pts)
        hp = query(que_pts[..., :-1, :])
        return torch.cat([hp, 1.0 - hp.sum(dim=-2, keepdim=True)], dim=-2)

    @torch.no_grad()
    def render_multiview(
        self,
        ref_info: dict[str, Any],
        cameras: CameraParams,
        n_views: int,
        noise=None,
        generator: torch.Generator | None = None,
    ) -> dict[str, Any]:
        """Novel views: V views of each of B references rendered as one batch
        of B*V (`e3dge.py:420-447`). cameras holds B*V entries ordered b0v0,
        b0v1, ..., b1v0, ...; noise, if given, is a list of [B*V, 1, h, w]
        maps. The tiled ref_info carries no ref render, so "texture" occlusion
        falls back to exact here, as in the JAX function."""
        def tile(x):
            return x.repeat_interleave(n_views, dim=0)

        tiled_ref = {
            "ref_view_aligned_feat": tile(ref_info["ref_view_aligned_feat"]),
            "orig_res_gt": tile(ref_info["orig_res_gt"]),
            "pred_latents": [tile(ref_info["pred_latents"][0]), tile(ref_info["pred_latents"][1])],
            "cam_settings": CameraParams(*(tile(f) for f in ref_info["cam_settings"])),
        }
        return self.que_render_given_ref(tiled_ref, cameras, noise=noise, generator=generator)

    # ------------------------------------------------------------------ user API

    @torch.no_grad()
    def image2image(
        self,
        images: torch.Tensor,
        mean_latents: LatentMeans,
        camera: CameraParams | None = None,
        noise=None,
        generator: torch.Generator | None = None,
    ) -> dict[str, Any]:
        """Invert [B, 3, H, W] images in [-1, 1] and reconstruct them at the
        estimated pose through the full 2D + 3D hybrid path. `noise` (a list of
        the decoder's per-layer noise maps) or `generator` fixes the decoder
        noise. Output: `res_render_out["gen_imgs"]` [B, 3, size, size]."""
        ref_info = self.encode_ref_images(images, mean_latents, camera=camera)
        out = self.que_render_given_ref(
            ref_info, ref_info["cam_settings"], que_info=ref_info["global_render_out"],
            reuse_backbone=True, same_view=True, noise=noise, generator=generator,
        )
        out["ref_info"] = ref_info
        return out

    def image2image_global(
        self,
        images: torch.Tensor,
        mean_latents: LatentMeans,
        camera: CameraParams | None = None,
        noise=None,
        generator: torch.Generator | None = None,
        train: bool = False,
    ) -> dict[str, Any]:
        """Global-only inversion (the stage-1 path, no E1): E0 -> G0 -> G1 at
        `camera` or the estimated pose (`e3dge.py:474-488`). train: the
        stage-1 forward (see `_mode`; `generator` would also jitter the depth
        samples, which JAX's stage-1 step does not ask for)."""
        with self._mode(train):
            encoder_out = self.image2latents(images, mean_latents, train=train)
            cam = camera if camera is not None else self.image2camsettings(images)
            render_out = self.latent2image(encoder_out["pred_latents"], cam, noise=noise, generator=generator,
                                           train=train)
        render_out["cam_settings"] = cam
        render_out["pred_latents"] = encoder_out["pred_latents"]
        return render_out

    def query_sdf(self, pts: torch.Tensor, styles: torch.Tensor, train: bool = False) -> torch.Tensor:
        """SDF [B, ..., 1] at world points [B, ..., 3] for renderer styles.
        Serving (train False) launches the kernel under no_grad; train keeps
        the caller's grad mode, so the query is differentiable (the twin)."""
        with self._mode(train):
            return self.generator.query_sdf(pts, styles)

    # ------------------------------------------------- frozen-GAN data sampling

    @torch.no_grad()
    def synthetic_sample(
        self,
        batch_size: int,
        pose_scale: float | torch.Tensor = 1.0,
        pair_same_id: bool = False,
        renderer_only: bool = False,
        generator: torch.Generator | None = None,
        draws: dict[str, torch.Tensor] | None = None,
        noise=None,
    ) -> dict[str, Any]:
        """GAN-as-dataset sampling (`e3dge.py:496-558`, reference
        DATASETGAN_3D.sample_with_rand_cams): z (odd/even sharing an identity
        with pair_same_id), gaussian cameras scaled by the pose curriculum's
        `pose_scale`, the frozen generator's render in
        `renderer.sample_field_dtype`, and 3D supervision: the SDF near the
        surface and in the box, queried with the mapped w (`latent_gt`). Data,
        not a differentiable path: under no_grad, so the render and both SDF
        queries launch the field kernel.

        The random draws come from `generator` in JAX's split order (z,
        azimuth, elevation, near-surface noise, uniform points), then the
        decoder noise. `draws` may give any of them: "z" [B, style_dim],
        "azim" / "elev" [B] standard normals, "near_noise" [B, res, res, 3]
        standard normals, "uniform_pts" [B, n, 3] points in the box. `noise`
        gives the decoder noise maps (JAX's stage-1 step renders the sample and
        the inversion with the same "noise" rng, so the same maps).

        In a data-parallel step (`parallel.mesh.sharded`) batch_size is the
        global batch: every draw is made at it, z paired first, and the result
        holds this rank's rows; `noise` holds its rows already. Under the ray
        split the render runs the rank's ray rows (images, thumbs, depth and
        mask come back whole) and the 3D targets take the rank's share: the
        near-surface points of its ray rows, its part of the uniform points;
        the per-ray entries (xyz, sdf, points, z_vals, hit_prob) hold its
        rows."""
        c, dev = self.cfg, self.device
        draws = draws or {}
        res, n_uni = c.renderer.out_im_res, c.renderer.uniform_grid_sampling_num
        b = mesh.local_batch(batch_size, pairs=pair_same_id)

        def draw(name, shape):
            return draws[name].to(dev) if name in draws else torch.randn(shape, device=dev, generator=generator)

        z = draw("z", (batch_size, c.renderer.style_dim))
        azim_n, elev_n = draw("azim", (batch_size,)), draw("elev", (batch_size,))
        near_noise = draw("near_noise", (batch_size, res, res, 3))
        r = self.generator.renderer.camera_dist_radius
        uni_pts = draws["uniform_pts"].to(dev) if "uniform_pts" in draws else \
            (torch.rand(batch_size, n_uni, 3, device=dev, generator=generator) * 2 - 1) * r
        if pair_same_id:  # make_pair_same_noise (training_utils.py:21-29)
            z = z[::2].repeat_interleave(2, dim=0)
        z, azim_n, elev_n, near_noise, uni_pts = (mesh.own_rows(t) for t in (z, azim_n, elev_n, near_noise, uni_pts))
        near_noise, uni_pts = mesh.own_rays(near_noise), mesh.own_rays(uni_pts)
        cc = c.camera
        azim = cc.azim_mean + pose_scale * cc.azim_range * azim_n
        elev = cc.elev_mean + pose_scale * cc.elev_range * elev_n
        cam = camera_params_from_angles(azim, elev, res, cc.fov_ang, cc.dist_radius)
        render_out = self.generator([z], cam, input_is_latent=False, renderer_only=renderer_only,
                                    noise=noise, generator=generator, field_dtype=c.renderer.sample_field_dtype)
        w = render_out["styles"]  # [B, style_dim]: the mapped latent, the latent_gt target
        renderer = self.generator.renderer
        near_pts, near_sdf, near_valid = renderer.sample_near_surface_grid(
            render_out["xyz"], w, stdv=c.renderer.surface_sampling_stdv, noise=near_noise)
        uni_pts, uni_sdf, uni_valid = renderer.sample_uniform_grid(b, uni_pts.shape[1], w, pts=uni_pts)
        return {
            "images": render_out["gen_imgs"],
            "thumb_images": render_out["gen_thumb_imgs"],
            "cam_settings": cam,
            "latent_gt": w,
            "xyz": render_out["xyz"],
            "depth": render_out["depth"],
            "mask": render_out["mask"],
            "sdf": render_out["sdf"],
            "points": render_out["points"],
            "z_vals": render_out["z_vals"],
            "hit_prob": render_out["hit_prob"],
            "near_pts": near_pts,
            "near_sdf": near_sdf,
            "near_valid": near_valid,
            "uniform_pts": uni_pts,
            "uniform_sdf": uni_sdf,
            "uniform_valid": uni_valid,
        }
