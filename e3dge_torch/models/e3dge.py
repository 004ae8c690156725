"""E3DGE — single-image inversion through the local branch; counterpart of
`e3dge_tpu/models/e3dge.py` (reference runners: trainer.py:935-1015,
e3dge_full_runner.py:77-317, e3dge_2dalignonly_runner.py:303).

E0 (FPN encoder) predicts W+ offsets, the volume D's viewpoint head the pose,
G0 renders once keeping the backbone hidden, the E1 branch (hourglass filter on
the residual, ADA aligner, a second filter at the query view, one paired
pixel-aligned lookup, SFT fusion + PE) gives texture modulations, and a
texture-only re-render on the cached backbone feeds G1. Both G0 field passes
run the hand-written field kernel on the card.

Serving only (`train=False`). Not ported yet: other branches of
`que_render_given_ref` (ROADMAP A11), `image2image_global`, `render_multiview`,
editing, mesh and training.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from e3dge_torch.config import E3DGEConfig
from e3dge_torch.models.align import FuseSftMLP, ResidualAligner
from e3dge_torch.models.discriminator import VolumeRenderDiscriminator
from e3dge_torch.models.encoders.fpn import HybridGradualStyleEncoderV2
from e3dge_torch.models.generator import Generator
from e3dge_torch.models.pifu.local_net import LocalFeatureNet
from e3dge_torch.ops import adaptive_avg_pool, pos_encoding, upsample_nearest
from e3dge_torch.render.camera import CameraParams, camera_params_from_angles
from e3dge_torch.utils.device import resolve_device


class LatentMeans(NamedTuple):
    """W+ mean latents the encoder offsets are added to (train_setup.py:296-308)."""

    renderer: torch.Tensor  # [1, 9, 256]
    decoder: torch.Tensor   # [1, 10, 512]


class E3DGE(nn.Module):
    """The inversion model. `device=None` means the card: with no CUDA device
    the constructor raises; pass device="cpu" to run the plain versions on
    the CPU. The module is built in eval mode (BatchNorm uses running stats)."""

    def __init__(self, cfg: E3DGEConfig, device: str | torch.device | None = None):
        super().__init__()
        self.cfg = c = cfg
        if not c.renderer.enable_local_model:
            raise NotImplementedError("the global-only path (image2image_global) is not ported yet")
        self.encoder = HybridGradualStyleEncoderV2(c.encoder)
        self.generator = Generator(c, full_pipeline=c.full_pipeline)
        self.volume_discriminator = VolumeRenderDiscriminator(init_size=c.renderer.out_im_res)
        self.local = LocalFeatureNet(
            c.pifu, modulation_width=c.renderer.width, local_feats_dim=c.renderer.residual_local_feats_dim
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

    def mean_latent(self, n: int = 10000, generator: torch.Generator | None = None) -> LatentMeans:
        r_mean, d_mean = self.generator.mean_latent(n, generator)
        c = self.cfg
        return LatentMeans(
            renderer=r_mean[:, None].repeat(1, c.renderer.depth + 1, 1),
            decoder=d_mean[:, None].repeat(1, c.decoder.n_latent, 1),
        )

    # ------------------------------------------------------------------ E0 + pose

    def image2latents(self, images: torch.Tensor, mean_latents: LatentMeans) -> dict[str, Any]:
        """E0 forward; offsets + mean latents -> the predicted W+ pair (f32)."""
        c = self.cfg
        x = adaptive_avg_pool(images, c.encoder.input_res).to(self.compute_dtype)
        out = self.encoder(x, return_featmap=True)
        off_r, off_d = out["pred_latents"]
        out["pred_latents"] = [mean_latents.renderer + off_r.float(), mean_latents.decoder + off_d.float()]
        return out

    def image2camsettings(self, images: torch.Tensor) -> CameraParams:
        """Pose from the volume D's viewpoint head, in the compute dtype."""
        c = self.cfg
        thumb = adaptive_avg_pool(images, c.renderer.out_im_res).to(self.compute_dtype)
        _, locations = self.volume_discriminator(thumb)
        locations = locations.float()
        return camera_params_from_angles(
            locations[:, 0], locations[:, 1], c.renderer.out_im_res, c.camera.fov_ang, c.camera.dist_radius
        )

    # ------------------------------------------------------------------- E1 path

    def encode_ref_images(
        self, images: torch.Tensor, mean_latents: LatentMeans, camera: CameraParams | None = None
    ) -> dict[str, Any]:
        """Latents, pose, the global render (with the backbone cache `raw_h`),
        the residual, and the reference-view hourglass feature volume."""
        c = self.cfg
        input_imgs = adaptive_avg_pool(images, c.pifu.load_size)
        encoder_out = self.image2latents(input_imgs, mean_latents)
        pred_latents = encoder_out["pred_latents"]
        cam = camera if camera is not None else self.image2camsettings(input_imgs)
        render_out = self.generator(pred_latents, cam, renderer_only=True, return_raw_h=True)
        thumb_256 = upsample_nearest(render_out["gen_thumb_imgs"], c.pifu.load_size)
        res_gt = input_imgs - thumb_256
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
    ) -> dict[str, Any]:
        """Render the query view conditioned on the reference residual features.
        Ported: the same-view branch with the backbone cache and no ref-view
        occlusion weighting (what `image2image` takes)."""
        if not (same_view and reuse_backbone and not use_ref_view_weight and que_info is not None):
            raise NotImplementedError(
                "que_render_given_ref: only same_view=True, reuse_backbone=True, "
                "use_ref_view_weight=False with que_info is ported (ROADMAP A11)"
            )
        c = self.cfg
        pred_latents = ref_info["pred_latents"]
        ref_calibs = ref_info["cam_settings"].calibs
        que_pts = que_info["points"]
        B, H, W, S, _ = que_pts.shape

        # ADA 2D alignment at the query view + the hourglass filter on it
        dt = self.compute_dtype
        que_thumb_256 = upsample_nearest(que_info["gen_thumb_imgs"], c.pifu.load_size)
        aligned_res = self.grid_align(torch.cat([ref_info["orig_res_gt"], que_thumb_256], dim=1).to(dt)).float()
        que_depth = que_info["depth"][..., 0].permute(0, 3, 1, 2)
        que_depth_256 = upsample_nearest(que_depth, c.pifu.load_size)
        que_feat = self.local.filter(aligned_res.to(dt), que_depth_256.to(dt))

        # same view: both lookups are ray-constant and share one projection —
        # one paired sample at the HW sample-0 points, broadcast over S
        pts_ray = que_pts[:, :, :, 0, :].reshape(B, -1, 3).permute(0, 2, 1)
        q = self.local.query_pair(ref_info["ref_view_aligned_feat"], que_feat, pts_ray, ref_calibs)
        fa = q["feats_a"].permute(0, 2, 1).reshape(B, H, W, 1, -1)
        fb = q["feats_b"].permute(0, 2, 1).reshape(B, H, W, 1, -1)
        feature_3d = fa.expand(B, H, W, S, fa.shape[-1])
        feature_2d = fb.expand(B, H, W, S, fb.shape[-1])
        # the surface points reproject to their own pixel centres: all visible
        vis_mask = torch.ones(B, H, W, S, 1, device=que_pts.device, dtype=que_pts.dtype)

        # SFT fusion of (2D feats + visibility) into the 3D feats, + PE; the
        # fusion path runs in the field dtype
        fdt = self.field_dtype
        feature_2d = torch.cat([feature_2d.to(fdt), vis_mask.to(fdt)], dim=-1)
        fused = self.fuse_sft_block(feature_2d, feature_3d.to(fdt), w=fusion_weight)
        pe = pos_encoding(que_pts, n_freqs=7).to(fdt)
        alpha, beta = self.local.tex_modulations((fused, pe))

        res_render_out = self.generator.render_cached(
            pred_latents, que_info, (alpha, beta), noise=noise, generator=generator
        )
        return {
            "res_render_out": res_render_out,
            "aligned_res": aligned_res,
            "in_img_mask": q["in_img"].reshape(B, H, W, -1, 1),
            "que_info": que_info,
            "ref_hit_prob": None,
        }

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
