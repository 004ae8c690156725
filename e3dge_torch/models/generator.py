"""The StyleSDF generator: mapping + volume renderer (G0) + decoder (G1);
counterpart of `e3dge_tpu/models/generator.py` (reference
stylesdf_model.py:800-1189): W+ or z input, truncation, external z samples,
the training render (`train=`, z-jitter from `generator`), a per-call field
dtype, and the SDF queries.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from e3dge_torch.config import E3DGEConfig
from e3dge_torch.models.decoder import Decoder
from e3dge_torch.models.layers import MappingLinear
from e3dge_torch.models.volume_renderer import VolumeFeatureRenderer
from e3dge_torch.render.camera import CameraParams
from e3dge_torch.utils.trace import span


class Generator(nn.Module):
    def __init__(self, cfg: E3DGEConfig, full_pipeline: bool = True):
        super().__init__()
        self.cfg = cfg
        self.full_pipeline = full_pipeline
        sd = cfg.renderer.style_dim
        self.style = nn.Sequential(*[MappingLinear(sd, sd) for _ in range(3)])  # z -> w
        self.renderer = VolumeFeatureRenderer(cfg.renderer, camera_dist_radius=cfg.camera.dist_radius)
        if full_pipeline:
            self.decoder = Decoder(cfg.decoder)

    @torch.no_grad()
    def mean_latent(self, n_latent: int = 10000, generator: torch.Generator | None = None):
        """(renderer w mean [1, 256], decoder w mean [1, 512]) over n random z
        (stylesdf_model.py:854-864)."""
        dev = self.style[0].weight.device
        z = torch.randn(n_latent, self.cfg.renderer.style_dim, device=dev, generator=generator)
        renderer_w = self.style(z)
        decoder_mean = self.decoder.mean_latent(renderer_w) if self.full_pipeline else None
        return renderer_w.mean(dim=0, keepdim=True), decoder_mean

    def forward(
        self,
        styles: Sequence[torch.Tensor],
        camera: CameraParams,
        local_conditions: tuple[torch.Tensor, torch.Tensor] | None = None,
        renderer_only: bool = False,
        noise: Sequence | None = None,
        return_raw_h: bool = False,
        generator: torch.Generator | None = None,
        input_is_latent: bool = True,
        truncation: float = 1.0,
        truncation_latent: Sequence[torch.Tensor] | None = None,
        z_vals: torch.Tensor | None = None,
        no_force_stop: bool = False,
        train: bool = False,
        field_dtype: str | None = None,
    ) -> dict[str, Any]:
        """G_pred_latents.forward (stylesdf_model.py:1034-1172). With
        input_is_latent (the default here, the encoder's path) styles =
        [renderer W+ [B, 9, 256], decoder W+ [B, 10, 512]]; otherwise [z], which
        the mapping net takes to w and the decoder maps on. truncation < 1 pulls
        both codes toward truncation_latent = (renderer mean, decoder mean).
        `generator` draws the decoder noise that `noise` does not give and,
        with `train`, the renderer's z-jitter; field_dtype overrides the
        renderer's `field_dtype` for this call."""
        if input_is_latent:
            encoder_latent, decoder_latent = styles[0], (styles[1] if len(styles) > 1 else None)
        else:
            encoder_latent, decoder_latent = self.style(styles[0]), None
        truncate = truncation < 1.0 and truncation_latent is not None
        if truncate:
            encoder_latent = truncation_latent[0] + truncation * (encoder_latent - truncation_latent[0])
        with span("g0.render"):
            render_out = self.renderer(
                camera, encoder_latent, conditions=local_conditions, return_raw_h=return_raw_h,
                z_vals=z_vals, no_force_stop=no_force_stop, train=train, generator=generator, field_dtype=field_dtype,
            )
        render_out["styles"] = encoder_latent
        if renderer_only or not self.full_pipeline:
            render_out["gen_imgs"] = None
            return render_out
        return self._decode_into(
            render_out, encoder_latent, decoder_latent, noise, generator, input_is_latent,
            truncation, truncation_latent[1] if truncate else None,
        )

    def _decode_into(self, render_out, encoder_latent, decoder_latent, noise=None, generator=None,
                     input_is_latent=True, truncation=1.0, truncation_latent=None):
        dec_styles = [encoder_latent] if decoder_latent is None else [decoder_latent]
        # the decoder pyramid runs in the configured compute dtype
        dec_in = render_out["features"].to(getattr(torch, self.cfg.dtype))
        with span("g1.decoder"):
            gen_imgs, out_latent = self.decoder(
                dec_in, dec_styles, input_is_latent=input_is_latent, noise=noise, return_latents=True,
                generator=generator, truncation=truncation, truncation_latent=truncation_latent,
            )
        render_out["gen_imgs"] = gen_imgs.float()
        render_out["decoder_latent"] = out_latent
        return render_out

    def render_cached(
        self,
        styles: Sequence[torch.Tensor],
        cached: dict[str, Any],
        local_conditions: tuple[torch.Tensor, torch.Tensor] | None,
        noise: Sequence | None = None,
        generator: torch.Generator | None = None,
    ) -> dict[str, Any]:
        """Same-view conditioned re-render on the cached backbone
        (`VolumeFeatureRenderer.render_from_backbone`) + the decoder."""
        encoder_latent = styles[0]
        decoder_latent = styles[1] if len(styles) > 1 else None
        with span("g0.render"):
            render_out = self.renderer.render_from_backbone(cached, encoder_latent, local_conditions)
        render_out["styles"] = encoder_latent
        if not self.full_pipeline:
            render_out["gen_imgs"] = None
            return render_out
        return self._decode_into(render_out, encoder_latent, decoder_latent, noise, generator)

    # -- the mesh path's field queries ------------------------------------------

    def render_sdf_grid(self, camera: CameraParams, styles: torch.Tensor) -> torch.Tensor:
        return self.renderer.render_sdf_grid(camera, styles)

    def query_sdf(self, pts: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
        return self.renderer.query_sdf(pts, styles)
