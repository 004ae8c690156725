"""The StyleSDF generator: mapping + volume renderer (G0) + decoder (G1);
counterpart of `e3dge_tpu/models/generator.py` (reference
stylesdf_model.py:800-1189), W+ serving path.
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
        dev = self.renderer.sigmoid_beta.device
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
    ) -> dict[str, Any]:
        """W+ forward (G_pred_latents.forward, stylesdf_model.py:1034-1172):
        styles = [renderer W+ [B, 9, 256], decoder W+ [B, 10, 512]]."""
        encoder_latent = styles[0]
        decoder_latent = styles[1] if len(styles) > 1 else None
        render_out = self.renderer(camera, encoder_latent, conditions=local_conditions, return_raw_h=return_raw_h)
        render_out["styles"] = encoder_latent
        if renderer_only or not self.full_pipeline:
            render_out["gen_imgs"] = None
            return render_out
        return self._decode_into(render_out, encoder_latent, decoder_latent, noise, generator)

    def _decode_into(self, render_out, encoder_latent, decoder_latent, noise=None, generator=None):
        dec_styles = [encoder_latent] if decoder_latent is None else [decoder_latent]
        # the decoder pyramid runs in the configured compute dtype
        dec_in = render_out["features"].to(getattr(torch, self.cfg.dtype))
        gen_imgs, out_latent = self.decoder(
            dec_in, dec_styles, input_is_latent=True, noise=noise, return_latents=True, generator=generator
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
        render_out = self.renderer.render_from_backbone(cached, encoder_latent, local_conditions)
        render_out["styles"] = encoder_latent
        if not self.full_pipeline:
            render_out["gen_imgs"] = None
            return render_out
        return self._decode_into(render_out, encoder_latent, decoder_latent, noise, generator)
