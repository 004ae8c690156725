"""G1 — the StyleGAN2 upsampler from the 64-res feature map to the full image;
counterpart of `e3dge_tpu/models/decoder.py` (reference
stylesdf_model.py:587-797), standard path only (the JAX package's s2d
phase-space tail is a TPU layout rewrite, `tests/test_s2d.py` pins it to this
path, and the port ignores `s2d_min_res*`), with truncation and style mixing.
Not ported yet: the rgbd input and the HFGI condition hook (dead upstream).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from port_bench.reference.config import DecoderConfig
from port_bench.reference.models.layers import EqualLinear, StyledConv, ToRGB, pixel_norm


class _PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels()
        self.log_size = int(math.log2(cfg.size))
        self.log_in_size = int(math.log2(cfg.in_res))
        self.num_layers = (self.log_size - self.log_in_size) * 2 + 1
        self.n_latent = cfg.n_latent
        # renderer w (style_dim / 2) -> decoder w: [PixelNorm, EqualLinear x5],
        # reference Sequential indices 1..5
        self.style = nn.Sequential(
            _PixelNorm(),
            *[EqualLinear(cfg.style_dim // 2 if i == 0 else cfg.style_dim, cfg.style_dim, lr_mul=cfg.lr_mapping,
                          activation=True) for i in range(5)],
        )
        in_ch = cfg.in_channels
        self.conv1 = StyledConv(in_ch, ch[cfg.in_res], 3, cfg.style_dim)
        self.to_rgb1 = ToRGB(ch[cfg.in_res], cfg.style_dim, upsample=False)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[cfg.in_res]
        for i in range(self.log_in_size + 1, self.log_size + 1):
            out_ch = ch[2**i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, cfg.style_dim, upsample=True))
            self.convs.append(StyledConv(out_ch, out_ch, 3, cfg.style_dim))
            self.to_rgbs.append(ToRGB(out_ch, cfg.style_dim))
            in_ch = out_ch

    def mean_latent(self, renderer_latent: torch.Tensor) -> torch.Tensor:
        """Mean decoder w over a batch of renderer w (stylesdf_model.py:684-687)."""
        return torch.mean(self.style(renderer_latent), dim=0, keepdim=True)

    def _expand_styles(
        self,
        styles: Sequence[torch.Tensor],
        inject_index: int | None = None,
        truncation: float = 1.0,
        truncation_latent: torch.Tensor | None = None,
        input_is_latent: bool = False,
    ) -> torch.Tensor:
        """A list of z / w / W+ -> [B, n_latent, style_dim]
        (`e3dge_tpu/models/decoder.py:82-108`, reference
        styles_and_noise_forward): each z is mapped unless input_is_latent,
        truncated toward truncation_latent when truncation < 1, then one code
        broadcasts to every layer, or two mix: the first for the layers before
        inject_index, the second from there on."""
        if not input_is_latent:
            styles = [self.style(s) for s in styles]
        if truncation < 1:
            if truncation_latent is None:
                raise ValueError("truncation < 1 needs a truncation_latent")
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]
        if len(styles) < 2:
            s = styles[0]
            return s if s.ndim == 3 else s[:, None].expand(-1, self.n_latent, -1)
        if inject_index is None:
            raise ValueError("style mixing needs an inject_index")
        return torch.cat([
            styles[0][:, None].expand(-1, inject_index, -1),
            styles[1][:, None].expand(-1, self.n_latent - inject_index, -1),
        ], dim=1)

    def forward(
        self,
        features: torch.Tensor,                        # [B, C, in_res, in_res]
        styles: Sequence[torch.Tensor] | torch.Tensor,  # list of z / w, or a W+ [B, n_latent, D]
        input_is_latent: bool = False,
        noise: Sequence[torch.Tensor | None] | None = None,
        return_latents: bool = False,
        generator: torch.Generator | None = None,
        inject_index: int | None = None,
        truncation: float = 1.0,
        truncation_latent: torch.Tensor | None = None,
    ):
        """-> (image [B, 3, size, size], W+ latent or None); styles as
        `_expand_styles` takes them."""
        if isinstance(styles, torch.Tensor):
            styles = [styles]
        latent = self._expand_styles(styles, inject_index, truncation, truncation_latent, input_is_latent)
        if noise is None:
            noise = [None] * self.num_layers
        out = self.conv1(features, latent[:, 0], noise=noise[0], generator=generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for conv1, conv2, noise1, noise2, to_rgb in zip(
            self.convs[::2], self.convs[1::2], noise[1::2], noise[2::2], self.to_rgbs
        ):
            out = conv1(out, latent[:, i], noise=noise1, generator=generator)
            out = conv2(out, latent[:, i + 1], noise=noise2, generator=generator)
            skip = to_rgb(out, latent[:, i + 2], skip=skip)
            i += 2
        return skip, (latent if return_latents else None)
