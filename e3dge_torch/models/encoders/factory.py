"""The encoder factory (reference `set_encoder`, encoders/__init__.py:6-40);
counterpart of `e3dge_tpu/models/encoders/factory.py`, under the reference's
state_dict names.

The released encoder is `HybridGradualStyleEncoder_V2` (`fpn.py`). The legacy
variants are kept for config parity: the volume-D encoders
(`VolumeRenderDiscriminatorEncoder`, `VolumeStyleEncoder`) reuse the volume
D's CoordConv trunk, and the D-backbone encoders (`StyleGANEncoder`,
`DEncoder`, `FullEncoder`) the full-resolution D's StyleGAN2 trunk, both from
`models/discriminator.py`. Each returns [renderer W+ offsets or None, decoder
W+ offsets or None], or with `return_featmap` the dict of the released
encoder with no feature maps.
"""

from __future__ import annotations

import torch
from torch import nn

from e3dge_torch.config import EncoderConfig
from e3dge_torch.models.discriminator import VolumeDiscConv, sg2_trunk, volume_d_trunk
from e3dge_torch.models.encoders.fpn import HybridGradualStyleEncoderV2
from e3dge_torch.models.encoders.variants import BackboneEncoderRenderer, Encoder4EditingHybrid, HybridBackboneEncoder
from e3dge_torch.models.layers import ConvLayer, EqualLinear
from e3dge_torch.ops import adaptive_avg_pool


def _out(thumb, dec, return_featmap: bool):
    if return_featmap:
        return {"pred_latents": [thumb, dec], "feat_maps": None, "p32": None}
    return [thumb, dec]


class VolumeRenderDiscriminatorEncoder(nn.Module):
    """The volume D as a thumb encoder (reference stylesdf_model.py:1422-1459;
    `factory.py:26`): its trunk and its gan/viewpoint `final_conv` (whose
    viewpoint half answers `pred_viewpoints=True`), plus a kernel-2
    `wplus_latents_pred_conv` head on the 2x2 features for the [B,
    n_styles_pigan, style_dim] renderer offsets; no decoder offsets."""

    def __init__(self, cfg: EncoderConfig, init_size: int = 64):
        super().__init__()
        self.cfg = cfg
        self.convs, in_ch = volume_d_trunk(init_size)
        self.final_conv = VolumeDiscConv(in_ch, 3, 2)
        self.wplus_latents_pred_conv = VolumeDiscConv(in_ch, cfg.n_styles_pigan * cfg.style_dim, 2)

    def forward(self, x: torch.Tensor, return_featmap: bool = False, pred_viewpoints: bool = False):
        out = self.convs(x)
        if pred_viewpoints:
            return self.final_conv(out)[:, 1:].reshape(-1, 2)
        thumb = self.wplus_latents_pred_conv(out).reshape(x.shape[0], self.cfg.n_styles_pigan, self.cfg.style_dim)
        return _out(thumb, None, return_featmap)


class VolumeStyleEncoder(nn.Module):
    """The legacy joint encoder (reference stylesdf_model.py:1461-1510;
    `factory.py:62`): the volume D's trunk over the thumb, one `final_conv`
    predicting both the renderer (n_styles_pigan x style_dim) and the
    decoder (n_styles_decoder x decoder_style_dim) offsets."""

    def __init__(self, cfg: EncoderConfig, init_size: int = 64):
        super().__init__()
        self.cfg = c = cfg
        self.convs, in_ch = volume_d_trunk(init_size)
        self.final_conv = VolumeDiscConv(in_ch, c.n_styles_pigan * c.style_dim
                                         + c.n_styles_decoder * c.decoder_style_dim, 2)

    def forward(self, x: torch.Tensor, return_featmap: bool = False):
        c = self.cfg
        out = self.final_conv(self.convs(x)).reshape(x.shape[0], -1)
        split = c.n_styles_pigan * c.style_dim
        thumb = out[:, :split].reshape(-1, c.n_styles_pigan, c.style_dim)
        dec = out[:, split:].reshape(-1, c.n_styles_decoder, c.decoder_style_dim)
        return _out(thumb, dec, return_featmap)


def minibatch_stddev(out: torch.Tensor, group_size: int) -> torch.Tensor:
    """out with the StyleGAN2 minibatch-stddev channel appended
    (stylesdf_model.py:1655-1668): groups of min(B, group_size), or of 3, 2
    or 1 when that does not divide B (`factory.py:139-142`)."""
    b, ch, h, w = out.shape
    group = min(b, group_size)
    if b % group != 0:
        group = 3 if b % 3 == 0 else (2 if b % 2 == 0 else 1)
    y = out.reshape(group, -1, 1, ch, h, w)
    stddev = torch.sqrt(y.var(dim=0, correction=0) + 1e-8).mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
    return torch.cat([out, stddev.repeat(group, 1, h, w)], dim=1)


class StyleGANEncoder(nn.Module):
    """The legacy D-backbone decoder-latent encoder (reference
    stylesdf_model.py:1620-1679; `factory.py:118`): the full-resolution D's
    trunk, minibatch stddev, a final conv and a 2-layer EqualLinear head ->
    [B, 2 n_styles_decoder, decoder_style_dim] decoder offsets; no renderer
    offsets."""

    def __init__(self, cfg: EncoderConfig, input_size: int = 256, channel_multiplier: int = 2,
                 stddev_group: int = 4):
        super().__init__()
        self.cfg, self.stddev_group = cfg, stddev_group
        self.convs, in_ch = sg2_trunk(input_size, channel_multiplier)
        self.final_conv = ConvLayer(in_ch + 1, 512, 3)
        self.final_linear = nn.Sequential(EqualLinear(512 * 4 * 4, 512, activation=True),
                                          EqualLinear(512, cfg.decoder_style_dim * cfg.n_styles_decoder * 2))

    def forward(self, x: torch.Tensor, return_featmap: bool = False):
        out = self.final_conv(minibatch_stddev(self.convs(x), self.stddev_group))
        dec = self.final_linear(out.reshape(x.shape[0], -1)).reshape(x.shape[0], -1, self.cfg.decoder_style_dim)
        return _out(None, dec, return_featmap)


class DEncoder(nn.Module):
    """The legacy D-backbone joint encoder (reference stylesdf_model.py:
    1682-1739; `factory.py:158`): the full-resolution D's trunk and two
    downsampling 3x3 conv heads on its 4x4 map, averaged over space ->
    renderer (n_styles_pigan x style_dim) and decoder (n_styles_decoder x
    decoder_style_dim) offsets; the working intent of the reference's
    declared heads (its forward names an undefined one)."""

    def __init__(self, cfg: EncoderConfig, input_size: int = 256, channel_multiplier: int = 2):
        super().__init__()
        self.cfg = c = cfg
        self.convs, in_ch = sg2_trunk(input_size, channel_multiplier)
        self.renderer_latents_conv = ConvLayer(in_ch, c.style_dim * c.n_styles_pigan, 3, downsample=True)
        self.stylegan_latents_conv = ConvLayer(in_ch, c.decoder_style_dim * c.n_styles_decoder, 3, downsample=True)

    def forward(self, x: torch.Tensor, return_featmap: bool = False):
        c = self.cfg
        out = self.convs(x)
        rend = self.renderer_latents_conv(out).mean(dim=(2, 3)).reshape(-1, c.n_styles_pigan, c.style_dim)
        dec = self.stylegan_latents_conv(out).mean(dim=(2, 3)).reshape(-1, c.n_styles_decoder, c.decoder_style_dim)
        return _out(rend, dec, return_featmap)


class FullEncoder(nn.Module):
    """The legacy composition (reference stylesdf_model.py:1742-1762;
    `factory.py:187`): renderer offsets from a `VolumeRenderDiscriminatorEncoder`
    over the 64^2 thumb (the images average-pooled to 64^2 when no thumb is
    given), decoder offsets from a `StyleGANEncoder` over the images."""

    def __init__(self, cfg: EncoderConfig, input_size: int = 256, channel_multiplier: int = 2):
        super().__init__()
        self.renderer_encoder = VolumeRenderDiscriminatorEncoder(cfg)
        self.stylegan_encoder = StyleGANEncoder(cfg, input_size=input_size, channel_multiplier=channel_multiplier)

    def forward(self, imgs: torch.Tensor, thumb_imgs: torch.Tensor | None = None, return_featmap: bool = False):
        if thumb_imgs is None:
            thumb_imgs = adaptive_avg_pool(imgs, 64)
        rend, _ = self.renderer_encoder(thumb_imgs)
        _, dec = self.stylegan_encoder(imgs)
        return _out(rend, dec, return_featmap)


ENCODERS = {
    "HybridGradualStyleEncoder_V2": HybridGradualStyleEncoderV2,
    "VolumeRenderDiscriminatorEncoder": VolumeRenderDiscriminatorEncoder,
    "HybridBackboneEncoder": HybridBackboneEncoder,
    "BackboneEncoderRenderer": BackboneEncoderRenderer,
    "Encoder4Editing": Encoder4EditingHybrid,
    # the reference factory's name (encoders/__init__.py:25-28), as options_compat passes it
    "Encoder4EditingHybridBaseline": Encoder4EditingHybrid,
    "VolumeStyleEncoder": VolumeStyleEncoder,
    "StyleGANEncoder": StyleGANEncoder,
    "DEncoder": DEncoder,
    "FullEncoder": FullEncoder,
}


def set_encoder(encoder_type: str, cfg: EncoderConfig, **kwargs) -> nn.Module:
    """The encoder named encoder_type (`ENCODERS`) for cfg; kwargs go to its
    constructor (init_size, input_size, channel_multiplier, stage)."""
    if encoder_type not in ENCODERS:
        raise KeyError(f"unknown encoder_type {encoder_type}; have {list(ENCODERS)}")
    return ENCODERS[encoder_type](cfg, **kwargs)
