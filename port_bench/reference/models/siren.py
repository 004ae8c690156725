"""FiLM-modulated SIREN MLP — counterpart of `e3dge_tpu/models/siren.py`
(reference `LinearLayer` / `FiLMSiren` / `SirenGenerator`,
volume_renderer.py:42-264).

This module holds the field's parameters under the reference's state_dict
names and is the eager twin of the field kernel: `backbone` / `geo_head` /
`tex_head` compute the field layer by layer (in bf16 with `fast_sin`, as the
JAX package does, when given bf16 inputs), which autograd can differentiate.
The renderer evaluates the twin for every field call that needs a gradient
(training: the stage-1 inversion's render, its SDF queries and eikonal terms)
and launches the kernel for every other one (`film_vectors` + `pack` feed
`ops/siren_field.py`, whose `siren_field_reference` is the kernel's plain
version, for its tests only).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from port_bench.reference.ops.fast_math import fast_sin
from port_bench.reference.ops.siren_field import film_vectors, pack_siren_params


class SirenLinear(nn.Module):
    """std_init * (x W^T + b) + bias_init with the SIREN inits (reference
    LinearLayer, volume_renderer.py:42-80)."""

    def __init__(self, in_dim: int, out_dim: int, bias_init: float = 0.0, std_init: float = 1.0,
                 freq_init: bool = False, is_first: bool = False):
        super().__init__()
        self.bias_init, self.std_init = bias_init, std_init
        self.freq_init, self.is_first = freq_init, is_first
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The SIREN inits, drawn from `generator` (the global RNG when None)."""
        in_dim = self.weight.shape[1]
        if self.is_first:
            w = (torch.rand(self.weight.shape, generator=generator) * 2 - 1) / in_dim
        elif self.freq_init:
            w = (torch.rand(self.weight.shape, generator=generator) * 2 - 1) * math.sqrt(6.0 / in_dim) / 25.0
        else:  # 0.25 * kaiming_normal(a=0.2, fan_in)
            w = torch.randn(self.weight.shape, generator=generator) * 0.25 * math.sqrt(2.0 / 1.04) / math.sqrt(in_dim)
        bound = math.sqrt(1.0 / in_dim)
        self.weight.copy_(w)
        self.bias.copy_((torch.rand(self.bias.shape, generator=generator) * 2 - 1) * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        return self.std_init * (x @ w.t() + b) + self.bias_init


class FiLMSiren(nn.Module):
    """sin(gamma(w) * (x W^T + b) + beta(w)) (volume_renderer.py:84-132);
    gamma head bias_init=30 std_init=15, beta head bias_init=0 std_init=0.25."""

    def __init__(self, in_channel: int, out_channel: int, style_dim: int, is_first: bool = False):
        super().__init__()
        self.is_first = is_first
        self.weight = nn.Parameter(torch.empty(out_channel, in_channel))
        self.bias = nn.Parameter(torch.empty(out_channel))
        self.gamma = SirenLinear(style_dim, out_channel, bias_init=30.0, std_init=15.0)
        self.beta = SirenLinear(style_dim, out_channel, bias_init=0.0, std_init=0.25)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The FiLM-SIREN inits (its own weight and bias; the FiLM heads keep theirs)."""
        in_channel = self.weight.shape[1]
        lim = 1.0 / 3.0 if self.is_first else math.sqrt(6.0 / in_channel) / 25.0
        self.weight.copy_((torch.rand(self.weight.shape, generator=generator) * 2 - 1) * lim)
        bound = math.sqrt(1.0 / in_channel)
        self.bias.copy_((torch.rand(self.bias.shape, generator=generator) * 2 - 1) * bound)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        style = style.to(x.dtype)  # FiLM heads follow the field dtype
        bshape = (style.shape[0],) + (1,) * (x.ndim - 2) + (self.weight.shape[0],)
        gamma = self.gamma(style).reshape(bshape)
        beta = self.beta(style).reshape(bshape)
        arg = gamma * (x @ self.weight.to(x.dtype).t() + self.bias.to(x.dtype)) + beta
        return fast_sin(arg) if arg.dtype == torch.bfloat16 else torch.sin(arg)


class SirenGenerator(nn.Module):
    """D x FiLMSiren backbone + sdf / view-feature / rgb heads
    (volume_renderer.py:136-264). styles [B, D+1, style_dim] (row i for layer i,
    the last row for the view layer) or [B, style_dim] broadcast."""

    def __init__(self, depth: int = 8, width: int = 256, style_dim: int = 256, output_features: bool = True):
        super().__init__()
        self.depth, self.width, self.output_features = depth, width, output_features
        self.pts_linears = nn.ModuleList(
            [FiLMSiren(3 if i == 0 else width, width, style_dim, is_first=(i == 0)) for i in range(depth)]
        )
        self.views_linears = FiLMSiren(width + 3, width, style_dim)  # [h, view dirs]
        self.rgb_linear = SirenLinear(width, 3, freq_init=True)
        self.sigma_linear = SirenLinear(width, 1, freq_init=True)
        self._packs: dict[str, tuple[tuple, dict]] = {}  # precision -> (parameter key, pack)

    def _style_row(self, styles: torch.Tensor, i: int) -> torch.Tensor:
        return styles[:, i] if styles.ndim == 3 else styles

    def backbone(self, pts: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
        """[B, ..., 3] points -> [B, ..., W] backbone hidden."""
        h = pts
        for i, layer in enumerate(self.pts_linears):
            h = layer(h, self._style_row(styles, i))
        return h

    def geo_head(self, h: torch.Tensor) -> torch.Tensor:
        """sdf from the unmodulated backbone hidden."""
        return self.sigma_linear(h)

    def tex_head(self, h: torch.Tensor, views: torch.Tensor, styles: torch.Tensor,
                 conditions: tuple[torch.Tensor, torch.Tensor] | None = None):
        """(rgb, features); conditions = (alpha, beta) local SFT of the texture
        branch, (alpha + 1) * h + beta before the view layer."""
        if conditions is not None:
            alpha, beta = conditions
            h = (alpha.to(h.dtype) + 1.0) * h + beta.to(h.dtype)
        h = torch.cat([h, views.to(h.dtype)], dim=-1)
        view_style = styles[:, -1] if styles.ndim == 3 else styles
        features = self.views_linears(h, view_style)
        return self.rgb_linear(features), features

    def forward(self, pts, views, styles, conditions=None) -> torch.Tensor:
        """concat([rgb 3, sdf 1, features W]) — the reference `raw` layout."""
        h = self.backbone(pts, styles)
        sdf = self.geo_head(h)
        rgb, features = self.tex_head(h, views, styles, conditions)
        out = torch.cat([rgb, sdf], dim=-1)
        return torch.cat([out, features], dim=-1) if self.output_features else out

    # -- the kernel's operands ------------------------------------------------

    def film_vectors(self, styles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """gamma, beta [B, D+1, W] f32 for the field kernel."""
        return film_vectors(dict(self.named_parameters()), styles, self.depth)

    def pack(self, precision: str) -> dict:
        """The field kernel's weight pack in the precision's io dtype, built once
        and kept per precision until a parameter is replaced or edited in place
        (the key holds each parameter's data_ptr and version counter)."""
        params = dict(self.named_parameters())
        key = tuple((p.data_ptr(), p._version) for p in params.values())
        if precision not in self._packs or self._packs[precision][0] != key:
            self._packs[precision] = (key, pack_siren_params(params, self.depth, precision))
        return self._packs[precision][1]
