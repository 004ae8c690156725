"""Alternative E0 encoders; counterpart of `e3dge_tpu/models/encoders/variants.py`
(the reference's alt-configs), under the reference's state_dict names:

  * HybridBackboneEncoder: ReStyle-style, every style vector read from the
    final 16x16 map of an IR backbone by its own GradualStyleBlock; heads of
    n_styles_pigan x style_dim and n_styles_decoder x decoder_style_dim
    (restyle_psp_encoders.py:58-89);
  * BackboneEncoderRenderer: the W-space ReStyle encoder, one vector per
    branch repeated over its rows (restyle_psp_encoders.py:138-187);
  * Encoder4EditingHybrid: e4e's progressive-delta encoder, one base style
    and per-row deltas gated by a progressive stage (e4e_encoders.py:378-497,
    ProgressiveStage :14-33).

Every one reads an IR(-SE) trunk, `ir_trunk`, whose BatchNorm is
`fpn.BatchNorm2d`: flax's semantics, and in train mode inside a
data-parallel step (`parallel.mesh.sharded`) the global batch's statistics,
as the port's E0 takes them. None has an FPN pyramid for the local branch.
"""

from __future__ import annotations

import torch
from torch import nn

from e3dge_torch.config import EncoderConfig
from e3dge_torch.models.encoders.fpn import BatchNorm2d, BottleneckIR, Conv2d, GradualStyleBlock, PReLU, get_blocks
from e3dge_torch.ops import interpolate_bilinear


def ir_trunk(cfg: EncoderConfig) -> tuple[nn.Sequential, nn.Sequential]:
    """(input_layer, body): the IR(-SE) stem and bottlenecks (`_IRBackbone`,
    `variants.py:28`), the reference's `input_layer.*` / `body.*` names;
    the body ends at 512 channels at input_res / 16."""
    input_layer = nn.Sequential(Conv2d(cfg.input_nc, 64, 3, padding=1, bias=False), BatchNorm2d(64), PReLU(64))
    body = nn.Sequential(*[BottleneckIR(s.in_channel, s.depth, s.stride, se=(cfg.mode == "ir_se"))
                           for s in get_blocks(cfg.num_layers)])
    return input_layer, body


def _no_featmap(name: str) -> ValueError:
    return ValueError(f"{name} has no FPN feature maps; return_featmap requires HybridGradualStyleEncoder_V2 "
                      "(the local/HFGI branch consumes p64/p32 pyramid maps this backbone cannot provide)")


class HybridBackboneEncoder(nn.Module):
    """All styles from the trunk's final map (`variants.py:48`,
    restyle_psp_encoders.py:58-89; the reference hardcodes mode "ir", so pass
    cfg.mode="ir" to match it). `return_featmap` raises: this backbone has
    no pyramid for the local branch."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = c = cfg
        self.input_layer, self.body = ir_trunk(c)
        spatial = c.input_res // 16
        self.thumb_styles = nn.ModuleList([GradualStyleBlock(512, c.style_dim, spatial)
                                           for _ in range(c.n_styles_pigan)])
        self.styles = nn.ModuleList([GradualStyleBlock(512, c.decoder_style_dim, spatial)
                                     for _ in range(c.n_styles_decoder)])

    def forward(self, x: torch.Tensor, return_featmap: bool = False) -> list[torch.Tensor]:
        if return_featmap:
            raise _no_featmap("HybridBackboneEncoder")
        h = self.body(self.input_layer(x))
        return [torch.stack([b(h) for b in self.thumb_styles], dim=1), torch.stack([b(h) for b in self.styles], dim=1)]


class BackboneEncoderRenderer(nn.Module):
    """One renderer and one decoder style vector from the trunk's final map
    by `styles.0` / `styles.1`, each repeated over its W+ rows (`variants.py:
    87`, restyle_psp_encoders.py:138-187)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = c = cfg
        self.input_layer, self.body = ir_trunk(c)
        s16 = c.input_res // 16
        self.styles = nn.ModuleList([GradualStyleBlock(512, c.style_dim, s16),
                                     GradualStyleBlock(512, c.decoder_style_dim, s16)])

    def forward(self, x: torch.Tensor, return_featmap: bool = False) -> list[torch.Tensor]:
        if return_featmap:
            raise _no_featmap("BackboneEncoderRenderer")
        c = self.cfg
        h = self.body(self.input_layer(x))
        w_thumb, w_dec = (b(h) for b in self.styles)
        return [w_thumb[:, None].expand(-1, c.n_styles_pigan, -1), w_dec[:, None].expand(-1, c.n_styles_decoder, -1)]


# e4e's feature plans: the map each row's block reads, by its scale (16: the
# trunk's c3, 32: p2 = c3 upsampled + latlayer1(c2), 64: p1 = p2 upsampled +
# latlayer2(c1)); pigan rows 6.. read p2 (pigan_coarse_indx 6,
# e4e_encoders.py:487-492), stylegan rows 3.. p2 and 7.. p1 (:498-508)
E4E_PIGAN_PLAN = (16,) * 6 + (32,) * 3
E4E_STYLEGAN_PLAN = (16,) * 3 + (32,) * 4 + (64,) * 3
E4E_INFERENCE_STAGE = 18  # ProgressiveStage.Inference: every delta on


class Encoder4EditingHybrid(nn.Module):
    """e4e's progressive-delta encoder as the reference factory reaches it
    (Encoder4EditingHybridBaseline, e4e_encoders.py:378-497; `variants.py:
    123`): row 0 of each branch is its base style, row i > 0 adds its own
    delta while i <= the progressive stage. The stage is this module's
    `stage` unless a call passes one (an int or a 0-d tensor, so that a
    training loop anneals it by `e4e_progressive_stage`); the gate is
    arithmetic, not a branch, so rows past the stage equal the base row
    exactly. The trunk taps c1 (body 6, 128 ch), c2 (20, 256) and c3 (23,
    512); latlayer3 of the reference checkpoints is never read (not built)."""

    def __init__(self, cfg: EncoderConfig, stage: int = E4E_INFERENCE_STAGE):
        super().__init__()
        self.cfg = c = cfg
        self.stage = stage
        self.input_layer, self.body = ir_trunk(c)
        self.latlayer1 = Conv2d(256, 512, 1)
        self.latlayer2 = Conv2d(128, 512, 1)
        spatial = {16: c.input_res // 16, 32: c.input_res // 8, 64: c.input_res // 4}
        self.styles_pigan = nn.ModuleList([GradualStyleBlock(512, c.style_dim, spatial[s])
                                           for s in E4E_PIGAN_PLAN[: c.n_styles_pigan]])
        self.styles = nn.ModuleList([GradualStyleBlock(512, c.decoder_style_dim, spatial[s])
                                     for s in E4E_STYLEGAN_PLAN[: c.n_styles_decoder]])

    def forward(self, x: torch.Tensor, return_featmap: bool = False,
                stage: int | torch.Tensor | None = None) -> list[torch.Tensor]:
        if return_featmap:
            raise _no_featmap("Encoder4EditingHybrid")
        h = self.input_layer(x)
        taps = {}
        for i, block in enumerate(self.body):
            h = block(h)
            if i in (6, 20, 23):
                taps[i] = h

        def upsample_add(a, b):
            return interpolate_bilinear(a, b.shape[2:], align_corners=True) + b

        feats = {16: taps[23]}
        feats[32] = upsample_add(feats[16], self.latlayer1(taps[20]))
        feats[64] = upsample_add(feats[32], self.latlayer2(taps[6]))
        stage = torch.as_tensor(self.stage if stage is None else stage, device=x.device)

        def progressive(blocks, plan):
            base = blocks[0](feats[plan[0]])
            rows = [base]
            for i in range(1, len(blocks)):
                rows.append(base + (stage >= i).to(base.dtype) * blocks[i](feats[plan[i]]))
            return torch.stack(rows, dim=1)

        return [progressive(self.styles_pigan, E4E_PIGAN_PLAN), progressive(self.styles, E4E_STYLEGAN_PLAN)]


def e4e_progressive_stage(step: int | torch.Tensor, every: int, max_stage: int = E4E_INFERENCE_STAGE):
    """The progressive-stage schedule (`variants.py:210`, e4e_encoders.py:
    14-33): one more delta every `every` steps, capped at Inference; an int
    for an int step, else a tensor, either usable as
    `Encoder4EditingHybrid`'s per-call stage."""
    if isinstance(step, torch.Tensor):
        return torch.clamp(torch.div(step, every, rounding_mode="floor"), max=max_stage)
    return min(step // every, max_stage)
