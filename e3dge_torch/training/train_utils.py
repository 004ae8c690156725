"""Training utilities — counterpart of `e3dge_tpu/training/train_utils.py`
(reference `project/utils/training_utils.py`): style-mixing and id-paired z,
the EMA of parameters, fixed decoder noise, and the size-matched warm start.
Randomness comes from explicit `torch.Generator`s."""

from __future__ import annotations

import math
from typing import Mapping

import torch


def mixing_noise(batch: int, latent_dim: int, prob: float, generator: torch.Generator | None = None,
                 device: str | torch.device = "cpu") -> list[torch.Tensor]:
    """[z] or, with probability `prob`, [z1, z2] for style mixing
    (training_utils.py:32)."""
    z1 = torch.randn(batch, latent_dim, device=device, generator=generator)
    z2 = torch.randn(batch, latent_dim, device=device, generator=generator)
    if float(torch.rand((), device=device, generator=generator)) < prob:
        return [z1, z2]
    return [z1]


def make_pair_same_noise(batch: int, latent_dim: int, generator: torch.Generator | None = None,
                         device: str | torch.device = "cpu") -> torch.Tensor:
    """Identity-paired z: entries (0, 1), (2, 3), ... share a latent
    (training_utils.py:21-29)."""
    z = torch.randn(batch, latent_dim, device=device, generator=generator)
    return z[::2].repeat_interleave(2, dim=0)


@torch.no_grad()
def ema_update(ema_params, params, decay: float = 0.5 ** (32 / 10_000)) -> None:
    """accumulate(ema, model, decay), in place: ema = decay * ema + (1 - decay)
    * params, over matching iterables of tensors (training_utils.py:40)."""
    for e, p in zip(ema_params, params):
        e.mul_(decay).add_((1.0 - decay) * p.detach())


def make_noise(size: int, in_res: int, batch: int = 1, generator: torch.Generator | None = None,
               device: str | torch.device = "cpu") -> list[torch.Tensor]:
    """Fixed decoder noise: one [B, 1, r, r] map per layer, r doubling every
    two layers from in_res (stylesdf_model.py:652-656)."""
    log_size, log_in = int(math.log2(size)), int(math.log2(in_res))
    return [
        torch.randn(batch, 1, r, r, device=device, generator=generator)
        for r in (2 ** ((i + 2 * log_in + 1) // 2) for i in range((log_size - log_in) * 2 + 1))
    ]


def warm_start_merge(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor]):
    """Size-matched partial state-dict merge (reference --ckpt surgery,
    train_setup.py:144-177): every entry of `dst` whose key `src` has with the
    same shape is taken from `src`; missing or mismatched ones keep their
    fresh values, and keys only `src` has are ignored. Returns (merged,
    loaded_count, skipped_count)."""
    merged, loaded, skipped = {}, 0, 0
    for k, v in dst.items():
        s = src.get(k)
        if s is not None and tuple(s.shape) == tuple(v.shape):
            merged[k] = s.to(v.dtype).clone()
            loaded += 1
        else:
            merged[k] = v
            skipped += k in src
    return merged, loaded, skipped
