"""Training utilities — counterpart of `e3dge_tpu/training/train_utils.py`
(reference `project/utils/training_utils.py`): style-mixing and id-paired z,
the EMA of parameters, fixed decoder noise, and the size-matched warm start.
Randomness comes from explicit `torch.Generator`s."""

from __future__ import annotations

import math

import torch


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

