"""Semantic editing along latent boundaries and 3D toonification; counterpart
of `e3dge_tpu/utils/editing.py` (reference trainer.py:2390-2496,
demo_toonify.sh).

Editing adds InterfaceGAN-style attribute directions, one per latent space
('renderer' W 256-d and 'decoder' W 512-d), to the predicted W+ codes with
user scales. Toonify swaps a domain-transferred generator's weights into the
same modules (`toonify_params` in the JAX package), which here is a
`load_state_dict` of the generator.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

ATTRS = ("Bangs", "Smiling", "No_Beard", "Young", "Eyeglasses")
SPACES = ("renderer", "decoder")


def load_boundaries(boundary_dir: str | Path, attrs: Sequence[str] = ATTRS[:4]) -> dict:
    """{attr: {space: [1, D] direction}} from `{space}_{attr}/boundary.npy`
    (reference _load_editing_directions, trainer.py:2390-2411)."""
    root = Path(boundary_dir)
    return {attr: {space: np.load(root / f"{space}_{attr}" / "boundary.npy") for space in SPACES} for attr in attrs}


def edit_code(
    pred_latents: Sequence[torch.Tensor | None],
    boundaries: Mapping[str, Mapping[str, np.ndarray]],
    scales: Mapping[str, float] | Sequence[float],
) -> list[torch.Tensor | None]:
    """Offset both W+ codes along the attribute boundaries (trainer.py:2415-2456).

    scales: {attr: scale} or a list aligned with ATTRS (missing ones 0). A
    direction [1, D] broadcasts over the W+ rows of a [B, rows, D] code."""
    if not isinstance(scales, Mapping):
        scales = dict(zip(ATTRS, list(scales) + [0.0] * (len(ATTRS) - len(scales))))
    edited = []
    for idx, space in enumerate(SPACES):
        code = pred_latents[idx]
        if code is not None:
            for attr, s in scales.items():
                if not s or attr not in boundaries:
                    continue
                b = torch.as_tensor(np.asarray(boundaries[attr][space]), dtype=code.dtype, device=code.device)
                code = code + s * (b[:, None] if code.ndim == 3 else b)
        edited.append(code)
    return edited


def toonify(generator: nn.Module, toon_state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a domain-transferred generator's state dict (the port's `Generator`
    keys, the reference's) into `generator`, strictly. The copy is in place, so
    every parameter's version counter moves and the field kernel's cached
    weight pack (`SirenGenerator.pack`) is rebuilt at the next launch."""
    generator.load_state_dict(toon_state_dict, strict=True)
