"""NeRF positional encoding — counterpart of `e3dge_tpu/ops/posenc.py`
(reference `PosEncoding`, misc_utils.py:148-184)."""

from __future__ import annotations

import torch


def pos_encoding(x: torch.Tensor, n_freqs: int = 7, logscale: bool = True) -> torch.Tensor:
    """[..., D] -> [..., D * (2*n_freqs + 1)], ordered
    [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]."""
    if logscale:
        freqs = 2.0 ** torch.linspace(0.0, n_freqs - 1.0, n_freqs)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (n_freqs - 1.0), n_freqs)
    outs = [x]
    for f in freqs.tolist():
        outs.append(torch.sin(f * x))
        outs.append(torch.cos(f * x))
    return torch.cat(outs, dim=-1)
