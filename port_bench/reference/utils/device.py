"""Device resolution for the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> "cuda". A CUDA device without a card raises; the port never
    carries on on the CPU unless asked to (device="cpu")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "e3dge_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
