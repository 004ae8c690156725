"""Inputs made from `--seed`: the photos and decoder noise of the serving
cells, the mean latents, the per-iteration generator streams of the training
cells and the folder of real images their D reads. One general generator
reads a cell's traffic parameters (`workloads/<cell>.json`, "traffic"); the
same seed and request index give the same input, so the reference rebuilds
any request after the window.

`smooth_images` is `chip_smoke.py::smooth_images`, evaluated in separable form.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from port_bench.weights import sub_seed

# sub-streams of --seed
PHOTOS, NOISE, MEANS, MODEL, DISC, LPIPS_NET, ARCFACE_NET, REALS, SAMPLE = range(9)


def smooth_images(n: int, size: int, seed: int) -> np.ndarray:
    """n seeded smooth RGB images [n, size, size, 3] uint8: three
    low-frequency sinusoids per channel, each evaluated in its separable form
    sin(u + v) = sin u cos v + cos u sin v."""
    rng = np.random.RandomState(seed % 2**32)
    fx, fy, ph, a = (rng.uniform(lo, hi, (n, 3, 3)) for lo, hi in
                     ((0.5, 3), (0.5, 3), (0, 2 * np.pi), (0.15, 0.3)))
    t = np.arange(size) / size
    u = 2 * np.pi * fx[..., None] * t + ph[..., None]  # [n, 3, 3, size] along x
    v = 2 * np.pi * fy[..., None] * t                  # along y
    out = np.einsum("nckx,ncky->ncyx", a[..., None] * np.sin(u), np.cos(v)) + \
        np.einsum("nckx,ncky->ncyx", a[..., None] * np.cos(u), np.sin(v))
    return np.clip((out.transpose(0, 2, 3, 1) + 1.0) * 127.5, 0, 255).astype(np.uint8)


class Photos:
    """Request i's `batch` photos [batch, 3, res, res] in [-1, 1] on the host:
    distinct for every (i, row), each a pool image (of `pool` made at set-up)
    rolled by a whole number of pixels that grows with i."""

    def __init__(self, seed: int, batch: int, res: int, pool: int):
        self.batch, self.pool = batch, pool
        imgs = smooth_images(pool, res, sub_seed(seed, PHOTOS))
        self.base = imgs.transpose(0, 3, 1, 2).astype(np.float32) / 127.5 - 1.0

    def request(self, i: int) -> torch.Tensor:
        rows = []
        for r in range(self.batch):
            k = i * self.batch + r
            shift = k // self.pool + 1
            rows.append(np.roll(self.base[k % self.pool], (shift, 2 * shift), axis=(1, 2)))
        return torch.from_numpy(np.stack(rows))


def noise_sizes(decoder: dict) -> list[int]:
    """The decoder's per-layer noise resolutions: one map at in_res, two at
    each level up to size (the port's `Runner.make_noise`)."""
    sizes, res = [decoder["in_res"]], decoder["in_res"]
    while res < decoder["size"]:
        res *= 2
        sizes += [res, res]
    return sizes


def request_noise(seed: int, i: int, batch: int, sizes: list[int], device) -> list[torch.Tensor]:
    """Request i's decoder noise maps [batch, 1, r, r], drawn on the device."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, NOISE, i))
    return [torch.randn(batch, 1, s, s, generator=gen, device=device) for s in sizes]


def mean_latents(seed: int, cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(renderer [1, depth+1, style], decoder [1, n_latent, 2 style]) mean
    latents, 0.2 N(0, 1) as `chip_smoke.py::seeded_inputs` draws them."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, MEANS))
    r, d = cfg["renderer"], cfg["decoder"]
    n_latent = (int(math.log2(d["size"])) - int(math.log2(d["in_res"]))) * 2 + 2
    return (0.2 * torch.randn(1, r["depth"] + 1, r["style_dim"], generator=gen, device=device),
            0.2 * torch.randn(1, n_latent, d["style_dim"], generator=gen, device=device))


def stream_generator(device, *keys: int) -> torch.Generator:
    """A generator on device seeded from the key tuple, as the port's trainer
    seeds each iteration's streams (`train.py::stream_generator`)."""
    return torch.Generator(device).manual_seed(sub_seed(*keys))


def write_reals(root: str, n: int, res: int, seed: int) -> str:
    """n seeded smooth PNGs under root (the training cells' D reals)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(smooth_images(n, res, sub_seed(seed, REALS))):
        Image.fromarray(img).save(os.path.join(root, f"{i}.png"))
    return root
