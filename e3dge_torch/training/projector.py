"""Optimisation inversion and PTI generator tuning; counterpart of
`e3dge_tpu/training/projector.py` (reference `Projectors`,
`project/trainers/Inversions/projectors.py:29-734`).

`project` optimises W+ offsets from the mean latents (or, with `wspace`, one
row per net broadcast over the W+ rows, :86-101) under a latent noise that
decays linearly from 0.03 on both nets' codes (:107-116). The objective is L2
plus LPIPS on the render pooled to at most 256², plus 0.1x the same on the
thumb ("no loss on thumb leads to shape collapse", :209-222). The optimiser
is optax's Adam (`steps.Adam`) at `lr`, stepped down by 0.75 every 100 steps
(StepLR, :186-192). `pti` then tunes the generator's parameters around the
inverted code with Adam at 5e-5.

Both render through the eager twin of the field: the kernel refuses
grad-requiring operands (`ops/siren_field.py`). The decoder noise is fixed
over the steps (JAX draws it from the same key at every step); the latent
noise comes from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable

import torch

from e3dge_torch.models.e3dge import E3DGE, LatentMeans
from e3dge_torch.ops import adaptive_avg_pool, upsample_nearest
from e3dge_torch.render.camera import CameraParams
from e3dge_torch.training import losses as L
from e3dge_torch.training.steps import Adam


def _latent_noise_scale(step, total_steps, initial=0.03):
    """initial * (num_steps - step) / num_steps (projectors.py:107-116)."""
    return initial * (total_steps - step) / total_steps


def _frozen(model: E3DGE, trainable: torch.nn.Module | None = None):
    """Every parameter's requires_grad, then all off but `trainable`'s."""
    was = {p: p.requires_grad for p in model.parameters()}
    model.requires_grad_(False)
    if trainable is not None:
        trainable.requires_grad_(True)
    return was


def project(
    model: E3DGE,
    mean_latents: LatentMeans,
    images: torch.Tensor,
    camera: CameraParams,
    generator: torch.Generator,
    steps: int = 300,
    lr: float = 5e-3,
    l2_lambda: float = 1.0,
    lpips_lambda: float = 1.0,
    lpips_fn: Callable | None = None,
    wspace: bool = False,
    thumb_lambda: float = 0.1,
    noise=None,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """W(+) offsets for a batch of images at `camera` -> (latents [renderer,
    decoder], the loss of each step [steps]). `generator` draws the latent
    noise (on the model's device); `noise` is the decoder noise of every
    step (None: the decoder draws it)."""
    b, dev = images.shape[0], model.device
    n_rows = (mean_latents.renderer.shape[1], mean_latents.decoder.shape[1])
    if wspace:
        shapes = [(b, mean_latents.renderer.shape[-1]), (b, mean_latents.decoder.shape[-1])]
    else:
        shapes = [(b,) + tuple(mean_latents.renderer.shape[1:]), (b,) + tuple(mean_latents.decoder.shape[1:])]
    offsets = [torch.zeros(s, device=dev, requires_grad=True) for s in shapes]
    opt = Adam(offsets, lr=lr)
    res = min(model.cfg.decoder.size, images.shape[-1], 256)
    target = adaptive_avg_pool(images.to(dev), res)

    def expand(off, rows):
        return off[:, None].expand(-1, rows, -1) if wspace else off

    def rec(p):
        loss = l2_lambda * L.mse(p, target)
        if lpips_fn is not None:
            loss = loss + lpips_lambda * lpips_fn(p, target)
        return loss

    losses = []
    was = _frozen(model)
    try:
        for t in range(steps):
            ns = _latent_noise_scale(t, steps)
            latents = [
                mean_latents.renderer + expand(offsets[0] + ns * torch.randn(shapes[0], device=dev,
                                                                             generator=generator), n_rows[0]),
                mean_latents.decoder + expand(offsets[1] + ns * torch.randn(shapes[1], device=dev,
                                                                            generator=generator), n_rows[1]),
            ]
            out = model.latent2image(latents, camera, noise=noise, train=True)
            pred = adaptive_avg_pool(out["gen_imgs"], res)
            thumb = out["gen_thumb_imgs"]
            thumb = upsample_nearest(thumb, res) if thumb.shape[-1] < res else adaptive_avg_pool(thumb, res)
            loss = rec(pred) + thumb_lambda * rec(thumb)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.param_groups[0]["lr"] = lr * 0.75 ** (t // 100)
            opt.step()
            losses.append(loss.detach())
    finally:
        for p, r in was.items():
            p.requires_grad_(r)
    with torch.no_grad():
        latents = [mean_latents.renderer + expand(offsets[0], n_rows[0]),
                   mean_latents.decoder + expand(offsets[1], n_rows[1])]
    return [x.detach() for x in latents], torch.stack(losses)


def pti(
    model: E3DGE,
    latents,
    images: torch.Tensor,
    camera: CameraParams,
    steps: int = 100,
    lr: float = 5e-5,
    lpips_fn: Callable | None = None,
    noise=None,
) -> torch.Tensor:
    """Pivotal tuning: Adam on `model.generator`'s parameters only, in place,
    around the inverted `latents` (projectors.py PTI branch): L2 plus LPIPS
    on the render pooled to the smaller of the image and decoder sizes.
    Returns the last step's loss."""
    res = min(model.cfg.decoder.size, images.shape[-1])
    target = adaptive_avg_pool(images.to(model.device), res)
    latents = [x.detach() for x in latents]
    params = list(model.generator.parameters())
    opt = Adam(params, lr=lr)
    loss = torch.zeros(())
    was = _frozen(model, model.generator)
    try:
        for _ in range(steps):
            out = model.latent2image(latents, camera, noise=noise, train=True)
            pred = adaptive_avg_pool(out["gen_imgs"], res)
            loss = L.mse(pred, target)
            if lpips_fn is not None:
                loss = loss + lpips_fn(pred, target)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    finally:
        for p, r in was.items():
            p.requires_grad_(r)
    return loss.detach()
