"""The stage-1 training step of the port in plain PyTorch (reference
AERunner.synthetic_forward, trainer.py:654-736, with the shape loss of
builder.py:43-117): E0 trained in train mode on frozen-GAN samples through
the frozen StyleSDF, with 2D reconstruction, latent and 3D shape
supervision. A frozen copy of the stage-1 parts of
`e3dge_torch/training/steps.py`, `training/losses.py` (`eikonal_loss`,
`calc_shape_rec_loss`), `models/volume_renderer.py::eikonal_term` and
`models/e3dge.py::image2image_global`, built on the reference's own modules
(`models.e3dge`, `training.steps`, `training.losses`); it imports no JAX and
nothing of the port. It runs in float32 with TF32 off, as the rest of the
reference.

Where this step is not the released trainer's maths, it is the JAX
package's stage-1 step (`steps.py:278-349`), which the port follows:

- the sample and the inversion render with one set of decoder noise maps
  (JAX draws both from the step's one "noise" rng);
- the inversion renders at the sample's cameras; the pose head is not run;
- the 2D terms compare images average-pooled to at most 256^2;
- the masks (the uniform points' valid mask, the foreground mask at the
  surface points, the near-surface valid mask) are applied before the
  SmoothL1 terms, and the eikonal term is taken at the near-surface points
  alone, without the minimal-surface term;
- Adam runs in optax's order of f32 operations (`training.steps.Adam`), not
  torch.optim.Adam's, which folds the bias corrections into the step size;
- one rank: in the released four-process job each rank takes its own
  BatchNorm moments and the gradients are averaged over the ranks; here one
  process takes one rank's batch, with no exchange.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable

import torch

from port_bench.reference.ops import adaptive_avg_pool
from port_bench.reference.parallel import mesh
from port_bench.reference.training import losses as L
from port_bench.reference.training.steps import (  # noqa: F401  (the driver builds the state from here)
    TrainState,
    create_train_state,
    decoder_noise,
    optimizer_step,
    pose_curriculum,
)

STAGE1_TRAINABLE = ("encoder",)

# stage-1 loss weights (reference scripts/train/ffhq/stage1.sh via
# scripts/train.py:52-54), under the step's lambda names
STAGE1_LAMBDAS = dict(
    l2_lambda=1.0, lpips_lambda=0.8, id_lambda=0.1, latent_gt_lambda=1.0, shape_surface_lambda=1.0,
    shape_normal_lambda=1.0, shape_uniform_lambda=0.2, eikonal_lambda=0.1,
)


def eikonal_term(renderer, pts: torch.Tensor, styles: torch.Tensor, create_graph: bool = True) -> torch.Tensor:
    """d(sdf)/d(pts) per point [..., 3] (reference get_eikonal_term): each
    point's SDF depends on its own coordinates only, so the gradient of the
    summed SDF is the per-point one. With create_graph the result stays in
    the graph, so the loss differentiates it again (with respect to E0)."""
    with torch.enable_grad():
        p = pts.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(renderer.query_sdf(p, styles).sum(), p, create_graph=create_graph)
    return grad


def eikonal_loss(eikonal: torch.Tensor) -> torch.Tensor:
    """mean (||grad sdf|| - 1)^2 (gan_loss.py:69-80, without the minimal-surface term)."""
    return torch.mean((torch.linalg.norm(eikonal, dim=-1) - 1.0) ** 2)


def calc_shape_rec_loss(pred_shape: dict[str, Any], gt_shape: dict[str, Any],
                        lambdas: dict[str, float]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """3D shape supervision against the frozen GAN's geometry
    (builder.py:43-117): SmoothL1 of the uniform-point SDF, of the surface
    SDF to 0 and of the surface normals, and the eikonal term, each times
    its lambda. The masks are applied by the caller."""
    out = {}
    loss = torch.zeros((), device=pred_shape["uniform_points_sdf"].device)
    if lambdas.get("shape_uniform_lambda", 0.0) > 0:
        out["sdf_rec_loss"] = lambdas["shape_uniform_lambda"] * L.smooth_l1(
            pred_shape["uniform_points_sdf"].squeeze(), gt_shape["uniform_points_sdf"].squeeze())
        loss = loss + out["sdf_rec_loss"]
    if lambdas.get("shape_surface_lambda", 0.0) > 0:
        surf = pred_shape["surface_sdf"]
        out["surf_rec_loss"] = lambdas["shape_surface_lambda"] * L.smooth_l1(surf, torch.zeros_like(surf))
        loss = loss + out["surf_rec_loss"]
    if lambdas.get("shape_normal_lambda", 0.0) > 0 and "surface_eikonal_term" in pred_shape:
        out["surface_norm_rec_loss"] = lambdas["shape_normal_lambda"] * L.smooth_l1(
            pred_shape["surface_eikonal_term"].squeeze(), gt_shape["surface_eikonal_term"].squeeze())
        loss = loss + out["surface_norm_rec_loss"]
    if lambdas.get("eikonal_lambda", 0.0) > 0 and "eikonal_term" in pred_shape:
        out["eikonal_term"] = lambdas["eikonal_lambda"] * eikonal_loss(pred_shape["eikonal_term"])
        loss = loss + out["eikonal_term"]
    out["loss_shape"] = loss
    return loss, out


def image2image_global(model, images: torch.Tensor, mean_latents, camera, noise=None,
                       train: bool = False) -> dict[str, Any]:
    """The global inversion (E0 -> G0 -> G1, no E1) at `camera`, composed
    from the model's `image2latents` and `latent2image`; train: E0's
    BatchNorm on batch statistics and the grad kept (see `E3DGE._mode`)."""
    with model._mode(train):
        encoder_out = model.image2latents(images, mean_latents, train=train)
        out = model.latent2image(encoder_out["pred_latents"], camera, noise=noise, train=train)
    out["cam_settings"] = camera
    out["pred_latents"] = encoder_out["pred_latents"]
    return out


def stage1_loss(model, batch: dict[str, Any], mean_latents, lambdas: dict[str, float],
                lpips_fn: Callable | None = None, id_fn: Callable | None = None,
                noise=None) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, Any]]:
    """The stage-1 loss on a frozen-GAN batch: the global inversion in train
    mode at the batch's cameras; MSE (+ LPIPS + ID) of the images pooled to
    at most 256^2 and MSE of the thumbs; the latent loss of the renderer W+
    rows against the sampled w; the predicted SDF at the uniform and surface
    points; and the SDF gradients at the near-surface points, kept in the
    graph, against the frozen w's. Returns (loss, metrics, the inversion's
    output)."""
    out = image2image_global(model, batch["images"], mean_latents, batch["cam_settings"], noise=noise, train=True)
    res = min(out["gen_imgs"].shape[-1], 256)
    loss_2d, metrics = L.calc_2d_rec_loss(adaptive_avg_pool(out["gen_imgs"], res),
                                          adaptive_avg_pool(batch["images"], res), lambdas, lpips_fn, id_fn)
    thumb_loss = lambdas.get("l2_lambda", 1.0) * L.mse(out["gen_thumb_imgs"], batch["thumb_images"])
    loss = loss_2d + thumb_loss

    pred_w = out["pred_latents"][0]
    if lambdas.get("latent_gt_lambda", 0.0) > 0:
        latent_loss = L.mse(pred_w, batch["latent_gt"][:, None].expand_as(pred_w))
        loss = loss + lambdas["latent_gt_lambda"] * latent_loss
        metrics["latent_gt"] = latent_loss

    pred_shape = {
        "uniform_points_sdf": model.query_sdf(batch["uniform_pts"], pred_w, train=True) * batch["uniform_valid"],
        "surface_sdf": model.query_sdf(batch["xyz"], pred_w, train=True) * batch["mask"][..., 0, :],
    }
    gt_shape = {"uniform_points_sdf": batch["uniform_sdf"] * batch["uniform_valid"]}
    if lambdas.get("shape_normal_lambda", 0.0) > 0 or lambdas.get("eikonal_lambda", 0.0) > 0:
        renderer = model.generator.renderer
        pred_eik = eikonal_term(renderer, batch["near_pts"], pred_w, create_graph=True)
        gt_eik = eikonal_term(renderer, batch["near_pts"], batch["latent_gt"], create_graph=False)
        pred_shape["surface_eikonal_term"] = pred_eik * batch["near_valid"]
        pred_shape["eikonal_term"] = pred_eik
        gt_shape["surface_eikonal_term"] = gt_eik * batch["near_valid"]
    loss_shape, metrics_shape = calc_shape_rec_loss(pred_shape, gt_shape, lambdas)
    loss = loss + loss_shape
    return loss, {**metrics, **metrics_shape, "loss": loss, "thumb_rec": thumb_loss}, out


@contextmanager
def tf32_off():
    """TF32 off in cuBLAS and cuDNN for the block, the flags restored after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def make_stage1_step(model, lambdas: dict[str, float], state: TrainState, lpips_fn: Callable | None = None,
                     id_fn: Callable | None = None, pose_scale_schedule: Callable[[int], float] = lambda step: 1.0):
    """train_step(mean_latents, batch_size, generator=None) -> metrics: one
    set of decoder noise maps, a frozen-GAN batch from `synthetic_sample` at
    the schedule's pose scale, `stage1_loss`, its backward and
    `optimizer_step`, all with TF32 off (`tf32_off`)."""

    def train_step(mean_latents, batch_size: int, generator: torch.Generator | None = None):
        with tf32_off(), mesh.sharded(None):
            noise = decoder_noise(model, batch_size, generator)
            batch = model.synthetic_sample(batch_size, pose_scale_schedule(state.step), generator=generator,
                                           noise=noise)
            loss, metrics, _ = stage1_loss(model, batch, mean_latents, lambdas, lpips_fn, id_fn, noise=noise)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer_step(state)
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
