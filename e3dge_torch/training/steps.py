"""Stage-1 training of the port — counterpart of the stage-1 parts of
`e3dge_tpu/training/steps.py` (reference AERunner.synthetic_forward,
trainer.py:654-736): E0 trained on frozen-GAN samples with 2D reconstruction,
latent and 3D shape supervision.

Freezing is `requires_grad_`: the trainable top modules (`STAGE1_TRAINABLE`)
keep their gradients, every other parameter is frozen, and the frozen
generator is still differentiated THROUGH (its field by the eager twin, see
`VolumeFeatureRenderer._field`). Optimizers follow the JAX package's optax
chains, each one `torch.optim.Optimizer` in f32 with optax's order of
operations: Adam, and Ranger (gradient centralisation + the reference RAdam +
lookahead).
The step is split into `stage1_loss` over a given batch and `make_stage1_step`,
which samples the batch, so a test can feed JAX's batch.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import torch
from torch import nn

from e3dge_torch.models.volume_renderer import eikonal_term
from e3dge_torch.ops import adaptive_avg_pool
from e3dge_torch.training import losses as L
from e3dge_torch.training.train_utils import make_noise

STAGE1_TRAINABLE = ("encoder",)

# stage-1 loss weights (reference scripts/train/ffhq/stage1.sh via
# scripts/train.py:52-54), under the step's lambda names
STAGE1_LAMBDAS = dict(
    l2_lambda=1.0, lpips_lambda=0.8, id_lambda=0.1, latent_gt_lambda=1.0, shape_surface_lambda=1.0,
    shape_normal_lambda=1.0, shape_uniform_lambda=0.2, eikonal_lambda=0.1,
)


def pose_curriculum(
    steps: Sequence[int] = (0, 10000, 14000, 18000, 22000, 26000),
    lambdas: Sequence[float] = (0.0, 0.15, 0.25, 0.5, 0.75, 1.0),
    fixed_tail: bool = False,
) -> Callable[[int], float]:
    """Progressive pose-range schedule step -> scale (reference
    get_curriculum_pose_lambda, utils/data_util.py:193-210), with the
    reference's off-by-one kept by default (`steps.py:44-70`): for step >=
    steps[-1] it stays at lambdas[-2]; fixed_tail reaches lambdas[-1]."""
    edges = list(steps[1:])
    max_idx = len(lambdas) - 1 if fixed_tail else len(lambdas) - 2

    def schedule(step: int) -> float:
        return float(lambdas[min(bisect.bisect_right(edges, int(step)), max_idx)])

    return schedule


def split_params(model: nn.Module, trainable_keys: Sequence[str]) -> dict[str, nn.Parameter]:
    """Freeze every top module of `model` but `trainable_keys` (requires_grad_)
    and return the trainable parameters by their state-dict names."""
    unknown = set(trainable_keys) - {name for name, _ in model.named_children()}
    if unknown:
        raise KeyError(f"no top module {sorted(unknown)}")
    trainable = {}
    for name, child in model.named_children():
        child.requires_grad_(name in trainable_keys)
        if name in trainable_keys:
            trainable.update({f"{name}.{k}": p for k, p in child.named_parameters()})
    return trainable


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _bias_correction(decay: float, t: int) -> float:
    """1 - decay^t in f32, as optax computes it (torch's f32 pow gives XLA's
    bits on the CPU)."""
    return float(1.0 - torch.pow(_f32(decay), _f32(float(t))))


def _by_step(opt: torch.optim.Optimizer, group: dict, zeros: Sequence[str], copies: Sequence[str] = ()):
    """The group's parameters that have a gradient, each one step further,
    grouped by their step count (one group unless some parameter missed a
    gradient): yields (t, params, grads, {state key: [tensors]}). A new state
    starts its `zeros` keys at zero and its `copies` keys at the parameter."""
    by_t = {}
    for p in group["params"]:
        if p.grad is None:
            continue
        st = opt.state[p]
        if not st:
            st.update(step=0, **{k: torch.zeros_like(p) for k in zeros}, **{k: p.detach().clone() for k in copies})
        st["step"] += 1
        by_t.setdefault(st["step"], []).append(p)
    for t, ps in by_t.items():
        yield t, ps, [p.grad for p in ps], {k: [opt.state[p][k] for p in ps] for k in (*zeros, *copies)}


class Adam(torch.optim.Optimizer):
    """`optax.adam` (betas (0.9, 0.999), eps 1e-8 outside the sqrt, as
    torch.optim.Adam puts it) in optax's order of f32 operations, as
    multi-tensor (`torch._foreach_*`) updates: m and v as (1 - b) * g^k + b *
    m, each divided by its bias correction, m_hat / (sqrt(v_hat) + eps)
    scaled by -lr, then added to the parameter. (torch's Adam folds the
    corrections into the step size instead, which moves parameters by an ulp
    or two against JAX's.)"""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=(0.9, 0.999), eps=1e-8))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for t, ps, gs, st in _by_step(self, group, zeros=("mu", "nu")):
                mu, nu = st["mu"], st["nu"]
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - b1))
                torch._foreach_mul_(nu, b2)
                torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
                m_hat = torch._foreach_div(mu, _bias_correction(b1, t))
                denom = torch._foreach_sqrt(torch._foreach_div(nu, _bias_correction(b2, t)))
                torch._foreach_add_(denom, group["eps"])
                upd = torch._foreach_div(m_hat, denom)
                torch._foreach_mul_(upd, -group["lr"])
                torch._foreach_add_(ps, upd)
        return loss


class Ranger(torch.optim.Optimizer):
    """The reference Ranger (utils/ranger.py) as the JAX package chains it
    (`steps.py:88-211`): gradient centralisation (the per-output-channel mean
    off every grad with ndim > 1), the reference RAdam (betas (0.95, 0.999),
    eps 1e-5 added to the UNCORRECTED sqrt(v); below the N_sma threshold the
    update falls back to bias-corrected momentum), the step -lr, then
    lookahead (every `sync_period` steps the fast weights are pulled
    `slow_step` of the way to the slow copy, which takes the result). The
    step's scalars are f32, in JAX's order of operations: N_sma of f32 t
    differs from the f64 value by up to 0.04 near the threshold. The moments
    and the lookahead are multi-tensor (`torch._foreach_*`) updates."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=(0.95, 0.999), eps=1e-5, threshold=5.0, sync_period=6,
                                      slow_step=0.5))

    @staticmethod
    def _scalars(t: int, b1: float, b2: float, threshold: float) -> tuple[float, bool]:
        """(the step's scale of m, whether it is rectified), computed in f32."""
        tt = _f32(float(t))
        b1t, b2t = torch.pow(_f32(b1), tt), torch.pow(_f32(b2), tt)
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_sma_max - 2.0 * tt * b2t / (1.0 - b2t)
        if float(n_sma) > threshold:
            rect = torch.sqrt((1.0 - b2t) * (n_sma - 4.0) / (n_sma_max - 4.0) * (n_sma - 2.0) / n_sma
                              * n_sma_max / (n_sma_max - 2.0)) / (1.0 - b1t)
            return float(rect), True
        return float(1.0 / (1.0 - b1t)), False

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for t, ps, gs, st in _by_step(self, group, zeros=("mu", "nu"), copies=("slow",)):
                gs = [g - g.mean(dim=tuple(range(1, g.ndim)), keepdim=True) if g.ndim > 1 else g for g in gs]
                mu, nu = st["mu"], st["nu"]
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - b1))
                torch._foreach_mul_(nu, b2)
                torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(gs, 1.0 - b2), gs))
                scale, rectified = self._scalars(t, b1, b2, group["threshold"])
                upd = torch._foreach_mul(mu, scale)
                if rectified:
                    denom = torch._foreach_sqrt(nu)
                    torch._foreach_add_(denom, group["eps"])
                    torch._foreach_div_(upd, denom)
                torch._foreach_mul_(upd, -group["lr"])
                if t % group["sync_period"] == 0:
                    slow = st["slow"]
                    pull = torch._foreach_sub(torch._foreach_add(ps, upd), slow)
                    torch._foreach_mul_(pull, group["slow_step"])
                    torch._foreach_add_(slow, pull)
                    torch._foreach_add_(ps, torch._foreach_sub(slow, ps))
                else:
                    torch._foreach_add_(ps, upd)
        return loss


def make_optimizer(params: Iterable[torch.Tensor], lr: float = 1e-4, name: str = "adam") -> torch.optim.Optimizer:
    """`Adam` (optax.adam's) or `Ranger` (`steps.py:199-211`)."""
    if name == "adam":
        return Adam(params, lr=lr)
    if name == "ranger":
        return Ranger(params, lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


@dataclass
class TrainState:
    """The trainable parameters, their optimizer and the step count. BatchNorm
    running statistics live in the model's buffers."""

    step: int
    params: dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer


def create_train_state(model: nn.Module, trainable_keys: Sequence[str], lr: float,
                       optimizer: str = "adam") -> TrainState:
    params = split_params(model, trainable_keys)
    return TrainState(step=0, params=params, optimizer=make_optimizer(params.values(), lr, optimizer))


def optimizer_step(state: TrainState) -> None:
    """One optimizer step on the gradients the backward left; step + 1."""
    state.optimizer.step()
    state.step += 1


def stage1_loss(
    model,
    batch: dict[str, Any],
    mean_latents,
    lambdas: dict[str, float],
    lpips_fn: Callable | None = None,
    id_fn: Callable | None = None,
    noise=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, Any]]:
    """The stage-1 loss on a frozen-GAN batch (`steps.py:278-349`): the
    global inversion in train mode at the batch's cameras; MSE (+ LPIPS + ID)
    of the images pooled to at most 256^2 and MSE of the thumbs; the latent
    loss of the renderer W+ rows against the sampled w; the predicted SDF at
    the uniform and surface points; and, with the normal or eikonal lambda,
    the SDF gradients at the near-surface points (kept in the graph, so the
    loss differentiates them again) against the frozen w's. Returns (loss,
    metrics, the inversion's output)."""
    out = model.image2image_global(batch["images"], mean_latents, batch["cam_settings"], noise=noise, train=True)
    res = min(out["gen_imgs"].shape[-1], 256)
    loss_2d, m2d = L.calc_2d_rec_loss(adaptive_avg_pool(out["gen_imgs"], res),
                                      adaptive_avg_pool(batch["images"], res), lambdas, lpips_fn, id_fn)
    thumb_loss = lambdas.get("l2_lambda", 1.0) * L.mse(out["gen_thumb_imgs"], batch["thumb_images"])
    loss = loss_2d + thumb_loss

    pred_w = out["pred_latents"][0]
    if lambdas.get("latent_gt_lambda", 0.0) > 0:
        latent_loss = L.mse(pred_w, batch["latent_gt"][:, None].expand_as(pred_w))
        loss = loss + lambdas["latent_gt_lambda"] * latent_loss
        m2d["latent_gt"] = latent_loss

    # 3D shape supervision: the frozen field re-queried with the PREDICTED
    # latents at the sample's points (trainer.py:1050-1098)
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
    loss_shape, mshape = L.calc_shape_rec_loss(pred_shape, gt_shape, lambdas)
    loss = loss + loss_shape
    return loss, {**m2d, **mshape, "loss": loss, "thumb_rec": thumb_loss}, out


def decoder_noise(model, batch_size: int, generator: torch.Generator | None = None) -> list[torch.Tensor]:
    """One set of decoder noise maps for a step, on the model's device."""
    d = model.cfg.decoder
    return make_noise(d.size, d.in_res, batch_size, generator=generator, device=model.device)


def make_stage1_step(
    model,
    lambdas: dict[str, float],
    state: TrainState,
    lpips_fn: Callable | None = None,
    id_fn: Callable | None = None,
    pose_scale_schedule: Callable[[int], float] = lambda step: 1.0,
):
    """train_step(mean_latents, batch_size, generator=None) -> metrics: one
    set of decoder noise maps (JAX renders the sample and the inversion with
    the same noise rng), a frozen-GAN batch from `synthetic_sample` at the
    schedule's pose scale, `stage1_loss`, its backward and `optimizer_step`."""

    def train_step(mean_latents, batch_size: int, generator: torch.Generator | None = None):
        noise = decoder_noise(model, batch_size, generator)
        batch = model.synthetic_sample(batch_size, pose_scale_schedule(state.step), generator=generator, noise=noise)
        loss, metrics, _ = stage1_loss(model, batch, mean_latents, lambdas, lpips_fn, id_fn, noise=noise)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer_step(state)
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
