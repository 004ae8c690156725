"""Training steps of the port — counterpart of `e3dge_tpu/training/steps.py`,
the stage-2 path only (e3dge_2dalignonly_runner.py:354-465): the E1 branch
trained by cycle reconstruction across identity-paired views, with the
full-resolution D's adversarial term and its step (lazy R1). The port's
stage-1, volume-D and netLocal-pretraining steps, Ranger and the adaptive
D weight are not copied: no cell runs them.

Freezing is `requires_grad_`: the trainable top modules (`STAGE22_TRAINABLE`)
keep their gradients, every other parameter is frozen, and the frozen
generator is still differentiated THROUGH (its field by the eager twin, see
`VolumeFeatureRenderer._field`). Optimizers follow the JAX package's optax
chains, each one `torch.optim.Optimizer` in f32 with optax's order of
operations: Adam.
The E step is split into a loss over a given batch (`cycle_loss`) and
`make_cycle_step`, which samples the batch. The discriminators train only inside their own steps: outside
them their parameters are frozen, so the E step differentiates through them
without giving them gradients.

The reference runs on one rank: `parallel.mesh` is the identity here, and
every `world` argument is None.
"""

from __future__ import annotations

import bisect
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import torch
from torch import nn

from port_bench.reference.ops import adaptive_avg_pool
from port_bench.reference.parallel import mesh
from port_bench.reference.training import losses as L
from port_bench.reference.training.train_utils import ema_update, make_noise

STAGE22_TRAINABLE = ("local", "grid_align", "fuse_sft_block")
EMA_DECAY = 0.5 ** (32 / 10_000)

def stage22_trainable(fix_ada: bool = False) -> tuple[str, ...]:
    """Stage-2.2's trainable set; `fix_ada` freezes the ADA aligner (reference
    e3dge_2dalignonly_runner.py:591, stage2.2.sh sets --fix_ada)."""
    return tuple(k for k in STAGE22_TRAINABLE if k != "grid_align") if fix_ada else STAGE22_TRAINABLE


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


def make_optimizer(params: Iterable[torch.Tensor], lr: float = 1e-4, name: str = "adam") -> torch.optim.Optimizer:
    """`Adam` (optax.adam's)."""
    if name == "adam":
        return Adam(params, lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


@dataclass
class TrainState:
    """The trainable parameters, their optimizer, the step count and, when
    kept, their EMA (reference accumulate). BatchNorm running statistics live
    in the model's buffers."""

    step: int
    params: dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
    ema: dict[str, torch.Tensor] | None = None

    def state_dict(self) -> dict[str, Any]:
        """The step, the optimizer's state_dict and the EMA (the parameters
        themselves are the model's)."""
        return {"step": self.step, "optimizer": self.optimizer.state_dict(), "ema": self.ema}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        """Restore a `state_dict()` into this state, built as the saving run's
        (same trainable set, optimizer and --ema)."""
        if (sd["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint's EMA does not match this run's (--ema)")
        self.step = int(sd["step"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema is not None:
            for k, v in self.ema.items():
                v.copy_(sd["ema"][k])


def create_train_state(model: nn.Module, trainable_keys: Sequence[str], lr: float,
                       optimizer: str = "adam", ema: bool = False) -> TrainState:
    params = split_params(model, trainable_keys)
    return TrainState(step=0, params=params, optimizer=make_optimizer(params.values(), lr, optimizer),
                      ema={k: p.detach().clone() for k, p in params.items()} if ema else None)


def optimizer_step(state: TrainState) -> None:
    """One optimizer step on the gradients the backward left, then the EMA
    update at EMA_DECAY when kept; step + 1."""
    state.optimizer.step()
    if state.ema is not None:
        ema_update(state.ema.values(), state.params.values(), EMA_DECAY)
    state.step += 1


def decoder_noise(model, batch_size: int, generator: torch.Generator | None = None) -> list[torch.Tensor]:
    """One set of decoder noise maps for a step, on the model's device; in a
    data-parallel step, this rank's rows of the global batch's maps."""
    d = model.cfg.decoder
    maps = make_noise(d.size, d.in_res, batch_size, generator=generator, device=model.device)
    return [mesh.own_rows(n) for n in maps]


# ------------------------------------------------------------------- stage 2


def _swap_odd_even(x: torch.Tensor) -> torch.Tensor:
    """Entries 0<->1, 2<->3, ... along axis 0 (reference
    _swap_odd_even_index_view, training_utils.py:98-119)."""
    n = x.shape[0]
    i = torch.arange(n, device=x.device)
    return x.index_select(0, i + torch.where(i % 2 == 0, 1, -1))


def swap_tree(tree):
    """`_swap_odd_even` over every tensor of a tree of dicts, lists and
    (named) tuples; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return _swap_odd_even(tree)
    if isinstance(tree, dict):
        return {k: swap_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(swap_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(swap_tree(v) for v in tree)
    return tree


@contextmanager
def _trainable(module: nn.Module):
    """The module's parameters require grad for the block only (a
    discriminator inside its own step)."""
    module.requires_grad_(True)
    try:
        yield
    finally:
        module.requires_grad_(False)


def cycle_loss(
    model,
    batch: dict[str, Any],
    mean_latents,
    lambdas: dict[str, float],
    lpips_fn: Callable | None = None,
    id_fn: Callable | None = None,
    use_ref_view_weight: bool = False,
    d_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    noise=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, Any]]:
    """The stage-2 cycle loss on an identity-paired frozen-GAN batch
    (`steps.py:410-519`): encode each view as a reference in train mode,
    render its odd/even partner's view through the E1 branch, and compare
    with that partner: MSE (+ LPIPS + ID) pooled to at most 256^2, with
    `d_fn` (the full-res D, adv_lambda > 0) the non-saturating G loss on the
    pooled reconstruction, MSE of the thumbs, L1 of the aligned residual
    against the partner's residual (res_lambda), and the hit-probability and
    depth consistency with the query's global render. Returns (loss,
    metrics, the query render's output)."""
    ref_info = model.encode_ref_images(batch["images"], mean_latents, batch["cam_settings"], train=True)
    que_out = model.que_render_given_ref(ref_info, swap_tree(batch["cam_settings"]), train=True,
                                         use_ref_view_weight=use_ref_view_weight, noise=noise)
    rec = que_out["res_render_out"]
    res = min(rec["gen_imgs"].shape[-1], 256)
    rec_256 = adaptive_avg_pool(rec["gen_imgs"], res)
    loss_2d, m = L.calc_2d_rec_loss(rec_256, adaptive_avg_pool(swap_tree(batch["images"]), res), lambdas,
                                    lpips_fn, id_fn)
    loss = loss_2d
    if d_fn is not None and lambdas.get("adv_lambda", 0.0) > 0:
        adv = L.g_nonsaturating_loss(d_fn(rec_256))
        loss = loss + lambdas["adv_lambda"] * adv
        m["loss_e_adv"] = adv
    if lambdas.get("supervise_both_gen_imgs", 1.0) > 0:
        m["thumb_rec"] = lambdas.get("l2_lambda", 1.0) * L.mse(rec["gen_thumb_imgs"], swap_tree(batch["thumb_images"]))
        loss = loss + m["thumb_rec"]
    if lambdas.get("res_lambda", 0.0) > 0:
        m["res_loss"] = L.l1(que_out["aligned_res"], swap_tree(ref_info["orig_res_gt"]))
        loss = loss + lambdas["res_lambda"] * m["res_loss"]
    que_info = que_out["que_info"]
    if lambdas.get("hit_prob_consistency_lambda", 0.0) > 0:
        # per-sample maps: whole under the ray split, so the term is the whole image's mean
        m["hit_prob_consistency"] = L.hit_prob_consistency_loss(mesh.gather_rays(rec["hit_prob"]),
                                                                mesh.gather_rays(que_info["hit_prob"]))
        loss = loss + lambdas["hit_prob_consistency_lambda"] * m["hit_prob_consistency"]
    if lambdas.get("depth_lambda", 0.0) > 0:
        m["depth_consistency"] = L.depth_consistency_loss(rec["depth"], que_info["depth"])
        loss = loss + lambdas["depth_lambda"] * m["depth_consistency"]
    m["loss"] = loss
    return loss, m, que_out


def make_cycle_step(
    model,
    lambdas: dict[str, float],
    state: TrainState,
    lpips_fn: Callable | None = None,
    id_fn: Callable | None = None,
    pose_scale_schedule: Callable[[int], float] = lambda step: 1.0,
    use_ref_view_weight: bool = False,
    d_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    world=None,
):
    """train_step(mean_latents, batch_size, generator=None) -> metrics: one
    set of decoder noise maps, an identity-paired frozen-GAN batch at the
    schedule's pose scale, `cycle_loss`, its backward, `optimizer_step` with
    the EMA (`steps.py:367-559`)."""

    def train_step(mean_latents, batch_size: int, generator: torch.Generator | None = None):
        with mesh.sharded(world, rays=True):
            noise = decoder_noise(model, batch_size, generator)
            batch = model.synthetic_sample(batch_size, pose_scale_schedule(state.step), pair_same_id=True,
                                           generator=generator, noise=noise)
            loss, metrics, _ = cycle_loss(model, batch, mean_latents, lambdas, lpips_fn, id_fn, use_ref_view_weight,
                                          d_fn, noise=noise)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        mesh.all_reduce_grads(state.params.values(), world)
        optimizer_step(state)
        return mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()}, world)

    return train_step


# ------------------------------------------------- netLocal 3D pretraining


# ------------------------------------------------------------------ D steps


@torch.no_grad()
def full_d_batch(model, mean_latents, batch_size: int, d_res: int, generator: torch.Generator | None = None,
                 world=None):
    """(fakes, reals) for the full-res D at d_res^2: a fresh frozen-GAN batch
    and its reconstruction by `image2image` at the batch's cameras, with one
    set of decoder noise maps (scripts/train.py:316-334); across `world`'s
    ranks, this rank's rows of the global batch."""
    with mesh.sharded(world):
        noise = decoder_noise(model, batch_size, generator)
        b = model.synthetic_sample(batch_size, 1.0, generator=generator, noise=noise)
        out = model.image2image(b["images"], mean_latents, b["cam_settings"], noise=noise)
    return adaptive_avg_pool(out["res_render_out"]["gen_imgs"], d_res), adaptive_avg_pool(b["images"], d_res)


@dataclass
class DState:
    """A standalone discriminator, its optimizer and its step count (the
    reference keeps the full-res D as its own network, trainer.py:1700-1728)."""

    step: int
    d: nn.Module
    optimizer: torch.optim.Optimizer

    def state_dict(self) -> dict[str, Any]:
        return {"step": self.step, "d": self.d.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        self.step = int(sd["step"])
        self.d.load_state_dict(sd["d"])
        self.optimizer.load_state_dict(sd["optimizer"])


def create_d_state(d: nn.Module, lr: float, optimizer: str = "adam") -> DState:
    """The D frozen outside its step (see `_trainable`), with its optimizer."""
    d.requires_grad_(False)
    return DState(step=0, d=d, optimizer=make_optimizer(list(d.parameters()), lr, optimizer))


def make_full_d_step(lambdas: dict[str, float], state: DState, d_reg_every: int = 16,
                     world=None):
    """train_step(real_imgs, fake_imgs) -> metrics: the full-res D's logistic
    loss * discriminator_lambda on reals against (detached) fakes, plus every
    `d_reg_every` steps the lazy R1 on the reals scaled by r1 * 0.5 *
    d_reg_every (`steps.py:645-703`, reference trainer.py:1119-1165); "r1" is
    0 on the other steps. Across `world`'s ranks the images are this rank's
    rows and the D's gradients, R1's included, are averaged."""
    d = state.d

    def train_step(real_imgs, fake_imgs):
        with _trainable(d), mesh.sharded(world):
            real_pred, fake_pred = d(real_imgs), d(fake_imgs.detach())
            d_gan = L.d_logistic_loss(real_pred, fake_pred)
            loss = d_gan * lambdas.get("discriminator_lambda", 1.0)
            metrics = {"d": d_gan, "real_score": real_pred.mean(), "fake_score": fake_pred.mean()}
            r1 = lambdas.get("r1", 0.0)
            if r1 > 0:
                metrics["r1"] = torch.zeros((), device=d_gan.device)
                if state.step % d_reg_every == 0:
                    metrics["r1"] = L.d_r1_penalty(d, real_imgs)
                    loss = loss + (r1 * 0.5 * d_reg_every) * metrics["r1"]
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mesh.all_reduce_grads(d.parameters(), world)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()}, world)

    return train_step
