"""Training steps of the port — counterpart of `e3dge_tpu/training/steps.py`:
stage 1 (reference AERunner.synthetic_forward, trainer.py:654-736), E0 trained
on frozen-GAN samples with 2D reconstruction, latent and 3D shape supervision;
stage 2 (e3dge_2dalignonly_runner.py:354-465), the E1 branch trained by cycle
reconstruction across identity-paired views, with the full-resolution D's
adversarial term, its step (lazy R1) and the volume D's step
(trainer.py:1100-1195).

Freezing is `requires_grad_`: the trainable top modules (`STAGE1_TRAINABLE`)
keep their gradients, every other parameter is frozen, and the frozen
generator is still differentiated THROUGH (its field by the eager twin, see
`VolumeFeatureRenderer._field`). Optimizers follow the JAX package's optax
chains, each one `torch.optim.Optimizer` in f32 with optax's order of
operations: Adam, and Ranger (gradient centralisation + the reference RAdam +
lookahead).
Each E step is split into a loss over a given batch (`stage1_loss`,
`cycle_loss`) and a `make_*_step` that samples the batch, so a test can feed
JAX's batch. The discriminators train only inside their own steps: outside
them their parameters are frozen, so the E step differentiates through them
without giving them gradients.

Across ranks (`world`, `parallel.mesh`), each step runs in the rank's
`mesh.sharded` scope: its batch size is the global one, every draw is made
at it and the rank keeps its rows, BatchNorm and the D's minibatch stddev
take global statistics, the gradients are averaged over the ranks before
the optimizer step, and the metrics are their means over the ranks.
"""

from __future__ import annotations

import bisect
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import torch
from torch import nn

from e3dge_torch.models.volume_renderer import eikonal_term
from e3dge_torch.ops import adaptive_avg_pool
from e3dge_torch.parallel import mesh
from e3dge_torch.training import losses as L
from e3dge_torch.training.train_utils import ema_update, make_noise
from e3dge_torch.utils.trace import span

STAGE1_TRAINABLE = ("encoder",)
STAGE21_TRAINABLE = ("local", "grid_align")
STAGE22_TRAINABLE = ("local", "grid_align", "fuse_sft_block")
EMA_DECAY = 0.5 ** (32 / 10_000)

# stage-1 loss weights (reference scripts/train/ffhq/stage1.sh via
# scripts/train.py:52-54), under the step's lambda names
STAGE1_LAMBDAS = dict(
    l2_lambda=1.0, lpips_lambda=0.8, id_lambda=0.1, latent_gt_lambda=1.0, shape_surface_lambda=1.0,
    shape_normal_lambda=1.0, shape_uniform_lambda=0.2, eikonal_lambda=0.1,
)


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


def create_volume_d_state(model: nn.Module, lr: float) -> TrainState:
    """The volume D's own Adam state, as the JAX trainer keeps it
    (`scripts/train.py:339-340`); unlike `create_train_state` it freezes
    nothing (the volume D trains inside `make_volume_d_step` only)."""
    params = {f"volume_discriminator.{k}": p for k, p in model.volume_discriminator.named_parameters()}
    return TrainState(step=0, params=params, optimizer=make_optimizer(params.values(), lr))


def optimizer_step(state: TrainState) -> None:
    """One optimizer step on the gradients the backward left, then the EMA
    update at EMA_DECAY when kept; step + 1."""
    state.optimizer.step()
    if state.ema is not None:
        ema_update(state.ema.values(), state.params.values(), EMA_DECAY)
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
    with span("g0.shape"):
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
    """One set of decoder noise maps for a step, on the model's device; in a
    data-parallel step, this rank's rows of the global batch's maps."""
    d = model.cfg.decoder
    maps = make_noise(d.size, d.in_res, batch_size, generator=generator, device=model.device)
    return [mesh.own_rows(n) for n in maps]


def make_stage1_step(
    model,
    lambdas: dict[str, float],
    state: TrainState,
    lpips_fn: Callable | None = None,
    id_fn: Callable | None = None,
    pose_scale_schedule: Callable[[int], float] = lambda step: 1.0,
    world: mesh.World | None = None,
):
    """train_step(mean_latents, batch_size, generator=None) -> metrics: one
    set of decoder noise maps (JAX renders the sample and the inversion with
    the same noise rng), a frozen-GAN batch from `synthetic_sample` at the
    schedule's pose scale, `stage1_loss`, its backward, the gradients
    averaged over `world`'s ranks and `optimizer_step`. A world with an sp
    axis raises: JAX's stage-1 step takes no ray split (`steps.py:267` has
    no constrain_fn)."""
    if world is not None and world.sp > 1:
        raise ValueError(f"the stage-1 step takes no ray split (sp={world.sp}): JAX's stage-1 step has no "
                         f"constrain_fn; run stage 1 at sp=1")

    def train_step(mean_latents, batch_size: int, generator: torch.Generator | None = None):
        with span("e.step"):
            with mesh.sharded(world):
                noise = decoder_noise(model, batch_size, generator)
                with span("e.sample"):
                    batch = model.synthetic_sample(batch_size, pose_scale_schedule(state.step), generator=generator,
                                                   noise=noise)
                loss, metrics, _ = stage1_loss(model, batch, mean_latents, lambdas, lpips_fn, id_fn, noise=noise)
                state.optimizer.zero_grad(set_to_none=True)
                with span("e.backward"):
                    loss.backward()
            mesh.all_reduce_grads(state.params.values(), world)
            with span("e.optimizer"):
                optimizer_step(state)
            return mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()}, world)

    return train_step


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


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """d loss / d params with the graph kept; zeros where loss does not reach."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in params]
    gs = torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]


def cycle_loss(
    model,
    batch: dict[str, Any],
    mean_latents,
    lambdas: dict[str, float],
    lpips_fn: Callable | None = None,
    id_fn: Callable | None = None,
    use_ref_view_weight: bool = False,
    d_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    adaptive_params: Sequence[torch.Tensor] | None = None,
    disc_weight_max: float = 1.0,
    noise=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, Any]]:
    """The stage-2 cycle loss on an identity-paired frozen-GAN batch
    (`steps.py:410-519`): encode each view as a reference in train mode,
    render its odd/even partner's view through the E1 branch, and compare
    with that partner: MSE (+ LPIPS + ID) pooled to at most 256^2, with
    `d_fn` (the full-res D, adv_lambda > 0) the non-saturating G loss on the
    pooled reconstruction, MSE of the thumbs, L1 of the aligned residual
    against the partner's residual (res_lambda), and the hit-probability and
    depth consistency with the query's global render. With
    `adaptive_params` (the probe: the `local` parameters) the adversarial
    term is weighted by clip(|d loss_2d| / (|d adv| + 1e-4), 0,
    disc_weight_max) over them, taken from this one forward by two
    retain-graph pulls (in a data-parallel step, averaged over the ranks
    before the norms, as JAX's global-batch gradients), as a constant.
    Under the ray split (`mesh.sharded(world, rays=True)`) every G0 render
    and field query runs the rank's rays, and each image map a 2D layer or a
    term reads is whole (`mesh.gather_rays`); the rank's gradients then
    average over the world to the global one (`parallel.mesh`). Returns
    (loss, metrics, the query render's output)."""
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
        weight = 1.0
        if adaptive_params is not None:
            g_rec, g_adv = _grads(loss_2d, adaptive_params), _grads(adv, adaptive_params)
            mesh.all_reduce_mean_([*g_rec, *g_adv], mesh.active())
            weight = L.calculate_adaptive_weight(g_rec, g_adv, disc_weight_max)
            m["d_weight"] = weight
        loss = loss + lambdas["adv_lambda"] * weight * adv
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
    adaptive_d_loss: bool = False,
    world: mesh.World | None = None,
):
    """train_step(mean_latents, batch_size, generator=None) -> metrics: one
    set of decoder noise maps, an identity-paired frozen-GAN batch at the
    schedule's pose scale, `cycle_loss` (the adaptive weight probed at the
    `local` parameters, as JAX's default probe), its backward, the gradients
    averaged over `world`'s ranks, `optimizer_step` with the EMA
    (`steps.py:367-559`). Each dp shard needs an even number of rows (the
    pairs are swapped within a rank). On a world with an sp axis the step
    splits the rays of every G0 render and field query over it (JAX's
    constrain_fn with "sp" on the image height, `__graft_entry__.py:
    202-210`); H must divide by sp."""
    if world is not None and world.sp > 1:
        mesh.ray_bounds(model.cfg.renderer.out_im_res, world)
    probe = None
    if adaptive_d_loss and d_fn is not None and lambdas.get("adv_lambda", 0.0) > 0:
        probe = [p for k, p in state.params.items() if k.startswith("local.")]

    def train_step(mean_latents, batch_size: int, generator: torch.Generator | None = None):
        with span("e.step"):
            with mesh.sharded(world, rays=True):
                noise = decoder_noise(model, batch_size, generator)
                batch = model.synthetic_sample(batch_size, pose_scale_schedule(state.step), pair_same_id=True,
                                               generator=generator, noise=noise)
                loss, metrics, _ = cycle_loss(model, batch, mean_latents, lambdas, lpips_fn, id_fn,
                                              use_ref_view_weight, d_fn, probe, noise=noise)
                state.optimizer.zero_grad(set_to_none=True)
                with span("e.backward"):
                    loss.backward()
            mesh.all_reduce_grads(state.params.values(), world)
            with span("e.optimizer"):
                optimizer_step(state)
            return mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()}, world)

    return train_step


# ------------------------------------------------- netLocal 3D pretraining


def netlocal_pretrain_loss(
    pred_surface_sdf: torch.Tensor,
    pred_uniform_sdf: torch.Tensor,
    gt_uniform_sdf: torch.Tensor,
    eikonal: torch.Tensor | None = None,
    lambdas: dict[str, float] | None = None,
) -> torch.Tensor:
    """The netLocal 3D-supervised pretraining objective (`steps.py:565-582`,
    reference HGPIFuGANNet.get_error, HGPIFuGANNet.py:217-309): the surface
    SDF of `LocalFeatureNet.predict_sdf` toward 0 (L1), the uniform points'
    SDF regressed on the frozen field's (smooth L1) and, with an eikonal
    term and eikonal_lambda, its eikonal loss."""
    lambdas = lambdas or {}
    loss = L.l1(pred_surface_sdf, torch.zeros_like(pred_surface_sdf)) * lambdas.get("surf_sdf_lambda", 1.0)
    loss = loss + L.smooth_l1(pred_uniform_sdf, gt_uniform_sdf) * lambdas.get("uniform_pts_sdf_lambda", 1.0)
    if eikonal is not None and lambdas.get("eikonal_lambda", 0.0) > 0:
        eik, _ = L.eikonal_loss(eikonal)
        loss = loss + lambdas["eikonal_lambda"] * eik
    return loss


# ------------------------------------------------------------------ D steps


@torch.no_grad()
def full_d_batch(model, mean_latents, batch_size: int, d_res: int, generator: torch.Generator | None = None,
                 world: mesh.World | None = None):
    """(fakes, reals) for the full-res D at d_res^2: a fresh frozen-GAN batch
    and its reconstruction by `image2image` at the batch's cameras, with one
    set of decoder noise maps (scripts/train.py:316-334); across `world`'s
    ranks, this rank's rows of the global batch."""
    with span("d.producer"):
        with mesh.sharded(world):
            noise = decoder_noise(model, batch_size, generator)
            b = model.synthetic_sample(batch_size, 1.0, generator=generator, noise=noise)
            out = model.image2image(b["images"], mean_latents, b["cam_settings"], noise=noise)
        return adaptive_avg_pool(out["res_render_out"]["gen_imgs"], d_res), adaptive_avg_pool(b["images"], d_res)


@torch.no_grad()
def volume_d_batch(model, mean_latents, batch_size: int, generator: torch.Generator | None = None,
                   world: mesh.World | None = None):
    """(real thumbs, fake thumbs, the fakes' viewpoints) for the volume D: the
    global reconstruction of one frozen-GAN batch at its known cameras, and
    the thumbs of another (scripts/train.py:349-373; the second batch's render
    stops before the decoder, whose output the D does not see); across
    `world`'s ranks, this rank's rows of the global batches."""
    with mesh.sharded(world):
        noise = decoder_noise(model, batch_size, generator)
        b = model.synthetic_sample(batch_size, 1.0, generator=generator, noise=noise)
        out = model.image2image_global(b["images"], mean_latents, b["cam_settings"], noise=noise)
        reals = model.synthetic_sample(batch_size, 1.0, renderer_only=True, generator=generator)
    return reals["thumb_images"], out["gen_thumb_imgs"], b["cam_settings"].viewpoint


def make_volume_d_step(model, lambdas: dict[str, float], optimizer: torch.optim.Optimizer,
                       world: mesh.World | None = None):
    """train_step(real_thumbs, fake_thumbs, fake_viewpoints) -> metrics: the
    volume D's logistic loss * discriminator_lambda, the viewpoint regression
    on the fake thumbs (whose cameras are known) * viewpoint_lambda, and
    r1/2 * R1 on the real thumbs (`steps.py:587-629`, reference
    trainer.py:1165-1186); `optimizer` holds the volume D's parameters. Across
    `world`'s ranks the thumbs are this rank's rows and the D's gradients are
    averaged, so every rank's E step sees the same D."""
    d = model.volume_discriminator

    def train_step(real_thumbs, fake_thumbs, fake_viewpoints):
        with _trainable(d), mesh.sharded(world):
            real_pred, _ = d(real_thumbs)
            fake_pred, fake_vp = d(fake_thumbs)
            d_gan = L.d_logistic_loss(real_pred, fake_pred)
            vp = L.viewpoint_loss(fake_vp, fake_viewpoints)
            loss = d_gan * lambdas.get("discriminator_lambda", 1.0) + lambdas.get("viewpoint_lambda", 1.0) * vp
            metrics = {"d": d_gan, "viewpoint": vp, "real_score": real_pred.mean(), "fake_score": fake_pred.mean()}
            if lambdas.get("r1", 0.0) > 0:
                metrics["r1"] = L.d_r1_penalty(lambda x: d(x)[0], real_thumbs)
                loss = loss + lambdas["r1"] / 2.0 * metrics["r1"]
            metrics["d_loss"] = loss
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mesh.all_reduce_grads(d.parameters(), world)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()}, world)

    return train_step


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
                     world: mesh.World | None = None):
    """train_step(real_imgs, fake_imgs) -> metrics: the full-res D's logistic
    loss * discriminator_lambda on reals against (detached) fakes, plus every
    `d_reg_every` steps the lazy R1 on the reals scaled by r1 * 0.5 *
    d_reg_every (`steps.py:645-703`, reference trainer.py:1119-1165); "r1" is
    0 on the other steps. Across `world`'s ranks the images are this rank's
    rows and the D's gradients, R1's included, are averaged."""
    d = state.d

    def train_step(real_imgs, fake_imgs):
        with span("d.step"):
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
