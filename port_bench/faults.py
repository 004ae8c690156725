"""Faults planted in the timed path, for the tests that see `correct` come
out false and for reading a fault's numbers on the card. Each takes a
`setattr(obj, name, value)` (pytest's `monkeypatch.setattr`, or one that
lasts the process) and breaks the program underneath the harness. Planting
one also adds its name to `PLANTED` through the same setattr, so that a
driver that starts ranks of its own (`drivers/train_dp.py`) plants it in
every rank: a fault in one rank alone would leave the others waiting in a
collective it skips."""

from __future__ import annotations

import functools
import sys

import torch

# the names of the faults planted in this process, in order
PLANTED: tuple[str, ...] = ()
BY_NAME = {}


def _fault(fn):
    @functools.wraps(fn)
    def plant(setattr) -> None:
        fn(setattr)
        setattr(sys.modules[__name__], "PLANTED", (*PLANTED, fn.__name__))

    BY_NAME[fn.__name__] = plant
    return plant


def _rows(t, h: int):
    return t[:h] if isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == 2 * h else t


@_fault
def alter_answer(setattr) -> None:
    """The first photo's image shifted by one pixel where Runner produces it."""
    from e3dge_torch.runner import Runner

    inner = Runner.image2image

    def altered(self, images, noise=None):
        out = inner(self, images, noise)
        img = out["res_render_out"]["gen_imgs"]
        img[0] = img[0].roll(1, dims=-1)
        return out

    setattr(Runner, "image2image", altered)


@_fault
def half_batch_serving(setattr) -> None:
    """Only the first half of each call's photos inverted; the rest answered
    with those."""
    from e3dge_torch.runner import Runner

    inner = Runner.image2image

    def half(self, images, noise=None):
        h = images.shape[0] // 2
        out = inner(self, images[:h], [n[:h] for n in noise])
        img = out["res_render_out"]["gen_imgs"]
        out["res_render_out"]["gen_imgs"] = torch.cat([img, img])
        return out

    setattr(Runner, "image2image", half)


@_fault
def half_batch_training(setattr) -> None:
    """The cycle loss and the D step over the first half of their rows (one
    identity pair of two at B=4), the means taken over the rest."""
    from e3dge_torch.training import steps

    inner_loss, inner_d = steps.cycle_loss, steps.make_full_d_step

    def loss(model, batch, mean_latents, lambdas, *args, noise=None, **kwargs):
        h = batch["images"].shape[0] // 2
        cut = {k: (type(v)(*(_rows(x, h) for x in v)) if hasattr(v, "_fields") else _rows(v, h))
               for k, v in batch.items()}
        return inner_loss(model, cut, mean_latents, lambdas, *args, noise=[_rows(n, h) for n in noise], **kwargs)

    def make_d_step(*args, **kwargs):
        step = inner_d(*args, **kwargs)

        def half(real_imgs, fake_imgs):
            h = real_imgs.shape[0] // 2
            return step(real_imgs[:h], fake_imgs[:h])

        return half

    setattr(steps, "cycle_loss", loss)
    setattr(steps, "make_full_d_step", make_d_step)


@_fault
def state_unchanged(setattr) -> None:
    """Every optimizer step of the port (the E's and the D's Adam) leaves the
    parameters as they were."""
    from e3dge_torch.training import steps

    setattr(steps.Adam, "step", lambda self, closure=None: None)


@_fault
def adv_dropped(setattr) -> None:
    """The cycle step built without its D: the adversarial term left out of
    the E's loss."""
    from e3dge_torch.training import steps

    inner = steps.make_cycle_step

    def make(*args, **kwargs):
        return inner(*args, **{**kwargs, "d_fn": None})

    setattr(steps, "make_cycle_step", make)


@_fault
def grad_exchange_skipped(setattr) -> None:
    """No gradient exchange between the ranks: each rank's optimizers step
    on its own rows' gradients (`mesh.all_reduce_grads` does nothing)."""
    from e3dge_torch.parallel import mesh

    setattr(mesh, "all_reduce_grads", lambda params, world: None)


@_fault
def rank_local_stats(setattr) -> None:
    """Batch statistics over each rank's own rows: the full-res D's
    minibatch stddev reads this rank's rows, not the global batch, and
    BatchNorm's moments are not averaged over the ranks."""
    from e3dge_torch.models.discriminator import Discriminator
    from e3dge_torch.parallel import mesh

    inner = Discriminator.forward

    def local(self, x):
        with mesh.sharded(None):
            return inner(self, x)

    setattr(Discriminator, "forward", local)
    setattr(mesh, "mean_over_ranks", lambda x: x)


def _in_peers(setattr, act) -> None:
    """`act()` in every rank but rank 0, at its first cycle step after the
    three checked iterations."""
    import torch.distributed as dist
    from e3dge_torch.training import steps

    inner = steps.make_cycle_step

    def make(*args, **kwargs):
        step, calls = inner(*args, **kwargs), []

        def acting(*a, **k):
            calls.append(1)
            if len(calls) == 4 and dist.is_initialized() and dist.get_rank() != 0:
                act()
            return step(*a, **k)

        return acting

    setattr(steps, "make_cycle_step", make)


@_fault
def peer_exits(setattr) -> None:
    """Every rank but rank 0 exits with code 1 in its first cycle step after
    the three checked iterations: a rank that dies while the others wait in
    a collective."""
    import os

    _in_peers(setattr, lambda: os._exit(1))


@_fault
def peer_loads_jax(setattr) -> None:
    """Every rank but rank 0 finds a module named `jax` loaded in its first
    cycle step after the three checked iterations: the work of ranks that
    rank 0's own look at its modules cannot see."""
    import types

    _in_peers(setattr, lambda: sys.modules.setdefault("jax", types.ModuleType("jax")))


SERVING = {"alter_answer": alter_answer, "half_batch": half_batch_serving}
TRAINING = {"half_batch": half_batch_training, "state_unchanged": state_unchanged, "adv_dropped": adv_dropped}
