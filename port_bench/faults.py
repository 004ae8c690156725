"""Faults planted in the timed path, for the tests that see `correct` come
out false and for reading a fault's numbers on the card. Each takes a
`setattr(obj, name, value)` (pytest's `monkeypatch.setattr`, or one that
lasts the process) and breaks the program underneath the harness."""

from __future__ import annotations

import torch


def _rows(t, h: int):
    return t[:h] if isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == 2 * h else t


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


def state_unchanged(setattr) -> None:
    """Every optimizer step of the port (the E's and the D's Adam) leaves the
    parameters as they were."""
    from e3dge_torch.training import steps

    setattr(steps.Adam, "step", lambda self, closure=None: None)


def adv_dropped(setattr) -> None:
    """The cycle step built without its D: the adversarial term left out of
    the E's loss."""
    from e3dge_torch.training import steps

    inner = steps.make_cycle_step

    def make(*args, **kwargs):
        return inner(*args, **{**kwargs, "d_fn": None})

    setattr(steps, "make_cycle_step", make)


SERVING = {"alter_answer": alter_answer, "half_batch": half_batch_serving}
TRAINING = {"half_batch": half_batch_training, "state_unchanged": state_unchanged, "adv_dropped": adv_dropped}
