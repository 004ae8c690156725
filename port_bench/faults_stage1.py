"""Faults planted in the stage-1 step (cell `st1_b4`), registered with
`faults.py`'s own (`faults.BY_NAME`, `faults.PLANTED`) through its `_fault`;
the cell's state left unchanged is `faults.state_unchanged`."""

from __future__ import annotations

from port_bench.faults import _fault, _rows, state_unchanged


@_fault
def eikonal_cut(setattr) -> None:
    """The predicted SDF gradients at the near-surface points taken as
    constants (`eikonal_term` without create_graph): the losses are the
    same, but the normal and eikonal terms give E0 no gradient, as in
    `chip_smoke.py` phase 7's control."""
    from e3dge_torch.training import steps

    inner = steps.eikonal_term

    def cut(renderer, pts, styles, create_graph=True):
        return inner(renderer, pts, styles, create_graph=False)

    setattr(steps, "eikonal_term", cut)


@_fault
def half_batch_stage1(setattr) -> None:
    """The stage-1 loss over the first half of the sample's rows (2 of 4),
    its means taken over those."""
    from e3dge_torch.training import steps

    inner = steps.stage1_loss

    def loss(model, batch, mean_latents, lambdas, *args, noise=None, **kwargs):
        h = batch["images"].shape[0] // 2
        cut = {k: (type(v)(*(_rows(x, h) for x in v)) if hasattr(v, "_fields") else _rows(v, h))
               for k, v in batch.items()}
        return inner(model, cut, mean_latents, lambdas, *args, noise=[_rows(n, h) for n in noise], **kwargs)

    setattr(steps, "stage1_loss", loss)


@_fault
def lr_doubled(setattr) -> None:
    """E0's optimizer built at twice the configured learning rate (a mis-set
    `--lr`): the first gradients are the same, each step's change twice as
    large."""
    from e3dge_torch.training import steps

    inner = steps.create_train_state

    def create(model, trainable_keys, lr, *args, **kwargs):
        return inner(model, trainable_keys, 2 * lr, *args, **kwargs)

    setattr(steps, "create_train_state", create)


STAGE1 = {"eikonal_cut": eikonal_cut, "half_batch": half_batch_stage1, "lr_doubled": lr_doubled,
          "state_unchanged": state_unchanged}
