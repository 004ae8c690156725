"""The multi-rank dry run: the counterpart of `__graft_entry__.dryrun_multichip`
for the `dp` axis. n ranks (processes of `launch.spawn`: each rank's card
over nccl, or the CPU over gloo) take two cycle steps at `tiny_full_config`
on a global batch of 2n, then serve one `Runner.image2image` of n images
data-parallel; every loss and image must be finite and the ranks must
agree.

    python -c "from e3dge_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2)"  # n cards
    python -c "from e3dge_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2, 'cpu')"

The JAX dry run's other mesh shapes vary its `sp` (ray) axis, which the
port does not have yet.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from e3dge_torch.parallel import launch, mesh

LAMBDAS = dict(l2_lambda=1.0, res_lambda=1.0)
STEPS = 2


def _dryrun_rank(world: mesh.World, work_dir: str) -> dict:
    from e3dge_torch.config import tiny_full_config
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.runner import Runner
    from e3dge_torch.training import steps
    from e3dge_torch.utils.weights import init_weights

    dev = world.device
    model = E3DGE(tiny_full_config(), device=dev)
    init_weights(model, 0)
    mesh.replicate(model, world)
    ml = model.mean_latent(64, torch.Generator(dev).manual_seed(1))
    state = steps.create_train_state(model, steps.STAGE22_TRAINABLE, 1e-4)
    step = steps.make_cycle_step(model, LAMBDAS, state, world=world)
    losses = [float(step(ml, 2 * world.size, torch.Generator(dev).manual_seed(10 + i))["loss"]) for i in range(STEPS)]
    images = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (world.size, 3, 32, 32)).astype(np.float32))
    gen = Runner(model, ml, dev, work_dir=work_dir, world=world).image2image(images)["res_render_out"]["gen_imgs"]
    if not (np.isfinite(losses).all() and torch.isfinite(gen).all()):
        raise FloatingPointError(f"rank {world.rank}: non-finite losses {losses} or images")
    return {"losses": losses, "gen_imgs": gen.cpu().numpy()}


def dryrun_multichip(n: int = 2, device: str | None = None, timeout: float = 600.0) -> dict:
    """Run the dry run on n ranks (device None: each rank's card over nccl;
    "cpu": over gloo) and return rank 0's {"losses", "gen_imgs"}; raises if a
    rank fails, the ranks disagree, or the time runs out."""
    with tempfile.TemporaryDirectory(prefix="e3dge_dryrun_") as tmp:
        out = launch.spawn(_dryrun_rank, n, tmp, timeout=timeout, device=device)
    for r, o in enumerate(out[1:], 1):
        if o["losses"] != out[0]["losses"] or not np.array_equal(o["gen_imgs"], out[0]["gen_imgs"]):
            raise AssertionError(f"dryrun_multichip: rank {r} disagrees with rank 0")
    print(f"dryrun_multichip OK: dp={n} losses={out[0]['losses']} gen_imgs {out[0]['gen_imgs'].shape}", flush=True)
    return out[0]
