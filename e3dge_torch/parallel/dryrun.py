"""The multi-rank dry run: the counterpart of `__graft_entry__.dryrun_multichip`
on JAX's mesh shapes. n ranks (processes of `launch.spawn`: each rank's card
over nccl, or the CPU over gloo) take two cycle steps at `tiny_full_config`
on a global batch of 2·dp on the primary (n/sp)×sp mesh (sp = 2 for an even
n), serve one `Runner.image2image` of n images under pure dp = n, then take
one cycle step on (n×1) and, when 4 divides n, on (2×n/2); every loss and
image must be finite and the ranks must agree.

    python -c "from e3dge_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"  # 4 cards
    python -c "from e3dge_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4, 'cpu')"

Each mesh prints `dryrun_multichip OK: mesh=(DPxSP) steps=S loss=L`, as
JAX's does, and serving `dryrun_multichip OK: serving dp=n out=(n, 3, H, W)`.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from e3dge_torch.parallel import launch, mesh

LAMBDAS = dict(l2_lambda=1.0, res_lambda=1.0)
STEPS = 2


def mesh_shapes(n: int) -> list[tuple[int, int, int]]:
    """JAX's (dp, sp, steps) list for n devices (`__graft_entry__.py:
    213-243`): the primary mesh twice, then the alternates once each."""
    sp = 2 if n % 2 == 0 else 1
    shapes = [(n // sp, sp, STEPS)]
    if n >= 2:
        shapes.append((n, 1, 1))
    if n % 4 == 0:
        shapes.append((2, n // 2, 1))
    return shapes


def _cycle(world: mesh.World, model, ml, steps_n: int) -> list[float]:
    """steps_n cycle steps at a global batch of 2·dp on `world` from a fresh
    train state (the model's trained leaves carry over between meshes)."""
    from e3dge_torch.training import steps

    dev = world.device
    state = steps.create_train_state(model, steps.STAGE22_TRAINABLE, 1e-4)
    step = steps.make_cycle_step(model, LAMBDAS, state, world=world)
    return [float(step(ml, 2 * world.dp, torch.Generator(dev).manual_seed(10 + i))["loss"]) for i in range(steps_n)]


def _dryrun_rank(world: mesh.World, work_dir: str) -> dict:
    from e3dge_torch.config import tiny_full_config
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.runner import Runner
    from e3dge_torch.utils.weights import init_weights

    dev = world.device
    model = E3DGE(tiny_full_config(), device=dev)
    init_weights(model, 0)
    mesh.replicate(model, world)
    ml = model.mean_latent(64, torch.Generator(dev).manual_seed(1))
    meshes = []
    for i, (dp, sp, n_steps) in enumerate(mesh_shapes(world.size)):
        losses = _cycle(mesh.split_world(world, sp), model, ml, n_steps)
        meshes.append((dp, sp, n_steps, losses))
        if i == 0:  # serving under pure dp, after the primary mesh (JAX's order)
            images = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (world.size, 3, 32, 32))
                                      .astype(np.float32))
            runner = Runner(model, ml, dev, work_dir=work_dir, world=mesh.split_world(world, 1))
            gen = runner.image2image(images)["res_render_out"]["gen_imgs"]
    if not (all(np.isfinite(m[3]).all() for m in meshes) and torch.isfinite(gen).all()):
        raise FloatingPointError(f"rank {world.rank}: non-finite losses {meshes} or images")
    return {"losses": meshes[0][3], "meshes": meshes, "gen_imgs": gen.cpu().numpy()}


def dryrun_multichip(n: int = 2, device: str | None = None, timeout: float = 600.0) -> dict:
    """Run the dry run on n ranks (device None: each rank's card over nccl;
    "cpu": over gloo) and return rank 0's {"losses" (the primary mesh's),
    "meshes" [(dp, sp, steps, losses)], "gen_imgs"}; raises if a rank
    fails, the ranks disagree, or the time runs out."""
    with tempfile.TemporaryDirectory(prefix="e3dge_dryrun_") as tmp:
        out = launch.spawn(_dryrun_rank, n, tmp, timeout=timeout, device=device)
    for r, o in enumerate(out[1:], 1):
        if o["meshes"] != out[0]["meshes"] or not np.array_equal(o["gen_imgs"], out[0]["gen_imgs"]):
            raise AssertionError(f"dryrun_multichip: rank {r} disagrees with rank 0")
    first = out[0]
    for i, (dp, sp, n_steps, losses) in enumerate(first["meshes"]):
        print(f"dryrun_multichip OK: mesh=({dp}x{sp}) steps={n_steps} loss={losses[-1]:.4f}", flush=True)
        if i == 0:
            print(f"dryrun_multichip OK: serving dp={n} out={tuple(first['gen_imgs'].shape)}", flush=True)
    return first
