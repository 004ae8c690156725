"""The `sp` (ray) axis of the PyTorch port's device mesh (`e3dge_torch.parallel`)
across ranks on the CPU over gloo, held to the JAX package's contract
(`e3dge_tpu/parallel/mesh.py`, `__graft_entry__.dryrun_multichip`): a dp x sp
world laid out as JAX's row-major `make_mesh(shape=(dp, sp))`, whose cycle
step splits the rays of every G0 render over sp, computes what one process
computes on the same global batch, up to the order of reductions.

Ranks are processes of `parallel.launch.spawn` (a file:// rendezvous under
the test's tmp_path), each on one torch thread and under RANKS_TIMEOUT.
Nothing here compiles JAX: the steps are held to one process of the port on
the same stream and seeded weights (`test_torch_cycle.py` holds a 1x2 world's
cycle loss to JAX's compiled step directly).

Tolerances, as tests/test_torch_parallel.py's: the loss 1e-4 relative (JAX's
own mesh test, tests/test_training.py:345); the averaged gradient as a whole
CYCLE_GRAD_RTOL 3e-3 relative L2, per leaf CYCLE_LEAF_RTOL 2e-2
(test_torch_cycle.py's bounds on the port against JAX); the adaptive D weight
CYCLE_GRAD_RTOL. The control, the gather's backward without its sum over the
sp group (a rank keeps the gradient of its own rays only), must fail the
per-leaf gate on a per-sample leaf (the SFT fusion block) and on a 2D one
(the ADA aligner or the hourglass filters).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_parallel import (CYCLE_GRAD_RTOL, CYCLE_LAMBDAS, CYCLE_LEAF_RTOL, CYCLE_SEED, LOSS_RTOL,
                                 RANKS_TIMEOUT, TRAIN_ARGS, _after, _grads_recorded, _groups, _output, _records,
                                 _tiny, _torchrun, leaf_errors, one_torch_thread)  # noqa: F401 (autouse)

from e3dge_torch import config as tc
from e3dge_torch.models.discriminator import Discriminator
from e3dge_torch.parallel import launch, mesh
from e3dge_torch.parallel.dryrun import dryrun_multichip
from e3dge_torch.runner import Runner
from e3dge_torch.training import steps as ts
from e3dge_torch.training import train
from e3dge_torch.utils.weights import init_weights

B, LR = 4, 1e-3
# per-sample leaves (run on a rank's rays only) and 2D leaves (run whole on
# every rank) of the stage-2.2 trainable set
PER_SAMPLE = ("fuse_sft_block.",)
TWO_D = ("grid_align.", "local.image_filter.", "local.residual_conv.", "local.depth_conv.")


def _spawn(fn, n, sp, *args, tmp_path):
    return launch.spawn(fn, n, *args, timeout=RANKS_TIMEOUT, device="cpu", rendezvous_dir=str(tmp_path), sp=sp)


@pytest.fixture
def no_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ------------------------------------------------------------ layout, guards


@pytest.mark.parametrize("dp,sp", [(2, 2), (1, 4), (4, 1), (2, 4)])
def test_rank_layout_is_jax_row_major_mesh(dp, sp):
    """Rank r of a dp x sp world sits at (dp_rank, sp_rank) where JAX's
    `make_mesh(shape=(dp, sp))` puts device r of jax.devices() (row-major:
    sp is the inner axis)."""
    import jax

    from e3dge_tpu.parallel.mesh import make_mesh

    jm = make_mesh(dp * sp, axes=("dp", "sp"), shape=(dp, sp))
    ids = [d.id for d in jax.devices()[:dp * sp]]
    for r in range(dp * sp):
        w = mesh.World(rank=r, size=dp * sp, sp=sp)
        assert (w.dp, w.sp) == (dp, sp)
        assert jm.devices[w.dp_rank, w.sp_rank].id == ids[r]


def test_world_size_that_sp_does_not_divide_raises(no_launcher):
    """`World` and `init_distributed` refuse an sp axis that does not divide
    the world, naming both numbers, before any process group starts."""
    with pytest.raises(ValueError, match="a world of 3 ranks .* sp axis of 2"):
        mesh.World(rank=0, size=3, sp=2)
    with pytest.raises(ValueError, match="a world of 1 ranks .* sp axis of 2"):
        mesh.init_distributed(device="cpu", sp=2)
    no_launcher.setenv("RANK", "0")
    no_launcher.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="a world of 3 ranks .* sp axis of 2"):
        mesh.init_distributed("gloo", device="cpu", sp=2)
    assert not dist.is_initialized()


def test_sp_refusals():
    """The cycle step refuses an sp that does not divide the image height
    (tiny_full_config's H=8 over sp=3), naming both; stage 1's step, the
    trainer's stage 1 and `Runner` refuse any sp > 1 (JAX's stage-1 step
    has no constrain_fn and JAX serves under pure dp only)."""
    model, ml = _tiny(tc.tiny_full_config(), "cpu")
    state = ts.create_train_state(model, ts.STAGE22_TRAINABLE, LR)
    with pytest.raises(ValueError, match="H=8 divisible by sp=3"):
        ts.make_cycle_step(model, dict(l2_lambda=1.0), state, world=mesh.World(rank=0, size=3, sp=3))
    w = mesh.World(rank=1, size=4, sp=2)
    with pytest.raises(ValueError, match="stage-1 step takes no ray split"):
        ts.make_stage1_step(model, dict(l2_lambda=1.0), state, world=w)
    with pytest.raises(ValueError, match="pure dp only"):
        Runner(model, ml, "cpu", world=w)
    with pytest.raises(SystemExit, match="stage 1 takes no ray split"):
        train.main(["--tiny", "--device", "cpu", "--sp", "2", "--iters", "1"])
    assert state.step == 0


def test_ray_split_helpers_are_identities_outside_the_split():
    """Outside a ray-split scope (and inside one at sp = 1 or without
    `rays`) `own_rays` and `gather_rays` return their input."""
    x = torch.arange(16.0).reshape(1, 4, 4)
    assert mesh.own_rays(x) is x and mesh.gather_rays(x) is x
    with mesh.sharded(mesh.World(rank=1, size=2, sp=2)):
        assert mesh.ray_split() is None and mesh.own_rays(x) is x
    with mesh.sharded(mesh.World(rank=1, size=2), rays=True):
        assert mesh.ray_split() is None and mesh.own_rays(x) is x
    with mesh.sharded(mesh.World(rank=1, size=2, sp=2), rays=True):
        assert torch.equal(mesh.own_rays(x), x[:, 2:])
        assert torch.equal(mesh.own_rays(x, dim=2), x[:, :, 2:])


# ----------------------------------------------------------- the cycle step


def _members(world, group) -> list[int]:
    t = torch.zeros(world.size)
    t[world.rank] = 1
    dist.all_reduce(t, group=group)
    return [int(i) for i in t.nonzero().flatten()]


def _no_sp_grad_sum(x, dim=1):
    """The planted fault: `gather_rays` whose backward keeps the rank's own
    rays' gradient instead of summing it over the sp group."""
    w = mesh.ray_split()
    if w is None:
        return x
    mine = mesh._placed(x, dim, w.sp_rank, w.sp)
    return _GATHER(x.detach(), dim) + (mine - mine.detach())


_GATHER = mesh.gather_rays


def _cycle_rank(world, occlusion_mode: str, control: bool = False) -> dict:
    """One cycle step (every term on: the full-res D with the adaptive weight,
    the ref-view occlusion weighting in `occlusion_mode`, both consistency
    terms, EMA) at the global batch B from generator seed CYCLE_SEED, the
    gradients recorded before and after the averaging; with `control` the
    sp gradient sum of the gather is off."""
    dev = world.device
    model, ml = _tiny(tc._with(tc.tiny_full_config(), renderer=dict(occlusion_mode=occlusion_mode)), dev)
    d = Discriminator(32, channel_base=16).to(dev)
    init_weights(d, 3)
    d.requires_grad_(False)
    mesh.replicate(model, world)
    state = ts.create_train_state(model, ts.STAGE22_TRAINABLE, LR, ema=True)
    step = ts.make_cycle_step(model, CYCLE_LAMBDAS, state, use_ref_view_weight=True, d_fn=d, adaptive_d_loss=True,
                              world=world)
    rec = {}
    mesh.gather_rays = _no_sp_grad_sum if control else _GATHER
    try:
        with _grads_recorded(list(state.params), rec):
            m = step(ml, B, torch.Generator(dev).manual_seed(CYCLE_SEED))
    finally:
        mesh.gather_rays = _GATHER
    return _after(model, state, m, rec)


def _sp_rank(world, occlusion_mode: str) -> dict:
    out = {"run": _cycle_rank(world, occlusion_mode), "control": _cycle_rank(world, occlusion_mode, control=True),
           "coords": (world.dp_rank, world.sp_rank)}
    if world.group:
        out["groups"] = (_members(world, world.sp_group), _members(world, world.dp_group))
    return out


def _cycle_loss_rank(world, state_dict: dict, d_state_dict: dict, d_res: int, batch: dict, ml: tuple,
                     lambdas: dict, disc_weight_max: float) -> dict:
    """`cycle_loss` of `tiny_full_config` with `state_dict` on a given batch
    (numpy; "cam_settings" a tuple of CameraParams fields) under the ray
    split, with the full-res D of `d_state_dict` at d_res and the adaptive
    weight probed at `local`; its metrics (the world's means) and the
    trainable gradients averaged over the world (test_torch_cycle.py holds
    them to JAX's)."""
    from e3dge_torch.models.e3dge import E3DGE, LatentMeans
    from e3dge_torch.render.camera import CameraParams

    model = E3DGE(tc.tiny_full_config(), device=world.device)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    d = Discriminator(d_res, channel_base=16)
    d.load_state_dict({k: torch.from_numpy(v) for k, v in d_state_dict.items()}, strict=True)
    d.requires_grad_(False)
    params = ts.split_params(model, ts.STAGE22_TRAINABLE)
    probe = [p for k, p in params.items() if k.startswith("local.")]
    tb = {k: CameraParams(*map(torch.from_numpy, v)) if k == "cam_settings" else torch.from_numpy(v)
          for k, v in batch.items()}
    with mesh.sharded(world, rays=True):
        loss, metrics, _ = ts.cycle_loss(model, tb, LatentMeans(*map(torch.from_numpy, ml)), lambdas,
                                         use_ref_view_weight=True, d_fn=d, adaptive_params=probe,
                                         disc_weight_max=disc_weight_max)
        loss.backward()
    mesh.all_reduce_grads(params.values(), world)
    return {"metrics": {k: float(v) for k, v in mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()},
                                                                     world).items()},
            "grads": {k: p.grad.numpy().copy() for k, p in params.items()}}


MESHES = {"1x2": (2, 2, "exact"), "2x2": (4, 2, "texture")}


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """{mesh: (the ranks' results, one process's)}: 1x2 with the exact
    occlusion weighting, 2x2 with the texture one."""
    out = {}
    for name, (n, sp, occ) in MESHES.items():
        out[name] = (_spawn(_sp_rank, n, sp, occ, tmp_path=tmp_path_factory.mktemp("rdzv")),
                     _cycle_rank(mesh.World(), occ))
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_cycle_step_on_dp_sp_world_matches_one_process(sp_runs, name):
    """The cycle step on a 1x2 and a 2x2 world at a global B=4 against one
    process on the same stream: the loss within LOSS_RTOL, the adaptive D
    weight within CYCLE_GRAD_RTOL, the averaged gradient within
    CYCLE_GRAD_RTOL whole and CYCLE_LEAF_RTOL per leaf; every rank's
    parameters and BN statistics bit-identical after the step; each rank's
    sp and dp groups the ranks of its JAX mesh row and column."""
    ranks, one = sp_runs[name]
    n, sp, _ = MESHES[name]
    for r, got in enumerate(ranks):
        assert got["coords"] == (r // sp, r % sp)
        assert got["groups"] == ([r // sp * sp + i for i in range(sp)], list(range(r % sp, n, sp)))
    r0, want = ranks[0]["run"], one
    assert 0 < want["metrics"]["d_weight"] < 1.0  # not clipped
    assert set(r0["metrics"]) == set(want["metrics"])
    for k in ("hit_prob_consistency", "res_loss", "thumb_rec", "loss_e_adv"):
        assert want["metrics"][k] > 1e-6, k  # live terms
    for k, v in want["metrics"].items():
        if k == "psnr" and n > sp:  # across dp shards the ranks' mean, not the batch's (test_torch_parallel.py)
            continue
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=CYCLE_GRAD_RTOL if k == "d_weight" else LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    whole, leaf = leaf_errors(r0["avg"], want["avg"])
    worst = max(leaf, key=leaf.get)
    print(f"{name}: averaged gradient vs one process: relative L2 {whole:.3e} whole, worst leaf {leaf[worst]:.3e} "
          f"at {worst}")
    assert whole < CYCLE_GRAD_RTOL and leaf[worst] < CYCLE_LEAF_RTOL
    for key in ("params", "stats"):
        assert all(np.array_equal(v, got["run"][key][k]) for got in ranks[1:] for k, v in r0[key].items()), key


@pytest.mark.parametrize("name", list(MESHES))
def test_planted_sp_reduction_fault_fails_the_gate(sp_runs, name):
    """The control (the gather's backward without the sp sum) fails the
    per-leaf gate on a per-sample leaf and on a 2D leaf, and the whole
    gate; its forward still matches (the loss within LOSS_RTOL)."""
    ranks, one = sp_runs[name]
    ctl = ranks[0]["control"]
    np.testing.assert_allclose(ctl["metrics"]["loss"], one["metrics"]["loss"], rtol=LOSS_RTOL)
    whole, leaf = leaf_errors(ctl["avg"], one["avg"])
    worst_ps = max((k for k in leaf if k.startswith(PER_SAMPLE)), key=leaf.get)
    worst_2d = max((k for k in leaf if k.startswith(TWO_D)), key=leaf.get)
    print(f"{name} control: whole {whole:.3e}; per-sample {worst_ps} {leaf[worst_ps]:.3e}; 2D {worst_2d} "
          f"{leaf[worst_2d]:.3e}")
    assert whole > CYCLE_GRAD_RTOL
    assert leaf[worst_ps] > CYCLE_LEAF_RTOL and leaf[worst_2d] > CYCLE_LEAF_RTOL


# ------------------------------------------------------------- train.main


def test_trainer_with_sp_under_torchrun_matches_one_rank(tmp_path):
    """`torchrun --nproc_per_node 4 -m e3dge_torch.training.train --sp 2`
    (a 2x2 world) at stage 2.2 --tiny (both Ds, --ema) for 2 iterations at
    the global B=4 against `train.main` on one rank: the logged losses
    within LOSS_RTOL and the final state within CYCLE_GRAD_RTOL per group;
    only rank 0 prints and logs."""
    args = [*TRAIN_ARGS, "--iters", "2"]
    four, one = tmp_path / "four", tmp_path / "one"
    proc = _torchrun([*args, "--sp", "2", "--work-dir", str(four)], tmp_path, n=4)
    assert train.main([*args, "--work-dir", str(one)]) == 0  # while the ranks run
    out = _output(proc)
    assert "batch 4 (4 ranks: dp 2 x sp 2, 2 rows and 4 of 8 ray rows each)" in out
    assert out.count("iter 1: loss=") == 1
    got, want = _records(four), _records(one)
    assert [r["step"] for r in got] == [1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "loss_l2", "res_loss", "loss_e_adv", "d_d", "d_r1", "vd_d_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    ga, gb = _groups(four / "models_final"), _groups(one / "models_final")
    for name, want_t in gb.items():
        x = torch.cat([t.double().flatten() for t in ga[name]])
        y = torch.cat([t.double().flatten() for t in want_t])
        gap = float((x - y).norm() / y.norm())
        print(f"final state, 2x2 vs 1: {name} {gap:.3e}")
        assert gap < CYCLE_GRAD_RTOL, name


# ------------------------------------------------------------- the dry run


def test_dryrun_multichip_runs_jax_mesh_shapes(capsys):
    """`dryrun_multichip(4, "cpu")` runs JAX's shape list: 2 cycle steps on
    (2x2), serving under dp=4, one step on (4x1) and one on (2x2), each
    finite with ranks that agree."""
    out = dryrun_multichip(4, "cpu", timeout=RANKS_TIMEOUT)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun_multichip OK")]
    assert [ln.split(" loss=")[0].split(" out=")[0] for ln in lines] == [
        "dryrun_multichip OK: mesh=(2x2) steps=2", "dryrun_multichip OK: serving dp=4",
        "dryrun_multichip OK: mesh=(4x1) steps=1", "dryrun_multichip OK: mesh=(2x2) steps=1"]
    assert [tuple(m[:3]) for m in out["meshes"]] == [(2, 2, 2), (4, 1, 1), (2, 2, 1)]
    assert all(np.isfinite(m[3]).all() for m in out["meshes"])
    assert out["gen_imgs"].shape == (4, 3, 32, 32) and np.isfinite(out["gen_imgs"]).all()
