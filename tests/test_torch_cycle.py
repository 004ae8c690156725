"""Stage-2 training of the PyTorch port against the JAX package at
`tiny_full_config`, B=2, on the seeded variables of
`test_torch_models.seeded_variables` (NoiseInjection weights zero) carried
across by `load_jax_variables`: the cycle step with every switch on (the
full-res D's adversarial term with the adaptive weight, the ref-view
occlusion weighting, both consistency terms, EMA) against one compiled JAX
`make_cycle_step`, the texture-tail re-render against the full twin, the
full-resolution `Discriminator`, the full-D and volume-D steps, the stage-2
helpers and the trainer.

Tolerances: metrics 1e-4 relative as the stage-1 step's (1e-7 absolute for
a term that is zero up to rounding), BatchNorm running statistics 1e-5. The
cycle step's gradient is held as a whole to 3e-3 relative L2 and each leaf to
2e-2: the stage-1 step's 1e-3 per leaf is below this step's own f32 floor on
seeded weights, where the port's gradient moves further than that under a
1e-7 relative perturbation of its input images
(`test_cycle_gradient_gap_is_rounding` measures it; the depth context conv
normalises a near-flat depth map). The adaptive weight, a ratio of two
gradient norms, is held as the whole gradient. A leaf whose JAX gradient
is below 1e-6 of the whole gradient's norm is zero but for rounding (an
aligner BatchNorm shift that feeds only train-mode BatchNorms) and is
measured against that floor. The
discriminators' forwards 1e-4 of their scale; their steps under plain SGD at
lr 1, so that each parameter's move is its gradient (Adam's first step,
g / (|g| + eps), would turn a gradient element near zero into an O(lr)
difference), the moves within 1e-3 relative L2 as a whole, 2e-2 per leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import conv_atol, seeded_variables
from test_torch_sp import RANKS_TIMEOUT, _cycle_loss_rank
from test_torch_training import (GRAD_RTOL, METRIC_RTOL, STAT_ATOL, _capture, _np, _t, _torch_batch,
                                 one_torch_thread)  # noqa: F401 (autouse)

from e3dge_torch import config as tc
from e3dge_torch.models.discriminator import Discriminator as TDisc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.ops import siren_field as sf
from e3dge_torch.parallel import launch
from e3dge_torch.training import steps as ts
from e3dge_torch.training import train_utils as tu
from e3dge_torch.utils.weights import (batch_stats_to_jax, discriminator_state_dict_from_jax, jax_path_to_torch,
                                       load_jax_variables)
from e3dge_tpu.models.discriminator import Discriminator as JDisc
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.training import steps as js
from e3dge_tpu.training import train_utils as ju
from e3dge_tpu.utils.torch_ckpt import flatten_tree

B, D_RES, LR = 2, 32, 1e-3
# every stage-2 switch on; adv_lambda above the recipe's 0.01 so the
# adversarial gradient shows in the leaves
LAMBDAS = dict(l2_lambda=1.0, res_lambda=1.0, adv_lambda=0.1, hit_prob_consistency_lambda=0.1, depth_lambda=0.1)
D_LAMBDAS = dict(discriminator_lambda=0.5, r1=10.0)
VD_LAMBDAS = dict(discriminator_lambda=1.0, viewpoint_lambda=1.0, r1=10.0)
CYCLE_GRAD_RTOL, CYCLE_LEAF_RTOL, LEAF_FLOOR = 3e-3, 2e-2, 1e-6
# the adaptive weight's clip, raised above the seeded D's ratio so the test
# reads the weight itself
DISC_WEIGHT_MAX = 100.0
# XLA's CPU backend without its expensive LLVM passes: the cycle step's
# compile takes ~40% less time; the HLO and so the order of operations stay
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args, static_argnums=()):
    """fn jitted and compiled for args with FAST_COMPILE; call it without the
    static arguments."""
    return jax.jit(fn, static_argnums=static_argnums).lower(*args).compile(FAST_COMPILE)


def leaf_errors(got: dict, want: dict) -> tuple[float, dict]:
    """(relative L2 of all leaves together, {leaf: relative L2 against
    max(its norm, LEAF_FLOOR x the whole norm)}) over numpy or torch leaves."""
    got = {k: np.asarray(v, np.float64) for k, v in got.items()}
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    whole = np.sqrt(sum(np.square(w).sum() for w in want.values()))
    diff = np.sqrt(sum(np.square(got[k] - w).sum() for k, w in want.items()))
    floor = LEAF_FLOOR * whole
    return diff / whole, {k: np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), floor) for k, w in want.items()}


def _port(cfg, vs):
    m = TE3DGE(cfg, device="cpu")
    load_jax_variables(m, vs)
    return m


def _port_d(d_params):
    d = TDisc(D_RES, channel_base=16)
    d.load_state_dict(discriminator_state_dict_from_jax(d_params), strict=True)
    return d


@pytest.fixture(scope="module")
def setup(tiny_full_setup):
    cfg, jmodel, variables, _ = tiny_full_setup
    vs = seeded_variables(variables)
    # the depth map is near-flat on seeded weights (1.0 +- 0.007): a zero-mean
    # first depth kernel gives a constant depth no response, so the depth
    # context conv's norms see its relief, not its offset (JAX's gradient
    # there is otherwise 3x further from the port's than from itself)
    k = vs["params"]["local"]["depth_conv"]["conv_in"]["conv"]["kernel"]  # HWIO
    vs["params"]["local"]["depth_conv"]["conv_in"]["conv"]["kernel"] = k - k.mean(axis=(0, 1, 2), keepdims=True)
    rng = np.random.RandomState(21)
    ml = ((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32),
          (0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32))
    jd = JDisc(input_size=D_RES, channel_base=16)
    d_params = seeded_variables(jax.jit(jd.init)(jax.random.key(3), jnp.zeros((B, 3, D_RES, D_RES))), seed=5)["params"]
    return cfg, jmodel, vs, ml, jd, d_params


@pytest.fixture(scope="module")
def cycle(setup):
    """JAX's cycle step (one jit, every switch on) with captured gradients,
    JAX's batch built as steps.py:419-430 builds it from the same rng, and the
    port's `cycle_loss` over that batch, its gradients, BN statistics and one
    optimizer step with the EMA."""
    cfg, jmodel, vs, (ml_r, ml_d), jd, d_params = setup
    tx = _capture()
    state = js.create_train_state(vs, js.STAGE22_TRAINABLE, tx, ema=True)
    _, d_apply = js.make_full_d_step(jd, D_LAMBDAS, tx)
    fn = js.make_cycle_step(jmodel, LAMBDAS, tx, use_ref_view_weight=True, d_apply=d_apply, adaptive_d_loss=True,
                            disc_weight_max=DISC_WEIGHT_MAX)
    rng, jml = jax.random.key(7), JLM(jnp.asarray(ml_r), jnp.asarray(ml_d))
    new_state, metrics = _compiled(fn, state, jml, rng, B, d_params, static_argnums=(3,))(state, jml, rng, d_params)
    k_data, k_noise = jax.random.split(rng)
    jbatch = _compiled(lambda v: jmodel.apply(v, k_data, B, 1.0, True, method=JE3DGE.synthetic_sample,
                                              rngs={"noise": k_noise}), vs)(vs)

    tm = _port(tc.tiny_full_config(), vs)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tstate = ts.create_train_state(tm, ts.STAGE22_TRAINABLE, LR, ema=True)
    probe = [p for k, p in tstate.params.items() if k.startswith("local.")]
    d = _port_d(d_params).requires_grad_(False)
    loss, tmetrics, _ = ts.cycle_loss(tm, _torch_batch(jbatch), TLM(_t(ml_r), _t(ml_d)), LAMBDAS,
                                      use_ref_view_weight=True, d_fn=d, adaptive_params=probe,
                                      disc_weight_max=DISC_WEIGHT_MAX)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tstate.params.items()}
    stats = batch_stats_to_jax(tm, new_state.extra["batch_stats"])
    params_before = {k: p.detach().clone() for k, p in tstate.params.items()}
    ts.optimizer_step(tstate)
    return dict(metrics=metrics, new_state=new_state, tm=tm, tmetrics=tmetrics, grads=grads, stats=stats,
                before=before, params_before=params_before, state=tstate, d=d, jbatch=jbatch, vs=vs)


def test_cycle_metrics_match_jax(cycle):
    want, got = cycle["metrics"], cycle["tmetrics"]
    assert set(got) == set(want)
    for k in ("loss_e_adv", "d_weight", "thumb_rec", "res_loss", "hit_prob_consistency"):
        assert float(want[k]) > 1e-6, k  # every term is live
    assert 0 < float(want["d_weight"]) < DISC_WEIGHT_MAX  # the adaptive weight, not its clip
    for k, w in want.items():
        rtol = CYCLE_GRAD_RTOL if k == "d_weight" else METRIC_RTOL
        np.testing.assert_allclose(float(got[k].detach()), float(w), rtol=rtol, atol=1e-7, err_msg=k)


def _jax_grads(cycle) -> dict:
    """JAX's captured cycle gradients under the port's parameter names."""
    want = flatten_tree(jax.tree.map(np.asarray, {"params": cycle["new_state"].opt_state}))
    out = {}
    for path, w in want.items():
        top, (key, transform) = jax_path_to_torch(path)
        out[f"{top}.{key}"] = transform(w)
    return out


def test_cycle_gradients_match_jax(cycle):
    """The gradient of every trainable leaf of local, grid_align and
    fuse_sft_block against JAX's (the adversarial term at the adaptive weight
    included), as a whole and per leaf; the frozen modules get none."""
    ref = _jax_grads(cycle)
    whole, leaf = leaf_errors({k: _np(cycle["grads"][k]) for k in ref}, ref)
    worst = max(leaf, key=leaf.get)
    print(f"cycle gradient vs JAX: relative L2 {whole:.3e} as a whole, worst leaf {leaf[worst]:.3e} at {worst}")
    assert whole < CYCLE_GRAD_RTOL, f"whole gradient: relative L2 error {whole:.2e}"
    assert leaf[worst] < CYCLE_LEAF_RTOL, f"{worst}: relative L2 error {leaf[worst]:.2e}"
    tops = {k.split(".")[0] for k in ref}
    assert tops == set(ts.STAGE22_TRAINABLE) and len(ref) == len(cycle["grads"])
    assert all(p.grad is None for n, p in cycle["tm"].named_parameters() if n.split(".")[0] not in tops)
    assert all(p.grad is None for p in cycle["d"].parameters())


def test_cycle_loss_on_a_1x2_world_matches_jax(setup, cycle, tmp_path):
    """The port's `cycle_loss` on the fixture's batch across a 1x2 gloo world
    (the rays of every G0 render split over 2 ranks, the image maps gathered
    whole) against JAX's compiled step: every metric within METRIC_RTOL (the
    adaptive weight CYCLE_GRAD_RTOL), the averaged gradient within
    CYCLE_GRAD_RTOL as a whole and CYCLE_LEAF_RTOL per leaf, on both ranks."""
    _, _, _, ml, _, _ = setup
    sd = {k: v.numpy() for k, v in cycle["before"].items()}
    d_sd = {k: v.numpy() for k, v in cycle["d"].state_dict().items()}
    batch = {k: tuple(np.asarray(f) for f in v) if k == "cam_settings" else np.asarray(v)
             for k, v in cycle["jbatch"].items()}
    got = launch.spawn(_cycle_loss_rank, 2, sd, d_sd, D_RES, batch, ml, LAMBDAS, DISC_WEIGHT_MAX, timeout=RANKS_TIMEOUT,
                       device="cpu", rendezvous_dir=str(tmp_path), sp=2)
    want, ref = cycle["metrics"], _jax_grads(cycle)
    for r in got:
        assert set(r["metrics"]) == set(want)
        for k, w in want.items():
            rtol = CYCLE_GRAD_RTOL if k == "d_weight" else METRIC_RTOL
            np.testing.assert_allclose(r["metrics"][k], float(w), rtol=rtol, atol=1e-7, err_msg=k)
        whole, leaf = leaf_errors({k: r["grads"][k] for k in ref}, ref)
        worst = max(leaf, key=leaf.get)
        print(f"1x2 world: cycle gradient vs JAX: relative L2 {whole:.3e} as a whole, worst leaf {leaf[worst]:.3e} "
              f"at {worst}")
        assert whole < CYCLE_GRAD_RTOL and leaf[worst] < CYCLE_LEAF_RTOL, f"{worst}: {leaf[worst]:.2e}"


def test_cycle_gradient_gap_is_rounding(setup, cycle):
    """Why the cycle gradient is not held at stage 1's GRAD_RTOL per leaf: the
    port's own gradient moves beyond it on some leaf under a 1e-7 relative
    perturbation of the input images, and its gap to JAX's gradient, as a
    whole, is no larger than twice that rounding-level move."""
    _, _, vs, (ml_r, ml_d), _, d_params = setup
    tm = _port(tc.tiny_full_config(), vs)
    params = ts.split_params(tm, ts.STAGE22_TRAINABLE)
    probe = [p for k, p in params.items() if k.startswith("local.")]
    batch = _torch_batch(cycle["jbatch"])
    noise = torch.randn(batch["images"].shape, generator=torch.Generator().manual_seed(1))
    batch["images"] = batch["images"] * (1 + 1e-7 * noise)
    loss, _, _ = ts.cycle_loss(tm, batch, TLM(_t(ml_r), _t(ml_d)), LAMBDAS, use_ref_view_weight=True,
                               d_fn=_port_d(d_params).requires_grad_(False), adaptive_params=probe,
                               disc_weight_max=DISC_WEIGHT_MAX)
    loss.backward()
    ref = _jax_grads(cycle)
    unperturbed = {k: _np(cycle["grads"][k]) for k in ref}
    spread, spread_leaf = leaf_errors({k: _np(params[k].grad) for k in ref}, unperturbed)
    gap, _ = leaf_errors(unperturbed, ref)
    worst = max(spread_leaf, key=spread_leaf.get)
    print(f"cycle gradient under a 1e-7 image perturbation: relative L2 {spread:.3e} as a whole, worst leaf "
          f"{spread_leaf[worst]:.3e} at {worst}; gap to JAX {gap:.3e}")
    assert max(spread_leaf.values()) > GRAD_RTOL, f"rounding moves the worst leaf by {max(spread_leaf.values()):.2e}"
    assert gap < 2 * spread, f"gap to JAX {gap:.2e}, the port's own rounding spread {spread:.2e}"


def test_cycle_batchnorm_stats_and_frozen_modules(cycle):
    """E0 (frozen) and the aligner run with batch statistics: their running
    statistics after the step are JAX's, and moved; after the optimizer step
    the trained modules moved, everything else but the BN statistics is
    bit-identical, and the EMA lies between the old and the new parameters."""
    want = flatten_tree(jax.tree.map(np.asarray, cycle["new_state"].extra["batch_stats"]))
    got = flatten_tree(cycle["stats"])
    start = flatten_tree(cycle["vs"]["batch_stats"])
    assert set(got) == set(want) and {p.split("/")[0] for p in want} == {"encoder", "grid_align"}
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=STAT_ATOL, err_msg=path)
        assert not np.allclose(w, start[path], atol=STAT_ATOL), path
    tm, before, state = cycle["tm"], cycle["before"], cycle["state"]
    after = tm.state_dict()
    trained = tuple(f"{t}." for t in ts.STAGE22_TRAINABLE)
    for k in before:
        if "running_" in k or "num_batches" in k:
            continue
        assert torch.equal(after[k], before[k]) != k.startswith(trained) or "noise" in k, k
    decay = ts.EMA_DECAY
    for k, p in state.params.items():
        torch.testing.assert_close(state.ema[k], decay * cycle["params_before"][k] + (1 - decay) * p.detach())
    assert state.step == 1 and not tm.encoder.training and not tm.grid_align.training


@pytest.mark.parametrize("mode", ["exact", "texture"])
def test_texture_tail_equals_the_full_twin_rerender(setup, cycle, monkeypatch, mode):
    """The training re-render on the query render's cached backbone (the twin's
    texture head only) against the full twin re-render of JAX's route, with
    the ref-view weighting in each occlusion mode: equal loss and equal
    gradients of every trainable parameter (all of which reach the loss
    through the texture modulations); the tail launches no kernel entry."""
    _, _, vs, (ml_r, ml_d), _, _ = setup
    out = []
    for tail in (True, False):
        tm = _port(tc._with(tc.tiny_full_config(), renderer=dict(occlusion_mode=mode)), vs)
        ts.split_params(tm, ts.STAGE22_TRAINABLE)
        if tail:
            monkeypatch.setattr(sf, "siren_field_tex", lambda *a, **k: pytest.fail("the tail took the kernel"))
        else:  # a query render without raw_h: the re-render falls back to the full twin
            latent2image = tm.latent2image
            monkeypatch.setattr(tm, "latent2image", lambda *a, **k: latent2image(*a, **{**k, "return_raw_h": False}))
        loss, _, q = ts.cycle_loss(tm, _torch_batch(cycle["jbatch"]), TLM(_t(ml_r), _t(ml_d)), LAMBDAS,
                                   use_ref_view_weight=True)
        assert ("raw_h" in q["que_info"]) == tail
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}))
        monkeypatch.undo()
    (l_tail, g_tail), (l_full, g_full) = out
    np.testing.assert_allclose(l_tail, l_full, rtol=1e-6)
    assert set(g_tail) == set(g_full) and len(g_tail) > 50
    whole, leaf = leaf_errors({k: v.numpy() for k, v in g_tail.items()}, {k: v.numpy() for k, v in g_full.items()})
    worst = max(leaf, key=leaf.get)
    assert whole < 1e-5 and leaf[worst] < CYCLE_LEAF_RTOL, f"whole {whole:.2e}, {worst} {leaf[worst]:.2e}"


def test_discriminator_forward_matches_jax(setup):
    _, _, _, _, jd, d_params = setup
    x = np.random.RandomState(3).uniform(-1, 1, (4, 3, D_RES, D_RES)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: jd.apply({"params": p}, a))(d_params, jnp.asarray(x)))
    d = _port_d(d_params)
    with torch.no_grad():
        got = d(_t(x))
    assert got.shape == (4, 1) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(_np(got), want, atol=conv_atol(want))
    assert set(d.state_dict()) == {k for k in discriminator_state_dict_from_jax(d_params)}


def _compare_updates(before: dict, got: dict, want: dict):
    """Plain SGD at lr 1 on both sides: the parameters' moves, the summed
    negative gradients, against JAX's: as a whole within GRAD_RTOL relative L2,
    each leaf within CYCLE_LEAF_RTOL (R1's gradient reaches the biases ahead
    of a leaky ReLU only through its kink: small and noisy)."""
    assert set(got) == set(want)
    whole, leaf = leaf_errors({k: (got[k] - before[k]).numpy() for k in want},
                              {k: (want[k] - before[k]).numpy() for k in want})
    worst = max(leaf, key=leaf.get)
    assert whole < GRAD_RTOL and leaf[worst] < CYCLE_LEAF_RTOL, f"whole {whole:.2e}, {worst} {leaf[worst]:.2e}"


def test_full_d_step_lazy_r1_matches_jax(setup):
    """Two full-D steps at d_reg_every 2: R1 fires at step 0 and is skipped at
    step 1, with metrics and updated parameters as JAX's (Adam at lr 1e-3)."""
    _, _, _, _, jd, d_params = setup
    rng = np.random.RandomState(4)
    imgs = [(rng.uniform(-1, 1, (B, 3, D_RES, D_RES)).astype(np.float32),
             rng.uniform(-1, 1, (B, 3, D_RES, D_RES)).astype(np.float32)) for _ in range(2)]
    tx = optax.sgd(1.0)
    j_step, _ = js.make_full_d_step(jd, D_LAMBDAS, tx, d_reg_every=2)
    jstate = js.create_d_state(d_params, tx)
    j_step = _compiled(j_step, jstate, *(jnp.asarray(a) for a in imgs[0]))
    d = _port_d(d_params)
    dstate = ts.create_d_state(d, LR)
    dstate.optimizer = torch.optim.SGD(d.parameters(), lr=1.0)
    t_step = ts.make_full_d_step(D_LAMBDAS, dstate, d_reg_every=2)
    before, r1 = {k: v.clone() for k, v in d.state_dict().items()}, []
    for real, fake in imgs:
        jstate, want = j_step(jstate, jnp.asarray(real), jnp.asarray(fake))
        got = t_step(_t(real), _t(fake))
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(float(got[k]), float(w), rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
        r1.append(float(got["r1"]))
    assert r1[0] > 0 and r1[1] == 0
    _compare_updates(before, dstate.d.state_dict(), discriminator_state_dict_from_jax(jstate.params))
    assert dstate.step == 2 and not any(p.requires_grad or p.grad is not None for p in dstate.d.parameters())


def test_volume_d_step_matches_jax(setup, tiny_full_setup):
    """One volume-D step (logistic loss, viewpoint regression on the fakes,
    R1) with Adam at lr 1e-3: metrics and the volume D's updated parameters
    as JAX's; the rest of the model untouched, the D frozen again."""
    cfg, jmodel, vs, *_ = setup
    res = cfg.renderer.out_im_res
    rng = np.random.RandomState(6)
    real, fake = (rng.uniform(-1, 1, (B, 3, res, res)).astype(np.float32) for _ in range(2))
    vp = (0.2 * rng.randn(B, 2)).astype(np.float32)
    tx = optax.sgd(1.0)
    jstate = js.create_train_state(vs, ("volume_discriminator",), tx)
    args = (jstate, *(jnp.asarray(a) for a in (real, fake, vp)))
    jstate, want = _compiled(js.make_volume_d_step(jmodel, VD_LAMBDAS, tx), *args)(*args)
    tm = _port(tc.tiny_full_config(), vs)
    ts.split_params(tm, ts.STAGE22_TRAINABLE)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    vd = tm.volume_discriminator
    got = ts.make_volume_d_step(tm, VD_LAMBDAS, torch.optim.SGD(vd.parameters(), lr=1.0))(_t(real), _t(fake), _t(vp))
    assert set(got) == set(want) and float(want["r1"]) > 0
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    tmp = _port(tc.tiny_full_config(), {**vs, "params": {**vs["params"], **jstate.params}})
    _compare_updates({k[len("volume_discriminator."):]: v for k, v in before.items() if k.startswith("volume_")},
                     vd.state_dict(), tmp.volume_discriminator.state_dict())
    after = tm.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before if not k.startswith("volume_discriminator."))
    assert not any(p.requires_grad or p.grad is not None for p in vd.parameters())


def test_stage2_helpers_match_jax():
    """swap_tree over a tree with a camera namedtuple, the stage-2.2 trainable
    sets, and the EMA update at the stage-2 decay."""
    from e3dge_torch.render.camera import CameraParams

    rng = np.random.RandomState(9)
    tree = {"a": rng.randn(4, 3).astype(np.float32), "b": [rng.randn(4).astype(np.float32)],
            "cam": tuple(rng.randn(4, 2).astype(np.float32) for _ in CameraParams._fields)}
    want = js.swap_tree(jax.tree.map(jnp.asarray, tree))
    got = ts.swap_tree({"a": _t(tree["a"]), "b": [_t(tree["b"][0])],
                        "cam": CameraParams(*(_t(x) for x in tree["cam"]))})
    np.testing.assert_array_equal(_np(got["a"]), np.asarray(want["a"]))
    np.testing.assert_array_equal(_np(got["b"][0]), np.asarray(want["b"][0]))
    assert isinstance(got["cam"], CameraParams)
    for g, w in zip(got["cam"], want["cam"]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    for fix in (False, True):
        assert ts.stage22_trainable(fix) == js.stage22_trainable(fix)
    assert (ts.STAGE21_TRAINABLE, ts.STAGE22_TRAINABLE) == (js.STAGE21_TRAINABLE, js.STAGE22_TRAINABLE)
    old, new = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)
    e = [_t(old)]
    tu.ema_update(e, [_t(new)], ts.EMA_DECAY)
    np.testing.assert_allclose(_np(e[0]), np.asarray(ju.ema_update({"w": old}, {"w": new}, ts.EMA_DECAY)["w"]),
                               rtol=1e-6)


def test_trainer_stage22_runs_and_warm_starts_from_stage1(tmp_path, capsys):
    """`python -m e3dge_torch.training.train`, in-process: a stage-1 run, then
    stage 2.2 warm-started from it (every switch of the stage-2.2 script):
    every file written, E0's
    parameters carried across unchanged (frozen; only its BN statistics move
    in train mode), the full-res D's lazy R1 at its first step only."""
    from e3dge_torch.training import train

    st1, st2 = tmp_path / "st1", tmp_path / "st22"
    assert train.main(["--tiny", "--iters", "1", "--batch", "2", "--device", "cpu", "--log-every", "1",
                       "--work-dir", str(st1)]) == 0
    assert train.main(["--stage", "2.2", "--tiny", "--iters", "2", "--batch", "2", "--device", "cpu",
                       "--adv-lambda", "0.01", "--d-reg-every", "2", "--ema", "--fix-ada", "--pose-curriculum",
                       "--log-every", "1", "--ckpt", str(st1 / "models_final"), "--work-dir", str(st2)]) == 0
    out = capsys.readouterr().out
    assert "warm-started from" in out and out.count("iter ") == 3
    for k in ("loss_e_adv", "res_loss", "d_r1"):
        assert f"'{k}'" in out, k
    assert "'d_r1': 0.0" in out.splitlines()[-2]  # step 1 of the D skips R1
    assert {p.name for p in st2.iterdir()} == {"models_final", "metrics.jsonl"}
    assert {p.name for p in (st2 / "models_final").iterdir()} == {"variables.pt", "state.pt", "d_state.pt"}
    e0_1, e0_2 = ({k: v for k, v in torch.load(d / "models_final" / "variables.pt", weights_only=True).items()
                   if k.startswith("encoder.")} for d in (st1, st2))
    assert all(torch.equal(e0_1[k], e0_2[k]) for k in e0_1 if "running_" not in k and "num_batches" not in k)
    ema = torch.load(st2 / "models_final" / "state.pt", weights_only=True)["ema"]
    assert {k.split(".")[0] for k in ema} == {"local", "fuse_sft_block"}  # --fix-ada: the aligner is frozen
    d_state = torch.load(st2 / "models_final" / "d_state.pt", weights_only=True)
    assert d_state["volume"] is None and d_state["full"]["step"] == 2 and d_state["full"]["d"]


def test_d_batch_producers(setup):
    """The trainer's D batches at tiny size: the full-res D's (reconstruction,
    sample) pair pooled to d_res, no gradient, the reconstruction not the
    sample; the volume D's real and fake thumbs with the fakes' (azim, elev)."""
    cfg, _, vs, (ml_r, ml_d), _, _ = setup
    tm = _port(tc.tiny_full_config(), vs)
    ml, gen = TLM(_t(ml_r), _t(ml_d)), torch.Generator().manual_seed(0)
    fakes, reals = ts.full_d_batch(tm, ml, B, 16, gen)
    assert fakes.shape == reals.shape == (B, 3, 16, 16) and not fakes.requires_grad
    assert float((fakes - reals).abs().mean()) > 1e-3
    real_th, fake_th, vp = ts.volume_d_batch(tm, ml, B, gen)
    res = cfg.renderer.out_im_res
    assert real_th.shape == fake_th.shape == (B, 3, res, res) and vp.shape == (B, 2)
    assert not torch.equal(real_th, fake_th) and bool(torch.isfinite(fake_th).all())
