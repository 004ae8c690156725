"""The stage-2 cycle step with the "bn" netLocal
(`pifu.netLocal_type="HGPIFuNetGANResidual"`, stage2.2.sh's netLocal_type:
BatchNorm context convs, a zero-init EqualLinear texture head) against the
JAX package at `tiny_full_config`, B=2, every switch on, as
test_torch_cycle.py holds the released variant; and the same step across 2
gloo ranks against one rank at the global batch, as test_torch_parallel.py
holds E0's BatchNorm.

JAX's EqualLinear head cannot take the tuple (fused features, PE) that its
`que_render_given_ref` passes to `tex_modulations` (`x.shape` of a tuple),
so JAX's cycle step with this variant raises as shipped. The JAX side here
runs with `LocalFeatureNet.tex_modulations` patched, for this file's
fixture only, to concatenate a tuple first: the head on the concatenation,
which is what the port's head computes on the tuple.

Tolerances are test_torch_cycle.py's and test_torch_parallel.py's: metrics
1e-4 relative (a batch std, 1e-4 of its score), the gradient 3e-3 relative L2 as a whole and 2e-2 per leaf,
BatchNorm running statistics 1e-5; across ranks the loss 1e-4 relative.
Control across ranks: the local net's BatchNorm statistics taken per rank
(the sync off) miss the one-rank statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cycle import (B, CYCLE_GRAD_RTOL, CYCLE_LEAF_RTOL, D_LAMBDAS, DISC_WEIGHT_MAX, D_RES, LAMBDAS,
                              _compiled, _port_d, leaf_errors)
from test_torch_models import seeded_variables
from test_torch_training import (METRIC_RTOL, STAT_ATOL, _capture, _np, _t, _torch_batch,
                                 one_torch_thread)  # noqa: F401 (autouse)

from e3dge_torch import config as tc
from e3dge_torch.models.discriminator import Discriminator
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.parallel import launch, mesh
from e3dge_torch.training import steps as ts
from e3dge_torch.utils.weights import batch_stats_to_jax, init_weights, jax_path_to_torch, load_jax_variables
from e3dge_tpu.models.discriminator import Discriminator as JDisc
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.models.pifu import local_net as jln
from e3dge_tpu.training import steps as js
from e3dge_tpu.utils import config as jc
from e3dge_tpu.utils.torch_ckpt import flatten_tree

BN = dict(netLocal_type="HGPIFuNetGANResidual")
RANKS_TIMEOUT, LOSS_RTOL, RANK_B, RANK_SEED = 240.0, 1e-4, 4, 8
# test_torch_parallel.py's cycle lambdas: the adaptive D weight under its clip of 1
RANK_LAMBDAS = dict(l2_lambda=0.1, res_lambda=1.0, adv_lambda=0.1, hit_prob_consistency_lambda=0.1,
                    depth_lambda=0.1)


def _jax_tex_modulations_on_tuples():
    """JAX's LocalFeatureNet.tex_modulations with a tuple concatenated first."""
    orig = jln.LocalFeatureNet.tex_modulations

    def tex(self, local_feats):
        if isinstance(local_feats, tuple):
            local_feats = jnp.concatenate(local_feats, axis=-1)
        return orig(self, local_feats)

    return tex


@pytest.fixture(scope="module")
def bn_cycle():
    """JAX's cycle step of the bn model (one jit, every switch on) with
    captured gradients, its batch, and the port's `cycle_loss` over that
    batch with its gradients and BN statistics."""
    cfg = jc._with(jc.tiny_full_config(), pifu=BN).validate()
    jmodel = JE3DGE(cfg)
    L = cfg.pifu.load_size
    ml0 = JLM(jnp.zeros((1, cfg.renderer.depth + 1, cfg.renderer.style_dim)),
              jnp.zeros((1, cfg.decoder.n_latent, cfg.decoder.style_dim)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jln.LocalFeatureNet, "tex_modulations", _jax_tex_modulations_on_tuples())
        variables = jax.jit(jmodel.init)({"params": jax.random.key(0), "noise": jax.random.key(1)},
                                         jnp.zeros((2, 3, L, L)), ml0)
        vs = seeded_variables(variables)
        # as test_torch_cycle.py: the depth context conv sees the near-flat
        # depth's relief, not its offset
        k = vs["params"]["local"]["depth_conv"]["conv_in"]["conv"]["kernel"]
        vs["params"]["local"]["depth_conv"]["conv_in"]["conv"]["kernel"] = k - k.mean(axis=(0, 1, 2), keepdims=True)
        rng = np.random.RandomState(21)
        ml = ((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32),
              (0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32))
        jd = JDisc(input_size=D_RES, channel_base=16)
        d_params = seeded_variables(jax.jit(jd.init)(jax.random.key(3), jnp.zeros((B, 3, D_RES, D_RES))),
                                    seed=5)["params"]
        tx = _capture()
        state = js.create_train_state(vs, js.STAGE22_TRAINABLE, tx, ema=True)
        _, d_apply = js.make_full_d_step(jd, D_LAMBDAS, tx)
        fn = js.make_cycle_step(jmodel, LAMBDAS, tx, use_ref_view_weight=True, d_apply=d_apply,
                                adaptive_d_loss=True, disc_weight_max=DISC_WEIGHT_MAX)
        rng_key, jml = jax.random.key(7), JLM(jnp.asarray(ml[0]), jnp.asarray(ml[1]))
        new_state, metrics = _compiled(fn, state, jml, rng_key, B, d_params, static_argnums=(3,))(
            state, jml, rng_key, d_params)
        k_data, k_noise = jax.random.split(rng_key)
        jbatch = _compiled(lambda v: jmodel.apply(v, k_data, B, 1.0, True, method=JE3DGE.synthetic_sample,
                                                  rngs={"noise": k_noise}), vs)(vs)

    tm = TE3DGE(tc._with(tc.tiny_full_config(), pifu=BN).validate(), device="cpu")
    load_jax_variables(tm, vs)
    assert tm.local.variant == "bn"
    tstate = ts.create_train_state(tm, ts.STAGE22_TRAINABLE, 1e-3, ema=True)
    probe = [p for k, p in tstate.params.items() if k.startswith("local.")]
    d = _port_d(d_params).requires_grad_(False)
    loss, tmetrics, _ = ts.cycle_loss(tm, _torch_batch(jbatch), TLM(_t(ml[0]), _t(ml[1])), LAMBDAS,
                                      use_ref_view_weight=True, d_fn=d, adaptive_params=probe,
                                      disc_weight_max=DISC_WEIGHT_MAX)
    loss.backward()
    return dict(metrics=metrics, new_state=new_state, tmetrics=tmetrics, vs=vs, tm=tm,
                grads={k: p.grad.clone() for k, p in tstate.params.items()},
                stats=batch_stats_to_jax(tm, new_state.extra["batch_stats"]))


def test_bn_cycle_metrics_and_gradients_match_jax(bn_cycle):
    """Every metric within METRIC_RTOL (the adaptive weight CYCLE_GRAD_RTOL),
    every term live; the gradient of every trainable leaf (the local net's
    BatchNorm scales and shifts and its EqualLinear head included) within
    CYCLE_GRAD_RTOL as a whole and CYCLE_LEAF_RTOL per leaf."""
    want, got = bn_cycle["metrics"], bn_cycle["tmetrics"]
    assert set(got) == set(want)
    for k in ("loss_e_adv", "d_weight", "thumb_rec", "res_loss", "hit_prob_consistency"):
        assert float(want[k]) > 1e-6, k
    for k, w in want.items():
        rtol = CYCLE_GRAD_RTOL if k == "d_weight" else METRIC_RTOL
        # a batch std of two near-equal scores (ssim_std 2.4e-3 of ssim 0.6)
        # inherits its score's absolute error
        atol = METRIC_RTOL * abs(float(want[k[:-4]])) if k.endswith("_std") else 1e-7
        np.testing.assert_allclose(float(got[k].detach()), float(w), rtol=rtol, atol=atol, err_msg=k)
    ref = {}
    for path, w in flatten_tree(jax.tree.map(np.asarray, {"params": bn_cycle["new_state"].opt_state})).items():
        top, (key, transform) = jax_path_to_torch(path)
        ref[f"{top}.{key}"] = transform(w)
    assert any(".1.conv.0.weight" in k for k in ref) and "local.local_feat_to_tex_modulations_linear.weight" in ref
    assert set(ref) == set(bn_cycle["grads"])
    whole, leaf = leaf_errors({k: _np(bn_cycle["grads"][k]) for k in ref}, ref)
    worst = max(leaf, key=leaf.get)
    print(f"bn cycle gradient vs JAX: relative L2 {whole:.3e} as a whole, worst leaf {leaf[worst]:.3e} at {worst}")
    assert whole < CYCLE_GRAD_RTOL and leaf[worst] < CYCLE_LEAF_RTOL, f"{worst}: {leaf[worst]:.2e}"


def test_bn_cycle_batchnorm_statistics_match_jax(bn_cycle):
    """E0's, the aligner's and the local net's BatchNorms run on batch
    statistics in the step (the local net's through the ref and the query
    filters): their running statistics afterwards are JAX's, and moved."""
    want = flatten_tree(jax.tree.map(np.asarray, bn_cycle["new_state"].extra["batch_stats"]))
    got = flatten_tree(bn_cycle["stats"])
    start = flatten_tree(bn_cycle["vs"]["batch_stats"])
    assert set(got) == set(want) and {p.split("/")[0] for p in want} == {"encoder", "grid_align", "local"}
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=STAT_ATOL, err_msg=path)
        assert not np.allclose(w, start[path], atol=STAT_ATOL), path
    assert not bn_cycle["tm"].local.training


# ------------------------------------------------------------ across ranks


def _bn_cycle_rank(world, sync: bool = True) -> dict:
    """One cycle step of the seeded bn model (the full-res D's term with the
    adaptive weight) at the global batch RANK_B from RANK_SEED: the ranks'
    mean loss, the averaged gradients and the local net's BN statistics;
    with sync False the BatchNorms take each rank's own statistics."""
    cfg = tc._with(tc.tiny_full_config(), pifu=BN).validate()
    model = TE3DGE(cfg, device=world.device)
    init_weights(model, 0)
    rng = np.random.RandomState(21)
    ml = TLM(torch.from_numpy((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)),
             torch.from_numpy((0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32)))
    d = Discriminator(32, channel_base=16)
    init_weights(d, 3)
    d.requires_grad_(False)
    mesh.replicate(model, world)
    state = ts.create_train_state(model, ts.STAGE22_TRAINABLE, 1e-3)
    grads = {}
    orig = mesh.all_reduce_grads

    def recording(params, w):
        params = list(params)
        orig(params, w)
        grads.update({k: p.grad.numpy().copy() for k, p in zip(state.params, params)})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "all_reduce_grads", recording)
        if not sync:
            mp.setattr(mesh, "mean_over_ranks", lambda x: x)
        m = ts.make_cycle_step(model, RANK_LAMBDAS, state, d_fn=d, adaptive_d_loss=True, world=world)(
            ml, RANK_B, torch.Generator().manual_seed(RANK_SEED))
    return {"loss": float(m["loss"]), "grads": grads,
            "stats": {k: v.numpy().copy() for k, v in model.local.state_dict().items() if "running_" in k}}


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """(2 ranks, 2 ranks with the BN sync off, one rank)."""
    def spawn(sync):
        return launch.spawn(_bn_cycle_rank, 2, sync, timeout=RANKS_TIMEOUT, device="cpu",
                            rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))
    return spawn(True), spawn(False), _bn_cycle_rank(mesh.World())


def test_bn_cycle_across_ranks_matches_one_rank(rank_runs):
    """2 ranks at a global B=4 against one rank: the loss within LOSS_RTOL,
    the averaged gradient within CYCLE_GRAD_RTOL as a whole and
    CYCLE_LEAF_RTOL per leaf, the local net's BN running statistics (the
    global batch's, synced over the dp group) within STAT_ATOL on both
    ranks; with the sync off they miss."""
    ranks, unsynced, one = rank_runs
    assert len(one["stats"]) == 8
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=LOSS_RTOL)
        whole, leaf = leaf_errors(r["grads"], one["grads"])
        worst = max(leaf, key=leaf.get)
        print(f"bn cycle across 2 ranks: gradient relative L2 {whole:.3e} whole, worst leaf {leaf[worst]:.3e} at "
              f"{worst}")
        assert whole < CYCLE_GRAD_RTOL and leaf[worst] < CYCLE_LEAF_RTOL
        for k, w in one["stats"].items():
            np.testing.assert_allclose(r["stats"][k], w, atol=STAT_ATOL, err_msg=k)
    gap = max(float(np.abs(unsynced[0]["stats"][k] - w).max()) for k, w in one["stats"].items())
    print(f"local BN statistics with the sync off: {gap:.3e} from one rank's")
    assert gap > 10 * STAT_ATOL
