"""Stage-1 training of the PyTorch port against the JAX package at
`tiny_test_config`, on the seeded variables of `test_torch_models.seeded_variables`
(NoiseInjection weights zero, so the two frameworks' decoder noise does not
matter) carried across by `state_dicts_from_jax`: the field kernel's grad guard
and the renderer's route to the twin, train-mode BatchNorm, z-jitter, the 3D
supervision samplers and the eikonal term, `synthetic_sample`, the perceptual
nets, the stage-1 step (loss, metrics, E0 gradients through the eikonal double
backward, BN running statistics) and the trainer entry point.

Tolerances: field outputs 3e-3 abs (tests/test_golden_oracle.py:40-41); conv
stacks 1e-4 of their scale (test_torch_models.py); running statistics 1e-5;
the step's metrics 1e-4 relative and each E0 gradient leaf 1e-3 relative L2 —
the step chains the encoder, field, decoder and two perceptual nets, each
summing in another order than XLA."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import conv_atol, seeded_variables

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.models.volume_renderer import eikonal_term as t_eikonal_term
from e3dge_torch.ops import siren_field as sf
from e3dge_torch.render.camera import CameraParams as TCam
from e3dge_torch.render.camera import camera_params_from_angles as t_cam
from e3dge_torch.render.rays import sample_z_vals as t_sample_z_vals
from e3dge_torch.training import perceptual as tp
from e3dge_torch.training import steps as ts
from e3dge_torch.utils.weights import batch_stats_to_jax, jax_path_to_torch, load_jax_variables, perceptual_state_dict_from_jax
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.models.volume_renderer import VolumeFeatureRenderer as JRenderer
from e3dge_tpu.models.volume_renderer import eikonal_term as j_eikonal_term
from e3dge_tpu.render.rays import sample_z_vals as j_sample_z_vals
from e3dge_tpu.training import perceptual as jp
from e3dge_tpu.training.steps import STAGE1_TRAINABLE, create_train_state, make_stage1_step
from e3dge_tpu.utils.torch_ckpt import flatten_tree, ingest_perceptual

REPO = Path(__file__).resolve().parents[1]
FIELD_ATOL, STAT_ATOL, METRIC_RTOL, GRAD_RTOL = 3e-3, 1e-5, 1e-4, 1e-3
# every stage-1 term on, LPIPS and ID included (scripts/train.py:52-54)
LAMBDAS = dict(l2_lambda=1.0, lpips_lambda=0.8, id_lambda=0.1, latent_gt_lambda=1.0, shape_surface_lambda=1.0,
               shape_normal_lambda=1.0, shape_uniform_lambda=0.2, eikonal_lambda=0.1)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return x.detach().float().numpy()


def _port(cfg, vs):
    m = TE3DGE(cfg, device="cpu")
    load_jax_variables(m, vs)
    return m


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work (imported by the
    stage-2 tests too): at these shapes more threads buy nothing alone, and in
    a parallel test run they oversubscribe the cores (a 2 s test took 139 s
    at 6 workers x 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tiny_test_setup):
    cfg, jmodel, variables, _ = tiny_test_setup
    vs = seeded_variables(variables)
    rng = np.random.RandomState(21)
    ml = ((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32),
          (0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32))
    return cfg, jmodel, vs, ml


def _jax(jmodel, vs, fn, *args):
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=fn, rngs={"noise": jax.random.key(9)}))(vs, *args)


# ------------------------------------------------------- grad guard and route


def test_field_kernel_refuses_grad_operands_on_any_device():
    """The kernel has no backward: under grad mode an operand that requires
    grad (a pack tensor too) raises, on the CPU as on the card; without grad
    mode, or with nothing requiring grad, the entry runs."""
    torch.manual_seed(0)
    net = _small_siren()
    b, n = 1, 16
    pts, dirs = torch.rand(b, n, 3), torch.rand(b, n, 3)
    styles = torch.randn(b, 3, 16)
    gamma, beta = net.film_vectors(styles)  # requires grad through the FiLM heads
    assert gamma.requires_grad
    pack = net.pack("highest")
    with pytest.raises(RuntimeError, match="no backward"):
        sf.siren_field_full(pts, dirs, pack, gamma, beta)
    with pytest.raises(RuntimeError, match="no backward"):
        sf.siren_field_full(pts.requires_grad_(), dirs, pack, gamma.detach(), beta.detach())
    with pytest.raises(RuntimeError, match="wst"):
        sf.siren_field_full(pts.detach(), dirs, {**pack, "wst": pack["wst"].clone().requires_grad_()},
                            gamma.detach(), beta.detach())
    raw_h = torch.rand(b, n, 32)
    with pytest.raises(RuntimeError, match="siren_field_tex has no backward"):
        sf.siren_field_tex(raw_h, dirs, pack, gamma[:, -1], beta[:, -1])
    with torch.no_grad():
        feat, rgb_sdf, _ = sf.siren_field_full(pts, dirs, pack, gamma, beta)
    feat2, _, _ = sf.siren_field_full(pts.detach(), dirs, pack, gamma.detach(), beta.detach())
    assert torch.equal(feat, feat2) and rgb_sdf.shape == (b, n, 4)


def _small_siren():
    from e3dge_torch.models.siren import SirenGenerator

    return SirenGenerator(2, 32, 16)


def test_grad_render_takes_the_twin_and_matches_the_kernel_route(setup):
    """A render that needs a gradient evaluates the twin by the renderer's
    rule (the kernel route would raise), agrees with the no-grad render at the
    field tolerance, launches nothing, and its gradient reaches the styles;
    remat_field changes nothing but memory."""
    cfg, _, vs, _ = setup
    tm = _port(tc.tiny_test_config(), vs)
    ren = tm.generator.renderer
    rng = np.random.RandomState(3)
    styles = _t(0.3 * rng.randn(2, cfg.renderer.depth + 1, cfg.renderer.style_dim))
    cam = t_cam(_t([0.1, -0.2]), _t([0.05, 0.0]), cfg.renderer.out_im_res, cfg.camera.fov_ang, cfg.camera.dist_radius)
    with torch.no_grad():
        assert not ren.needs_grad(styles)
        want = ren(cam, styles)
    ren.requires_grad_(False)
    assert not ren.needs_grad(styles) and ren.needs_grad(styles.clone().requires_grad_())
    s = styles.clone().requires_grad_()
    sf.reset_launch_counts()
    got = ren(cam, s)
    assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}
    for k in ("gen_thumb_imgs", "features", "sdf", "depth", "xyz", "hit_prob"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=FIELD_ATOL, err_msg=k)
    (g,) = torch.autograd.grad(got["gen_thumb_imgs"].square().sum() + got["features"].sum(), s)
    assert float(g.abs().max()) > 0 and bool(torch.isfinite(g).all())

    rm = _port(tc._with(tc.tiny_test_config(), renderer=dict(remat_field=True)), vs).generator.renderer
    rm.requires_grad_(False)
    s2 = styles.clone().requires_grad_()
    out2 = rm(cam, s2)
    (g2,) = torch.autograd.grad(out2["gen_thumb_imgs"].square().sum() + out2["features"].sum(), s2)
    torch.testing.assert_close(out2["gen_thumb_imgs"], got["gen_thumb_imgs"], rtol=0, atol=0)
    torch.testing.assert_close(g2, g, rtol=1e-6, atol=0)


def test_query_sdf_serves_by_default_and_trains_on_request(setup, monkeypatch):
    """`E3DGE.query_sdf` picks its route by `train=`, not by the ambient grad
    mode: on a fresh model (parameters requiring grad) under grad mode the
    default call takes the kernel route, no_grad; train=True takes the twin
    and is differentiable, with the same values."""
    cfg, _, vs, _ = setup
    tm = _port(tc.tiny_test_config(), vs)
    rng = np.random.RandomState(4)
    styles = _t(0.3 * rng.randn(2, cfg.renderer.depth + 1, cfg.renderer.style_dim))
    pts = _t(rng.uniform(-0.2, 0.2, (2, 5, 7, 3)))
    ren = tm.generator.renderer
    assert torch.is_grad_enabled() and all(p.requires_grad for p in ren.network.parameters())
    twin = ren._twin_field
    monkeypatch.setattr(ren, "_twin_field", lambda *a: pytest.fail("the serving query took the twin"))
    served = tm.query_sdf(pts, styles)
    assert served.shape == (2, 5, 7, 1) and not served.requires_grad
    monkeypatch.setattr(ren, "_twin_field", twin)
    trained = tm.query_sdf(pts, styles, train=True)
    assert trained.requires_grad and not tm.encoder.training
    np.testing.assert_allclose(_np(trained), _np(served), atol=FIELD_ATOL)


# ---------------------------------------------------------- train-mode BN


def test_train_mode_batchnorm_matches_flax(setup):
    """One train-mode E0 forward: outputs as JAX's encoder.apply(train=True),
    running statistics as its updated batch_stats (biased variance, momentum
    0.9); torch's built-in update (unbiased variance) would miss them."""
    cfg, jmodel, vs, _ = setup
    x = np.random.RandomState(4).randn(2, 3, cfg.encoder.input_res, cfg.encoder.input_res).astype(np.float32)
    fn = jax.jit(lambda v, a: jmodel.apply(v, a, method=lambda m, a: m.encoder(a, train=True, return_featmap=True),
                                          mutable=["batch_stats"]))
    want, mutated = fn(vs, jnp.asarray(x))
    tm = _port(tc.tiny_test_config(), vs)
    # the last block's output norm sees 2 x 4 x 4 values per channel, where
    # biased and unbiased variances differ by 1/31
    last_bn = tm.encoder.body[-1].res_layer[4]
    builtin = torch.nn.BatchNorm2d(last_bn.num_features, momentum=0.1)
    builtin.load_state_dict(last_bn.state_dict())
    seen = []
    hook = last_bn.register_forward_pre_hook(lambda mod, inp: seen.append(inp[0].detach()))
    tm.encoder.train()
    got = tm.encoder(_t(x), return_featmap=True)
    hook.remove()
    for i in range(2):
        ref = np.asarray(want["pred_latents"][i])
        np.testing.assert_allclose(_np(got["pred_latents"][i]), ref, atol=conv_atol(ref))
    np.testing.assert_allclose(_np(got["feat_maps"]), np.asarray(want["feat_maps"]), atol=conv_atol(want["feat_maps"]))
    want_stats = flatten_tree(jax.tree.map(np.asarray, mutated["batch_stats"]))
    got_stats = flatten_tree(batch_stats_to_jax(tm, {"encoder": mutated["batch_stats"]["encoder"]}))
    assert set(got_stats) == set(want_stats) and len(want_stats) > 100
    moved = 0
    for path, w in want_stats.items():
        np.testing.assert_allclose(got_stats[path], w, atol=STAT_ATOL, err_msg=path)
        moved += not np.allclose(w, flatten_tree(vs["batch_stats"])[path], atol=STAT_ATOL)
    assert moved == len(want_stats)
    # torch's own train mode folds the unbiased variance in: off by more than the tolerance
    with torch.no_grad():
        builtin.train()(seen[0])
    var_path = f"encoder/body_{len(tm.encoder.body) - 1}/bn2/bn/var"
    assert np.abs(builtin.running_var.numpy() - want_stats[var_path]).max() > 10 * STAT_ATOL


# --------------------------------------------------------------- z-jitter


@pytest.mark.parametrize("offset_sampling,jitter", [(True, "auto"), (True, "mids"), (False, "auto")])
def test_sample_z_vals_jitter_matches_jax(offset_sampling, jitter):
    b, h, w, s = 2, 3, 4, 6
    near = np.full((b, 1, 1), 0.88, np.float32)
    far = np.full((b, 1, 1), 1.12, np.float32)
    key = jax.random.key(5)
    want = j_sample_z_vals(key, jnp.asarray(near), jnp.asarray(far), (b, h, w), s, offset_sampling=offset_sampling,
                           perturb=True, jitter=jitter)
    shared = offset_sampling and jitter == "auto"
    u = jax.random.uniform(key, (b, h, w, 1) if shared else (b, h, w, s))
    got = t_sample_z_vals(_t(near), _t(far), (b, h, w), s, offset_sampling, perturb=True, jitter=jitter, u=_t(u))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    plain = t_sample_z_vals(_t(near), _t(far), (b, h, w), s, offset_sampling)
    assert float((got - plain).abs().max()) > 1e-3
    g = torch.Generator().manual_seed(0)
    drawn = t_sample_z_vals(_t(near), _t(far), (b, h, w), s, offset_sampling, perturb=True, jitter=jitter, generator=g)
    assert bool((drawn >= plain - 1e-6).all()) if shared else drawn.shape == plain.shape


# ----------------------------------------------- SDF samplers, eikonal term


def test_sdf_samplers_and_eikonal_term_match_jax(setup):
    cfg, jmodel, vs, _ = setup
    tm = _port(tc.tiny_test_config(), vs)
    ren = tm.generator.renderer
    r = cfg.camera.dist_radius
    rng = np.random.RandomState(6)
    styles = (0.3 * rng.randn(2, cfg.renderer.style_dim)).astype(np.float32)
    xyz = rng.uniform(-0.1, 0.1, (2, 5, 5, 3)).astype(np.float32)
    ku, kn = jax.random.key(11), jax.random.key(12)

    def jfn(m, s, p):
        jr = m.generator.renderer
        return jr.sample_uniform_grid(ku, 2, 300, s), jr.sample_near_surface_grid(kn, p, s, stdv=0.03)

    (ju, jn) = _jax(jmodel, vs, jfn, jnp.asarray(styles), jnp.asarray(xyz))
    with torch.no_grad():
        tu = ren.sample_uniform_grid(2, 300, _t(styles), pts=_t(jax.random.uniform(ku, (2, 300, 3), minval=-r, maxval=r)))
        tn = ren.sample_near_surface_grid(_t(xyz), _t(styles), stdv=0.03, noise=_t(jax.random.normal(kn, xyz.shape)))
    for got, want in ((tu, ju), (tn, jn)):
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-6)
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=FIELD_ATOL)
        np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    assert 0 < float(tn[2].mean()) < 1  # some near-surface points leave the box

    pts = rng.uniform(-0.1, 0.1, (2, 40, 3)).astype(np.float32)
    jr = JRenderer(cfg.renderer, camera_dist_radius=r)
    want = j_eikonal_term(jr.apply, {"params": vs["params"]["generator"]["renderer"]}, jnp.asarray(pts),
                          jnp.asarray(styles))
    got = t_eikonal_term(ren, _t(pts), _t(styles), create_graph=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FIELD_ATOL)
    assert float(got.norm(dim=-1).mean()) > 1e-2 and not got.requires_grad


# ------------------------------------------------------- synthetic samples


def _jax_draws(cfg, key, b):
    """JAX synthetic_sample's draws, split as e3dge.py:513 splits them."""
    kz, ka, ke, kn, ku, _ = jax.random.split(key, 6)
    res, r = cfg.renderer.out_im_res, cfg.camera.dist_radius
    draws = dict(
        z=jax.random.normal(kz, (b, cfg.renderer.style_dim)),
        azim=jax.random.normal(ka, (b,)),
        elev=jax.random.normal(ke, (b,)),
        near_noise=jax.random.normal(kn, (b, res, res, 3)),
        uniform_pts=jax.random.uniform(ku, (b, cfg.renderer.uniform_grid_sampling_num, 3), minval=-r, maxval=r),
    )
    return {k: _t(v) for k, v in draws.items()}


@pytest.mark.parametrize("pair_same_id", [False, True])
def test_synthetic_sample_matches_jax(setup, pair_same_id):
    cfg, jmodel, vs, _ = setup
    key = jax.random.key(2)
    want = jax.jit(lambda v: jmodel.apply(v, key, 2, 0.7, pair_same_id, method=JE3DGE.synthetic_sample,
                                          rngs={"noise": jax.random.key(3)}))(vs)
    tm = _port(tc.tiny_test_config(), vs)
    sf.reset_launch_counts()
    got = tm.synthetic_sample(2, 0.7, pair_same_id, draws=_jax_draws(cfg, key, 2))
    assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}  # the CPU runs the plain version
    assert tuple(got["images"].shape) == (2, 3, cfg.decoder.size, cfg.decoder.size)
    for k in ("images", "thumb_images", "xyz", "near_pts", "near_sdf", "uniform_pts", "uniform_sdf", "latent_gt",
              "depth", "sdf"):
        assert not got[k].requires_grad
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=FIELD_ATOL, err_msg=k)
    for k in ("near_valid", "uniform_valid", "mask"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    for f in ("poses", "viewpoint", "calibs"):
        np.testing.assert_allclose(_np(getattr(got["cam_settings"], f)), np.asarray(getattr(want["cam_settings"], f)),
                                   atol=1e-5)
    lat = _np(got["latent_gt"])
    assert np.allclose(lat[0], lat[1]) == pair_same_id  # odd/even share an identity only when paired
    g = torch.Generator().manual_seed(1)
    drawn = tm.synthetic_sample(2, 1.0, True, generator=g)
    assert drawn["uniform_pts"].abs().max() <= cfg.camera.dist_radius
    assert torch.equal(drawn["latent_gt"][0], drawn["latent_gt"][1])


def test_synthetic_sample_bf16_field_stays_near_f32(setup):
    """sample_field_dtype=bfloat16 (the serving precision for the frozen-GAN
    render) stays within test_training.py:150-168's bounds of the f32 sample;
    the SDF targets come from the f32 queries, so they are equal."""
    cfg, _, vs, _ = setup
    draws = _jax_draws(cfg, jax.random.key(2), 2)
    b32 = _port(tc.tiny_test_config(), vs).synthetic_sample(2, 1.0, True, draws=draws)
    b16 = _port(tc._with(tc.tiny_test_config(), renderer=dict(sample_field_dtype="bfloat16")), vs).synthetic_sample(
        2, 1.0, True, draws=draws)
    img_diff = (b16["images"] - b32["images"]).abs()
    assert float(img_diff.max()) < 0.3 and float(img_diff.mean()) < 0.03
    assert float((b16["sdf"] - b32["sdf"]).abs().max()) < 0.05
    assert float((b16["images"] - b32["images"]).abs().max()) > 0  # the bf16 field did run
    assert torch.equal(b16["uniform_sdf"], b32["uniform_sdf"])


# ---------------------------------------------------------- perceptual nets


def _seeded_sd(sd: dict, seed: int) -> dict:
    """Every float entry of a state dict redrawn at its own scale (weights
    N(0, 1/fan_in), norms' scales 1 + 0.1 N, shifts and means 0.1 N,
    variances U(0.5, 1.5))."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = v.clone()
        elif k.endswith("running_var"):
            out[k] = _t(rng.uniform(0.5, 1.5, v.shape))
        elif k.endswith(("running_mean", "bias")) or v.ndim == 1:
            out[k] = _t((1.0 if v.ndim == 1 and k.endswith("weight") else 0.0) + 0.1 * rng.randn(*v.shape))
        else:
            fan_in = int(np.prod(v.shape[1:]))
            out[k] = _t(np.abs(rng.randn(*v.shape)) if k.startswith("lin") else rng.randn(*v.shape) / np.sqrt(fan_in))
    return out


@pytest.fixture(scope="module")
def perceptual():
    """One seeded state dict per net, loaded strictly on both sides."""
    lp, idl = tp.make_perceptual_fns("cpu")
    sd_lp, sd_arc = _seeded_sd(lp.state_dict(), 1), _seeded_sd(idl.facenet.state_dict(), 2)
    lp, idl = tp.make_perceptual_fns("cpu", lpips_state_dict=sd_lp, arcface_state_dict=sd_arc)
    x = jnp.zeros((1, 3, 32, 32))
    jlp, jid = jp.LPIPS(), jp.IDLoss()

    def template(net):  # the variables' tree, traced only: ingestion fills every leaf
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(net.init, jax.random.key(0), x, x))

    v_lp = ingest_perceptual(template(jlp), {k: v.numpy() for k, v in sd_lp.items()}, "lpips", strict=True)[0]
    v_id = ingest_perceptual(template(jid), {k: v.numpy() for k, v in sd_arc.items()}, "arcface", strict=True)[0]
    jfns = (lambda p, t: jlp.apply(v_lp, p, t), lambda p, t: jid.apply(v_id, p, t))
    return (lp, idl), jfns, (sd_lp, sd_arc), (v_lp, v_id)


def test_lpips_and_id_loss_match_jax(perceptual):
    (lp, idl), (jlp, jid), (sd_lp, sd_arc), (v_lp, v_id) = perceptual
    # at 256^2 the ID loss pools the 188^2 face crop to 112^2 (the stage-1
    # test runs both nets at 32^2, where it pools up)
    rng = np.random.RandomState(8)
    a = rng.uniform(-1, 1, (2, 3, 256, 256)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    want_lp, want_id = jax.jit(lambda p, t: (jlp(p, t), jid(p, t)))(jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got_lp = lp(_t(a), _t(b))
        got_id = idl(_t(a), _t(b))
    np.testing.assert_allclose(float(got_lp), float(want_lp), rtol=1e-4, atol=1e-4)
    for g, w in zip(got_id, want_id):
        np.testing.assert_allclose(float(g), float(w), atol=1e-4)
    assert float(got_lp) > 1e-2 and 1e-3 < float(got_id[0]) < 2
    # the JAX nets' variables carried back give the same state dicts
    for sd, v, kind in ((sd_lp, v_lp, "lpips"), (sd_arc, v_id, "arcface")):
        back = perceptual_state_dict_from_jax(v, kind)
        assert set(back) == set(sd), kind
        for k in sd:
            torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ stage-1 step


def _capture():
    """An optax transformation that applies no update and keeps the incoming
    gradients as its state: the JAX step's gradients, from outside the step."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def _torch_batch(jbatch) -> dict:
    out = {}
    for k, v in jbatch.items():
        out[k] = TCam(*(_t(f) for f in v)) if k == "cam_settings" else _t(v)
    return out


@pytest.fixture(scope="module")
def stage1(setup, perceptual):
    """JAX's stage-1 step (one jit) with captured gradients, JAX's batch built
    as steps.py:280-289 builds it from the same rng, and the port's loss and
    gradients over that batch."""
    cfg, jmodel, vs, (ml_r, ml_d) = setup
    (lp, idl), (jlp, jid), _, _ = perceptual
    tx = _capture()
    state = create_train_state(vs, STAGE1_TRAINABLE, tx)
    step = jax.jit(make_stage1_step(jmodel, LAMBDAS, tx, lpips_fn=jlp, id_fn=jid), static_argnums=(3,))
    rng = jax.random.key(7)
    jml = JLM(jnp.asarray(ml_r), jnp.asarray(ml_d))
    new_state, metrics = step(state, jml, rng, 2)
    k_data, k_noise = jax.random.split(rng)
    jbatch = jax.jit(lambda v: jmodel.apply(v, k_data, 2, 1.0, method=JE3DGE.synthetic_sample,
                                            rngs={"noise": k_noise}))(vs)

    tm = _port(tc.tiny_test_config(), vs)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tstate = ts.create_train_state(tm, ts.STAGE1_TRAINABLE, 1e-3)
    loss, tmetrics, _ = ts.stage1_loss(tm, _torch_batch(jbatch), TLM(_t(ml_r), _t(ml_d)), LAMBDAS, lp, idl)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tstate.params.items()}
    stats = batch_stats_to_jax(tm, {"encoder": new_state.extra["batch_stats"]["encoder"]})
    ts.optimizer_step(tstate)
    return dict(metrics=metrics, new_state=new_state, tm=tm, tmetrics=tmetrics, grads=grads, stats=stats,
                before=before, jbatch=jbatch, ml=(ml_r, ml_d), state=tstate)


def test_stage1_metrics_match_jax(stage1):
    want, got = stage1["metrics"], stage1["tmetrics"]
    assert set(got) == set(want)
    for k in ("loss_lpips", "loss_id", "latent_gt", "sdf_rec_loss", "surf_rec_loss", "surface_norm_rec_loss",
              "eikonal_term", "thumb_rec"):
        assert float(want[k]) > 1e-6, k  # every term is live
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(w), rtol=METRIC_RTOL, err_msg=k)


def test_stage1_encoder_gradients_match_jax(stage1):
    """Every E0 gradient leaf (the eikonal double backward included) within
    1e-3 relative L2 of JAX's; the frozen modules get none."""
    want = flatten_tree(jax.tree.map(np.asarray, {"params": stage1["new_state"].opt_state}))
    grads = stage1["grads"]
    assert set(k.split(".")[0] for k in grads) == {"encoder"}
    checked = 0
    for path, w in want.items():
        top, (key, transform) = jax_path_to_torch(path)
        assert top == "encoder", path
        g, w = _np(grads[f"encoder.{key}"]), transform(w)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err < GRAD_RTOL, f"{path}: relative L2 error {err:.2e}"
        checked += 1
    assert checked == len(grads) and checked > 100
    assert all(p.grad is None for n, p in stage1["tm"].named_parameters() if not n.startswith("encoder."))


def test_stage1_eikonal_term_reaches_the_encoder(setup, stage1):
    """The eikonal term alone, differentiated again through the double
    backward, gives E0 a gradient."""
    _, _, vs, ml = setup
    tm = _port(tc.tiny_test_config(), vs)
    ts.split_params(tm, ts.STAGE1_TRAINABLE)
    b = _torch_batch(stage1["jbatch"])
    out = tm.image2image_global(b["images"], TLM(*(_t(m) for m in ml)), b["cam_settings"], train=True)
    pred_eik = t_eikonal_term(tm.generator.renderer, b["near_pts"], out["pred_latents"][0], create_graph=True)
    assert pred_eik.requires_grad
    ((pred_eik.norm(dim=-1) - 1.0) ** 2).mean().backward()
    assert sum(float(p.grad.abs().sum()) for p in tm.encoder.parameters() if p.grad is not None) > 0


def test_stage1_batchnorm_stats_and_frozen_modules(stage1):
    want = flatten_tree(jax.tree.map(np.asarray, {"encoder": stage1["new_state"].extra["batch_stats"]["encoder"]}))
    got = flatten_tree(stage1["stats"])
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=STAT_ATOL, err_msg=path)
    # after the optimizer step: E0 moved, everything else bit-identical
    tm, before = stage1["tm"], stage1["before"]
    after = tm.state_dict()
    assert any(not torch.equal(after[k], before[k]) for k in before if k.startswith("encoder.") and "running" not in k)
    for k in before:
        if not k.startswith("encoder."):
            assert torch.equal(after[k], before[k]), k
    assert stage1["state"].step == 1 and not tm.encoder.training


def test_stage1_remat_field_gives_equal_loss_and_grads(setup, perceptual, stage1):
    """remat_field recomputes the twin in the backward: loss and gradients as
    without it (tests/test_training.py:171-193)."""
    cfg, _, vs, (ml_r, ml_d) = setup
    (lp, idl), *_ = perceptual
    out = []
    for remat in (False, True):
        tm = _port(tc._with(tc.tiny_test_config(), renderer=dict(remat_field=remat)), vs)
        ts.split_params(tm, ts.STAGE1_TRAINABLE)
        loss, _, _ = ts.stage1_loss(tm, _torch_batch(stage1["jbatch"]), TLM(_t(ml_r), _t(ml_d)), LAMBDAS, lp, idl)
        loss.backward()
        out.append((float(loss.detach()), [p.grad.clone() for p in tm.encoder.parameters()]))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-9)


# ------------------------------------------------------------------ trainer


def test_trainer_entry_point_runs_and_saves_e0(tmp_path):
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "e3dge_torch.training.train", "--tiny", "--iters", "2", "--batch", "2",
         "--device", "cpu", "--log-every", "1", "--work-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("iter ") == 2 and "eikonal_term" in proc.stdout
    variables = torch.load(tmp_path / "models_final" / "variables.pt", weights_only=True)
    sd = {k.removeprefix("encoder."): v for k, v in variables.items() if k.startswith("encoder.")}
    want = TE3DGE(tc.tiny_test_config(), device="cpu").encoder.state_dict()
    assert set(sd) == set(want)
    assert all(sd[k].shape == want[k].shape for k in want)


def test_trainer_mean_latents_use_the_jax_trainers_sample_count(tmp_path, monkeypatch):
    """The trainer averages as many mapping samples for its mean latents as
    the JAX trainer (`scripts/train.py`, read from its source)."""
    import re

    from e3dge_torch.training import train

    src = (REPO / "scripts" / "train.py").read_text()
    want = {int(n) for n in re.findall(r"jax\.random\.key\(\d+\), (\d+), method=E3DGE\.mean_latent", src)}
    assert len(want) == 1, want
    asked = []
    real = TE3DGE.mean_latent

    def recording(self, n=10000, generator=None):
        asked.append(n)
        return real(self, n, generator)

    monkeypatch.setattr(TE3DGE, "mean_latent", recording)
    assert train.main(["--tiny", "--iters", "0", "--device", "cpu", "--work-dir", str(tmp_path)]) == 0
    assert asked == [want.pop()]

def test_train_utils_match_jax():
    from e3dge_torch.training import train_utils as tu
    from e3dge_tpu.training import train_utils as ju

    fresh = {"e0": torch.zeros(3, 3), "e1": torch.zeros(4), "fusion": torch.zeros(2, 2)}
    ckpt = {"e0": torch.ones(3, 3), "e1": torch.ones(7), "extra": torch.ones(9)}
    merged, loaded, skipped = tu.warm_start_merge(fresh, ckpt)
    assert (loaded, skipped) == (1, 1) and set(merged) == set(fresh)
    assert float(merged["e0"].min()) == 1.0 and float(merged["e1"].abs().max()) == 0.0
    shapes = [tuple(n.shape) for n in tu.make_noise(32, 8, 2, torch.Generator().manual_seed(0))]
    assert shapes == [tuple(n.shape) for n in ju.make_noise(jax.random.key(0), 32, 8, 2)]
    e, p = [torch.zeros(3)], [torch.ones(3)]
    tu.ema_update(e, p, 0.9)
    np.testing.assert_allclose(e[0].numpy(), np.asarray(ju.ema_update({"w": jnp.zeros(3)}, {"w": jnp.ones(3)}, 0.9)["w"]),
                               rtol=1e-6)
    z = tu.make_pair_same_noise(4, 5, torch.Generator().manual_seed(0))
    assert torch.equal(z[0], z[1]) and torch.equal(z[2], z[3]) and not torch.equal(z[0], z[2])
    assert len(tu.mixing_noise(2, 5, 1.0, torch.Generator().manual_seed(0))) == 2
    assert len(tu.mixing_noise(2, 5, 0.0, torch.Generator().manual_seed(0))) == 1
