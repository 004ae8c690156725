"""The config-selected variants of the PyTorch port against the JAX package:
the "bn" netLocal (`pifu.netLocal_type="HGPIFuNetGANResidual"`: BatchNorm
context convs, a zero-init EqualLinear texture head) with the optional heads
(geometry modulations, the SurfaceClassifier of the netLocal pretraining,
`netlocal_pretrain_loss`) and its weights carried across at the keys JAX
ingests; the raw-density renderer (`renderer.with_sdf=False`); and
`utils/options_compat.py`, by which a reference user's flags select them
(`--netLocal_type HGPIFuNetGANResidual`, `--no_sdf`).

Tolerances: conv stacks 1e-4 of their scale (test_torch_models.py), BatchNorm
running statistics 1e-5 (test_torch_training.py), field outputs 3e-3 abs and
`gen_imgs` 1e-3 abs (test_torch_pipeline.py), the pretraining loss 1e-5
relative (a few f32 reductions)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import conv_atol, seeded_variables

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.models.pifu.local_net import LocalFeatureNet as TLocal
from e3dge_torch.ops import siren_field as sf
from e3dge_torch.render.camera import camera_params_from_angles as t_cam
from e3dge_torch.training import steps as ts
from e3dge_torch.utils import options_compat as to
from e3dge_torch.utils.weights import batch_stats_to_jax, jax_path_to_torch, load_jax_variables, state_dicts_from_jax
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.models.pifu.local_net import LocalFeatureNet as JLocal
from e3dge_tpu.render.camera import camera_params_from_angles as j_cam
from e3dge_tpu.training import steps as js
from e3dge_tpu.utils import config as jc
from e3dge_tpu.utils import options_compat as jo
from e3dge_tpu.utils.torch_ckpt import flatten_tree, flax_path_to_torch

STAT_ATOL, FIELD_ATOL, IMG_ATOL = 1e-5, 3e-3, 1e-3


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return x.detach().float().numpy()


def _local_pair(cfg, seed, **heads):
    """JAX's and the port's LocalFeatureNet of cfg with the same seeded
    variables (the JAX init's tree, redrawn), the port's loaded strictly."""
    kw = dict(modulation_width=cfg.renderer.width, local_feats_dim=cfg.renderer.residual_local_feats_dim)
    jnet = JLocal(cfg.pifu, **kw, **heads)
    L = cfg.pifu.load_size
    v = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((2, 3, L, L)), jnp.zeros((2, 1, L, L)),
                           jnp.zeros((2, 3, 5)), jnp.tile(jnp.eye(4)[None], (2, 1, 1)))
    vs = seeded_variables({k: {"local": t} for k, t in v.items()}, seed=seed)
    tnet = TLocal(cfg.pifu, **kw, **heads)
    tnet.load_state_dict(state_dicts_from_jax(vs)["local"], strict=True)
    return jnet, {k: t["local"] for k, t in vs.items()}, tnet, vs


# ------------------------------------------------------------- the bn netLocal


def test_local_net_bn_variant_matches_jax():
    """tests/test_local_branch.py:58's net at tiny_full_config: BatchNorm
    context convs (running statistics exist, every leaf has a torch key, the
    same one JAX ingests) and the zero-init EqualLinear texture head; on
    seeded weights the train-mode filter (batch statistics, running
    statistics folded in as flax does) and the eval-mode filter match JAX's,
    and so does the texture head, on an array and on the tuple of parts
    `que_render_given_ref` passes (their concatenation)."""
    cfg = tc.tiny_full_config()
    fresh = TLocal(cfg.pifu, cfg.renderer.width, cfg.renderer.residual_local_feats_dim, variant="bn")
    assert float(fresh.local_feat_to_tex_modulations_linear.weight.detach().abs().max()) == 0.0
    assert any("running_var" in k for k in fresh.state_dict())
    jnet, v, tnet, vs = _local_pair(jc.tiny_full_config(), seed=3, variant="bn")
    assert set(v["params"]["local_feat_to_tex_modulations"]) == {"weight", "bias"}
    for path in flatten_tree(vs):
        assert flax_path_to_torch(path)[0] == jax_path_to_torch(path)[1][0], path

    rng = np.random.RandomState(5)
    L = cfg.pifu.load_size
    res = rng.randn(2, 3, L, L).astype(np.float32)
    # a depth with relief: flax's one-pass variance E[x^2] - E[x]^2 of a
    # near-flat map cancels to a few digits (test_torch_cycle.py's setup)
    depth = rng.uniform(-1.0, 1.0, (2, 1, L, L)).astype(np.float32)
    want, mutated = jax.jit(lambda vv, a, b: jnet.apply(vv, a, b, True, method=JLocal.filter,
                                                        mutable=["batch_stats"]))(v, res, depth)
    tnet.train()
    got = tnet.filter(_t(res), _t(depth))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))

    class Holder(torch.nn.Module):  # batch_stats_to_jax reads the model's top modules
        def __init__(self, local):
            super().__init__()
            self.local = local

    got_stats = flatten_tree(batch_stats_to_jax(Holder(tnet), {"local": mutated["batch_stats"]}))
    want_stats = flatten_tree(jax.tree.map(np.asarray, {"local": mutated["batch_stats"]}))
    start = flatten_tree({"local": v["batch_stats"]})
    assert set(got_stats) == set(want_stats) and len(want_stats) == 8  # 2 convs x 2 norms x (mean, var)
    for path, w in want_stats.items():
        np.testing.assert_allclose(got_stats[path], w, atol=STAT_ATOL, err_msg=path)
        assert not np.allclose(w, start[path], atol=STAT_ATOL), path

    tnet.eval()  # on the running statistics the train-mode call left
    want = jax.jit(lambda vv, a, b: jnet.apply(vv, a, b, method=JLocal.filter))(
        {"params": v["params"], **mutated}, res, depth)
    with torch.no_grad():
        got = tnet.filter(_t(res), _t(depth))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))

    a = rng.randn(2, 5, cfg.pifu.hourglass_dim).astype(np.float32)
    pe = rng.randn(2, 5, 45).astype(np.float32)
    want = jax.jit(lambda vv, x: jnet.apply(vv, x, method=JLocal.tex_modulations))(v, np.concatenate([a, pe], -1))
    with torch.no_grad():
        got = tnet.tex_modulations((_t(a), _t(pe)))
        got_cat = tnet.tex_modulations(torch.cat([_t(a), _t(pe)], -1))
    for g, gc, w in zip(got, got_cat, want):
        assert g.shape == (2, 5, cfg.renderer.width)
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=conv_atol(w))
        torch.testing.assert_close(g, gc, rtol=0, atol=0)


def test_surface_classifier_geo_modulations_and_pretrain_loss_match_jax():
    """tests/test_local_branch.py:156's net (tiny_test_config, the geometry
    head and the SurfaceClassifier on): `predict_sdf` [1, 7, 1] masked to the
    in-image points and `geo_modulations` match JAX's on seeded weights, the
    fresh geometry head is zero, and `netlocal_pretrain_loss` (with and
    without the eikonal term) is JAX's."""
    cfg = tc.tiny_test_config()
    heads = dict(enable_geo_modulations=True, enable_surface_classifier=True)
    fresh = TLocal(cfg.pifu, cfg.renderer.width, cfg.pifu.hourglass_dim + 45, **heads)
    assert float(fresh.local_feat_to_geo_modulations_linear.weight.detach().abs().max()) == 0.0
    jcfg = jc.tiny_test_config()
    jnet = JLocal(jcfg.pifu, modulation_width=jcfg.renderer.width, local_feats_dim=jcfg.pifu.hourglass_dim + 45,
                  **heads)
    rng = np.random.RandomState(6)
    res = rng.randn(1, 3, 32, 32).astype(np.float32)
    depth = rng.randn(1, 1, 32, 32).astype(np.float32)
    cam_args = (np.array([0.1], np.float32), np.array([0.0], np.float32), 32)
    pts = (0.05 * rng.randn(1, 3, 7)).astype(np.float32)
    pts[0, :, 0] = [0.5, 0.0, 0.0]  # one point outside the image
    v = jnet.init(jax.random.key(3), res, depth, pts, j_cam(*map(jnp.asarray, cam_args[:2]), 32).calibs)
    vs = seeded_variables({k: {"local": t} for k, t in v.items()}, seed=4)
    v = {k: t["local"] for k, t in vs.items()}
    tnet = TLocal(cfg.pifu, cfg.renderer.width, cfg.pifu.hourglass_dim + 45, **heads)
    tnet.load_state_dict(state_dicts_from_jax(vs)["local"], strict=True)

    jcam = j_cam(*map(jnp.asarray, cam_args[:2]), 32)
    im_feat = jnet.apply(v, res, depth, method=JLocal.filter)
    want = jnet.apply(v, im_feat, pts, jcam.calibs, method=JLocal.predict_sdf)
    with torch.no_grad():
        got = tnet.predict_sdf(_t(im_feat), _t(pts), t_cam(_t(cam_args[0]), _t(cam_args[1]), 32).calibs)
    assert got.shape == (1, 7, 1) and float(got[0, 0, 0]) == 0.0 and float(got.abs().max()) > 0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))
    feats = rng.randn(1, 5, cfg.pifu.hourglass_dim + 45).astype(np.float32)
    want = jnet.apply(v, feats, method=JLocal.geo_modulations)
    with torch.no_grad():
        got = tnet.geo_modulations(_t(feats))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=conv_atol(w))

    surf, uni, gt = (rng.randn(2, 40, 1).astype(np.float32) * s for s in (0.1, 1.5, 1.5))
    eik = rng.randn(2, 40, 3).astype(np.float32)
    lam = dict(surf_sdf_lambda=2.0, uniform_pts_sdf_lambda=0.5, eikonal_lambda=0.1)
    for e in (None, eik):
        want = js.netlocal_pretrain_loss(jnp.asarray(surf), jnp.asarray(uni), jnp.asarray(gt),
                                         None if e is None else jnp.asarray(e), lam)
        got = ts.netlocal_pretrain_loss(_t(surf), _t(uni), _t(gt), None if e is None else _t(e), lam)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_e3dge_builds_the_netlocal_the_config_names():
    """`pifu.netLocal_type` picks the variant, as JAX's E3DGE; the bn net's
    BatchNorms run in train mode inside a training call only."""
    bn = tc._with(tc.tiny_full_config(), pifu=dict(netLocal_type="HGPIFuNetGANResidual"))
    m = TE3DGE(bn, device="cpu")
    assert m.local.variant == "bn" and not m.local.training
    assert TE3DGE(tc.tiny_full_config(), device="cpu").local.variant == "resnetfc"
    seen = []
    m.local.residual_conv[1].conv[0].register_forward_pre_hook(lambda mod, inp: seen.append(mod.training))
    imgs = torch.zeros(2, 3, bn.pifu.load_size, bn.pifu.load_size)
    ml = TLM(torch.zeros(1, bn.renderer.depth + 1, bn.renderer.style_dim),
             torch.zeros(1, bn.decoder.n_latent, bn.decoder.style_dim))
    m.encode_ref_images(imgs, ml)
    m.encode_ref_images(imgs, ml, train=True)
    assert seen == [False, True] and not m.local.training


# ------------------------------------------------------- the raw-density renderer


@pytest.fixture(scope="module")
def raw_density(tiny_full_setup):
    """tiny_full_config with with_sdf=False on both sides: the seeded
    variables without `sigmoid_beta`, which neither renderer registers."""
    _, _, variables, _ = tiny_full_setup
    vs = seeded_variables(variables)
    del vs["params"]["generator"]["renderer"]["sigmoid_beta"]
    # the seeded sdf head (|w| <= 0.024) gives densities within ~0.1 of each
    # other, which beta = 1 integrates into weights flat along the ray and a
    # depth map flat to 1e-4, whose InstanceNorm in the depth context conv
    # then reads the rounding of a constant: the head is scaled so the
    # density varies on beta's scale (depth relief ~3e-3, the SDF render's),
    # and a zero-mean first depth kernel gives the depth's offset no response
    # (as test_torch_cycle.py's setup)
    net = vs["params"]["generator"]["renderer"]["network"]
    net["sigma_linear"]["weight"] = 30.0 * net["sigma_linear"]["weight"]
    k = vs["params"]["local"]["depth_conv"]["conv_in"]["conv"]["kernel"]  # HWIO
    vs["params"]["local"]["depth_conv"]["conv_in"]["conv"]["kernel"] = k - k.mean(axis=(0, 1, 2), keepdims=True)
    tcfg = tc._with(tc.tiny_full_config(), renderer=dict(with_sdf=False)).validate()
    jcfg = jc._with(jc.tiny_full_config(), renderer=dict(with_sdf=False)).validate()
    tm = TE3DGE(tcfg, device="cpu")
    load_jax_variables(tm, vs)
    rng = np.random.RandomState(12)
    L = tcfg.pifu.load_size
    x = (0.3 * rng.randn(2, 3, L, L)).astype(np.float32)
    ml = ((0.2 * rng.randn(1, tcfg.renderer.depth + 1, tcfg.renderer.style_dim)).astype(np.float32),
          (0.2 * rng.randn(1, tcfg.decoder.n_latent, tcfg.decoder.style_dim)).astype(np.float32))
    return tm, JE3DGE(jcfg), vs, x, ml


def test_raw_density_renderer_forward_matches_jax(raw_density):
    """`forward` with with_sdf=False integrates with beta = 1, as JAX's
    (`volume_renderer.py:227`): the render's maps match JAX's within the
    field tolerance, and differ from the same weights' SDF render (beta 0.1)."""
    tm, jm, vs, _, _ = raw_density
    ren = tm.generator.renderer
    assert not hasattr(ren, "sigmoid_beta") and "renderer.sigmoid_beta" not in tm.generator.state_dict()
    cfg = tm.cfg
    rng = np.random.RandomState(13)
    styles = (0.3 * rng.randn(2, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)
    azim, elev = np.array([0.1, -0.2], np.float32), np.array([0.05, 0.0], np.float32)
    r = cfg.renderer.out_im_res
    jcam = j_cam(jnp.asarray(azim), jnp.asarray(elev), r, cfg.camera.fov_ang, cfg.camera.dist_radius)
    want = jax.jit(lambda v, s: jm.apply(v, jcam, s, method=lambda m, c, s: m.generator.renderer(c, s)))(
        vs, jnp.asarray(styles))
    tcam = t_cam(_t(azim), _t(elev), r, cfg.camera.fov_ang, cfg.camera.dist_radius)
    with torch.no_grad():
        got = ren(tcam, _t(styles))
    for k in ("gen_thumb_imgs", "features", "depth", "hit_prob", "mask"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=FIELD_ATOL, err_msg=k)
    sdf_ren = TE3DGE(tc.tiny_full_config(), device="cpu").generator.renderer
    sdf_ren.load_state_dict({**ren.state_dict(), "sigmoid_beta": torch.full((1,), 0.1)}, strict=True)
    with torch.no_grad():
        sdf_out = sdf_ren(tcam, _t(styles))
    gaps = {k: float((sdf_out[k] - got[k]).abs().max()) for k in ("gen_thumb_imgs", "hit_prob", "depth")}
    print(f"raw density vs the SDF render of the same weights, max abs: {gaps}")
    assert gaps["hit_prob"] > 10 * FIELD_ATOL
    with pytest.raises(AttributeError, match="sigmoid_beta"):  # as JAX's (`volume_renderer.py:378`)
        ren.query_hit_prob(got["points"][:, :2, :2], tcam, _t(styles))


def test_raw_density_image2image_matches_jax(raw_density):
    """`image2image` with with_sdf=False: gen_thumb_imgs at the field
    tolerance and gen_imgs at 1e-3 of JAX's (test_torch_pipeline.py)."""
    tm, jm, vs, x, (ml_r, ml_d) = raw_density
    want = jax.jit(lambda v, i: jm.apply(v, i, JLM(jnp.asarray(ml_r), jnp.asarray(ml_d)), method=JE3DGE.image2image,
                                         rngs={"noise": jax.random.key(2)}))(vs, jnp.asarray(x))
    sf.reset_launch_counts()
    got = tm.image2image(_t(x), TLM(_t(ml_r), _t(ml_d)))
    assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}  # the CPU runs the plain version
    w, g = want["res_render_out"], got["res_render_out"]
    np.testing.assert_allclose(_np(g["gen_thumb_imgs"]), np.asarray(w["gen_thumb_imgs"]), atol=FIELD_ATOL)
    np.testing.assert_allclose(_np(g["gen_imgs"]), np.asarray(w["gen_imgs"]), atol=IMG_ATOL)
    assert float(g["gen_imgs"].std()) > 1e-2


# ------------------------------------------------------------------ options_compat


FLAG_LISTS = {
    # tests/test_components.py:218
    "components": ["--size", "512", "--N_samples", "12", "--enable_local_model", "--netLocal_type",
                   "HGPIFuNetGANResidualResnetFC", "--loadSize", "256", "--z_size", "1.12", "--fov", "6",
                   "--no_offset_sampling", "--some_dead_flag", "x"],
    # the two variants, and the couplings of style_dim, width, depth and the thumb resolution
    "variants": ["--no_sdf", "--netLocal_type", "HGPIFuNetGANResidual", "--enable_local_model", "--style_dim",
                 "128", "--width", "128", "--depth", "6", "--renderer_spatial_output_dim", "32", "--hourglass_dim",
                 "83", "--residual_local_feats_dim", "128", "--perturb", "0", "--static_viewdirs", "--azim", "0.2",
                 "--lr", "5e-5", "--adv_lambda", "0.01", "--eikonal_lambda", "0.05", "--dead_a", "--dead_b", "3"],
}


@pytest.mark.parametrize("name", sorted(FLAG_LISTS))
def test_reference_flags_give_jaxs_config(name):
    """The same flags give the same config fields on both sides (the
    dataclasses as dicts) and the same unknown flags."""
    argv = FLAG_LISTS[name]
    # the variants on the tiny preset, so that the model below builds small
    tiny = name == "variants"
    ours, unknown = to.config_from_reference_flags(argv, tc.tiny_full_config() if tiny else None)
    theirs, j_unknown = jo.config_from_reference_flags(argv, jc.tiny_full_config() if tiny else None)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert unknown == j_unknown and unknown
    if name == "variants":
        assert not ours.renderer.with_sdf and ours.pifu.netLocal_type == "HGPIFuNetGANResidual"
        m = TE3DGE(ours, device="cpu")
        assert m.local.variant == "bn" and not hasattr(m.generator.renderer, "sigmoid_beta")
