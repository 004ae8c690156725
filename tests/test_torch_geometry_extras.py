"""The geometry extras of the PyTorch port against the JAX package, on the
same seeded weights: `SirenGenerator.forward_ddf`, `render/rays.py::
find_surface_secant`, `VolumeFeatureRenderer.mlp_init_pass` and
`render/camera.py`'s `sample_camera_params`, `sweep_camera_params` and
`project_points_orthogonal`. JAX runs eagerly (flax `init` / `apply` of
small modules, no compile).

Tolerances: forward_ddf's outputs 1e-5 abs (a depth-3, width-16 field in
f32, whose outputs are O(1)); the secant's z 1e-5 on the analytic sphere and
1e-4 on a seeded field (the field's f32 rounding divided by its slope at the
root, see `test_secant_on_a_seeded_field_matches_jax`); mlp_init_pass's sdf
3e-3 abs (the renderer's field tolerance, test_torch_models.py) and its
target 1e-5 (test_render.py:303), its gradient 1e-4 of its scale; the cameras
1e-5 (test_render.py:320, test_local_branch.py:95)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3dge_torch import config as tc
from e3dge_torch.models.siren import SirenGenerator as TSiren
from e3dge_torch.models.volume_renderer import VolumeFeatureRenderer as TRenderer
from e3dge_torch.render import camera as tcam
from e3dge_torch.render.rays import find_surface_secant as t_secant
from e3dge_torch.render.rays import get_rays as t_rays
from e3dge_torch.utils.weights import siren_state_dict_from_jax
from e3dge_tpu.models.siren import SirenGenerator as JSiren
from e3dge_tpu.models.volume_renderer import VolumeFeatureRenderer as JRenderer
from e3dge_tpu.render import camera as jcam
from e3dge_tpu.render.rays import find_surface_secant as j_secant
from e3dge_tpu.render.rays import get_rays as j_rays
from e3dge_tpu.utils import config as jc


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def ddf_pair():
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 5, 3).astype(np.float32)
    views = rng.randn(2, 5, 3).astype(np.float32)
    styles = (0.1 * rng.randn(2, 4, 8)).astype(np.float32)
    jnet = JSiren(depth=3, width=16, style_dim=8)
    v = jnet.init(jax.random.key(3), jnp.asarray(pts), jnp.asarray(views), jnp.asarray(styles))
    tnet = TSiren(depth=3, width=16, style_dim=8)
    tnet.load_state_dict(siren_state_dict_from_jax(v), strict=True)
    return jnet, v, tnet, (pts, views, styles)


@pytest.mark.parametrize("multi_layer", [False, True])
@pytest.mark.parametrize("feat_layer", [-1, 1, 2])
def test_forward_ddf_matches_jax(ddf_pair, feat_layer, multi_layer):
    jnet, v, tnet, (pts, views, styles) = ddf_pair
    want = jnet.apply(v, *(jnp.asarray(a) for a in (pts, views, styles)), feat_layer, multi_layer,
                      method=JSiren.forward_ddf)
    with torch.no_grad():
        got = tnet.forward_ddf(_t(pts), _t(views), _t(styles), feat_layer, multi_layer)
        base = tnet(_t(pts), _t(views), _t(styles))
    n_feats = {(-1, False): 1, (1, False): 1, (2, False): 1, (-1, True): 4, (1, True): 3, (2, True): 2}
    assert got["feats"].shape == (2, 5, 16 * n_feats[(feat_layer, multi_layer)])
    for k in ("out", "feats"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    torch.testing.assert_close(got["out"], base[..., :4], rtol=0, atol=0)  # rgb + sdf of the plain forward


def test_forward_ddf_past_the_last_layer_has_no_features(ddf_pair):
    jnet, v, tnet, (pts, views, styles) = ddf_pair
    want = jnet.apply(v, *(jnp.asarray(a) for a in (pts, views, styles)), 5, False, method=JSiren.forward_ddf)
    got = tnet.forward_ddf(_t(pts), _t(views), _t(styles), 5, False)
    assert got["feats"].shape == tuple(want["feats"].shape) == (2, 5, 0)


def test_secant_on_the_analytic_sphere_matches_jax():
    """test_render.py:198's rays: one hits the r = 0.5 sphere at z = 1.5,
    one grazes outside and one passes beside it (both miss: far)."""
    r = 0.5
    o = np.asarray([[0.0, 0.0, 2.0], [0.0, 0.0, 2.0], [2.0, 2.0, 2.0]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]], np.float32)
    jz, jhit = j_secant(lambda p: jnp.linalg.norm(p, axis=-1, keepdims=True) - r, jnp.asarray(o), jnp.asarray(d),
                        0.5, 3.5, n_coarse=32, n_secant=8)
    tz, thit = t_secant(lambda p: torch.linalg.norm(p, dim=-1, keepdim=True) - r, _t(o), _t(d), 0.5, 3.5,
                        n_coarse=32, n_secant=8)
    assert thit.tolist() == np.asarray(jhit).tolist() == [True, False, False]
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(float(tz[0]), 2.0 - r, atol=1e-5)
    assert float(tz[1]) == 3.5
    # along the axis that SDF is linear in z, so the first chord is the root;
    # |p|^2 - r^2 is not: 8 secant steps reach the root, none (the card gate's
    # control) stops at the coarse bracket's chord
    def sq(p):
        return (p**2).sum(-1, keepdim=True) - r**2

    z8, _ = t_secant(sq, _t(o), _t(d), 0.5, 3.5, n_coarse=32, n_secant=8)
    z0, _ = t_secant(sq, _t(o), _t(d), 0.5, 3.5, n_coarse=32, n_secant=0)
    assert abs(float(z8[0]) - 1.5) < 1e-5 < 1e-4 < abs(float(z0[0]) - 1.5)


@pytest.fixture(scope="module")
def renderers():
    """The tiny renderer (tiny_test_config) in JAX and in the port on one
    set of seeded weights, a camera and styles."""
    torch.set_num_threads(1)
    jcfg, tcfg = jc.tiny_test_config().renderer, tc.tiny_test_config().renderer
    azim, elev = np.asarray([0.1, -0.2], np.float32), np.asarray([0.05, 0.0], np.float32)
    cams = (jcam.camera_params_from_angles(jnp.asarray(azim), jnp.asarray(elev), jcfg.out_im_res),
            tcam.camera_params_from_angles(_t(azim), _t(elev), tcfg.out_im_res))
    styles = (0.3 * np.random.RandomState(1).randn(2, jcfg.depth + 1, jcfg.style_dim)).astype(np.float32)
    jr = JRenderer(jcfg)
    v = jr.init(jax.random.key(0), cams[0], jnp.asarray(styles))
    tr = TRenderer(tcfg)
    sd = {f"network.{k}": val for k, val in siren_state_dict_from_jax({"params": v["params"]["network"]}).items()}
    sd["sigmoid_beta"] = _t(v["params"]["sigmoid_beta"])
    tr.load_state_dict(sd, strict=True)
    return jr, v, tr, cams, styles


def test_secant_on_a_seeded_field_matches_jax(renderers):
    """Through `query_sdf` of the tiny seeded renderer (the kernel's plain
    version on the CPU), every pixel's ray of two cameras, at the SDF level
    of the coarse samples' 5th percentile, where about half the rays hit.
    Hit masks equal, except on a ray where a coarse sample lies within
    rounding (1e-5) of the level: the two frameworks' last bits can pick
    another bracket there, and such rays are listed; z within 1e-4 on the
    rays both hit in one bracket (the field's ~1e-6 rounding over its slope
    at the root, with the chord's error below that after 8 steps)."""
    jr, v, tr, (jcam_, tcam_), styles = renderers
    res = jr.cfg.out_im_res
    jo, jd, _ = j_rays(jcam_.focal, jcam_.poses, res)
    to, td, _ = t_rays(tcam_.focal, tcam_.poses, res)
    near, far = float(jcam_.near.reshape(-1)[0]), float(jcam_.far.reshape(-1)[0])
    t = np.linspace(0.0, 1.0, 24)
    z = near * (1 - t) + far * t
    coarse = np.asarray(jr.apply(v, jo[..., None, :] + jd[..., None, :] * jnp.asarray(z)[:, None], jnp.asarray(styles),
                                 method=JRenderer.query_sdf))[..., 0]
    level = float(np.quantile(coarse, 0.05))

    def j_sdf(p):
        return jr.apply(v, p, jnp.asarray(styles), method=JRenderer.query_sdf)

    jz, jhit = j_secant(j_sdf, jo, jd, near, far, level=level)
    with torch.no_grad():
        tz, thit = t_secant(lambda p: tr.query_sdf(p, _t(styles)), to, td, near, far, level=level)
    jz, jhit, tz, thit = np.asarray(jz), np.asarray(jhit), tz.numpy(), thit.numpy()
    assert 0 < jhit.sum() < jhit.size  # the level splits the rays
    ambiguous = (np.abs(coarse - level) < 1e-5).any(axis=-1)
    differ = np.argwhere(jhit != thit)
    assert all(ambiguous[tuple(i)] for i in differ), f"rays whose hit differs without an ambiguous sample: {differ}"
    both = jhit & thit & ~ambiguous
    assert both.sum() > 0
    np.testing.assert_allclose(tz[both], jz[both], atol=1e-4)
    np.testing.assert_array_equal(tz[~thit], far)


def test_mlp_init_pass_matches_jax_with_its_jitter(renderers):
    """JAX's mids jitter on the offset grid, passed in as t_rand: the sdf
    (twin under grad, the kernel's plain version without), the sphere
    target, and the gradient of the init loss on the field's parameters."""
    jr, v, tr, (jcam_, tcam_), styles = renderers
    b, res, s = 2, jr.cfg.out_im_res, jr.cfg.n_samples
    key = jax.random.key(2)
    j_sdf, j_target = jr.apply(v, key, jcam_, jnp.asarray(styles), method=JRenderer.mlp_init_pass)
    t_rand = _t(jax.random.uniform(key, (b, res, res, s)))

    def j_loss(params):
        sdf, target = jr.apply({**v, "params": params}, key, jcam_, jnp.asarray(styles), method=JRenderer.mlp_init_pass)
        return jnp.mean((sdf - target) ** 2)

    j_grad = jax.grad(j_loss)(v["params"])["network"]
    with torch.no_grad():
        sdf0, target0 = tr.mlp_init_pass(tcam_, _t(styles), t_rand=t_rand)
    sdf, target = tr.mlp_init_pass(tcam_, _t(styles), t_rand=t_rand)
    assert sdf.requires_grad and not target.requires_grad
    for got in (sdf0, sdf.detach()):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_sdf), atol=3e-3)
    for got in (target0, target):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_target), atol=1e-5)
    assert target.min() > -0.061 and target.max() < 0.13  # test_render.py:303's sphere
    tr.zero_grad()
    torch.mean((sdf - target) ** 2).backward()
    want = siren_state_dict_from_jax({"params": j_grad})
    grads = dict(tr.network.named_parameters())
    for k, w in want.items():  # the texture head takes no part: JAX's zeros, torch's None
        g = torch.zeros_like(grads[k]) if grads[k].grad is None else grads[k].grad
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * max(1.0, float(w.abs().max())), err_msg=k)
    # the jitter is the draw: another one moves the samples
    other = tr.mlp_init_pass(tcam_, _t(styles), generator=torch.Generator().manual_seed(0))[1]
    assert float((other - target).abs().max()) > 1e-4


def test_sweep_and_orthogonal_projection_match_jax():
    for batch, n_views in ((1, 8), (2, 5)):
        want = jcam.sweep_camera_params(batch, 8, jc.CameraConfig(), n_views)
        got = tcam.sweep_camera_params(batch, 8, tc.CameraConfig(), n_views)
        for k, w in want._asdict().items():
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(w), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.viewpoint[[0, n_views - 1], 0].numpy(), [-0.3, 0.3], atol=1e-6)
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 3, 7).astype(np.float32)
    calibs = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    calibs[:, :3, 3] = [1.0, 2.0, 3.0]
    calibs[:, :3, :3] += 0.1 * rng.randn(2, 3, 3).astype(np.float32)
    want = jcam.project_points_orthogonal(jnp.asarray(pts), jnp.asarray(calibs))
    got = tcam.project_points_orthogonal(_t(pts), _t(calibs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("uniform", [False, True])
def test_sample_camera_params_draws_from_its_generator(uniform):
    """The draws come from the explicit generator (one seed, one camera; the
    frameworks' streams differ, so the cameras are held to JAX's
    camera_params_from_angles at the drawn angles) within the config's
    distribution: gaussian of std range, or uniform within +-range."""
    cfg_t, cfg_j = tc.CameraConfig(uniform=uniform, azim_mean=0.1), jc.CameraConfig(uniform=uniform, azim_mean=0.1)
    a = tcam.sample_camera_params(torch.Generator().manual_seed(5), 256, 16, cfg_t)
    b = tcam.sample_camera_params(torch.Generator().manual_seed(5), 256, 16, cfg_t)
    assert torch.equal(a.poses, b.poses)
    azim, elev = a.viewpoint[:, 0].numpy(), a.viewpoint[:, 1].numpy()
    want = jcam.camera_params_from_angles(jnp.asarray(azim), jnp.asarray(elev), 16, cfg_j.fov_ang, cfg_j.dist_radius)
    for k, w in want._asdict().items():
        np.testing.assert_allclose(getattr(a, k).numpy(), np.asarray(w), atol=1e-5, err_msg=k)
    dev = np.abs(azim - 0.1)
    if uniform:
        assert dev.max() <= cfg_t.azim_range and np.abs(elev).max() <= cfg_t.elev_range
    else:
        assert 0.2 < np.std(azim) < 0.4 and dev.max() > cfg_t.azim_range  # std 0.3, tails past it
