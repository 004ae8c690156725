"""The renderer's field queries against the JAX package's at
`tiny_full_config` on seeded weights: the three occlusion queries, `query_sdf`
and `render_sdf_grid`. The query points lie in the scene box, on a grid whose
point count is no multiple of the 16 chunks (the JAX function pads the last
chunk, the port slices it shorter).

Tolerances: what goes through the field, 3e-3 abs in f32 (the goldens',
tests/test_golden_oracle.py:40-41) and a mean relative error < 0.05 in bf16
(tests/test_precision.py:94); the texture lookup, which evaluates no field,
1e-5 abs (a bilinear sample and a lerp in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import seeded_variables

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.ops import siren_field as sf
from e3dge_torch.render.camera import camera_params_from_angles as t_cam
from e3dge_torch.utils.weights import load_jax_variables
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.render.camera import camera_params_from_angles as j_cam
from e3dge_tpu.utils import config as jc

FIELD_ATOL, BF16_REL = 3e-3, 0.05
AZIM, ELEV = np.array([0.2, -0.15], np.float32), np.array([0.05, 0.1], np.float32)


def _np(x):
    return x.detach().float().numpy()


@pytest.fixture(scope="module")
def setup(tiny_full_setup):
    cfg, _, variables, _ = tiny_full_setup
    vs = seeded_variables(variables)
    rng = np.random.RandomState(21)
    pts = rng.uniform(-0.1, 0.1, (2, 5, 3, 3, 3)).astype(np.float32)  # N = 45 per item
    styles = (0.3 * rng.randn(2, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)
    return cfg, vs, pts, styles


def _port(cfg, vs):
    m = TE3DGE(cfg, device="cpu")
    load_jax_variables(m, vs)
    return m.generator.renderer


def _jax(cfg, vs, fn, *args):
    return JE3DGE(cfg).apply(vs, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
                             method=lambda m, *a: fn(m.generator.renderer, *a))


def _cams(cfg):
    r = cfg.renderer.out_im_res
    return (j_cam(jnp.asarray(AZIM), jnp.asarray(ELEV), r, cfg.camera.fov_ang, cfg.camera.dist_radius),
            t_cam(torch.from_numpy(AZIM), torch.from_numpy(ELEV), r, cfg.camera.fov_ang, cfg.camera.dist_radius))


@pytest.mark.parametrize("return_type", ["weights", "visibility"])
def test_query_hit_prob_matches_jax(setup, return_type):
    cfg, vs, pts, styles = setup
    jcam, tcam = _cams(cfg)
    want = _jax(cfg, vs, lambda r, p, c, s: r.query_hit_prob(p, c, s, return_type=return_type), pts, jcam, styles)
    ren = _port(tc.tiny_full_config(), vs)
    with torch.no_grad():
        got = ren.query_hit_prob(torch.from_numpy(pts), tcam, torch.from_numpy(styles), return_type=return_type)
        one_chunk = ren.query_hit_prob(torch.from_numpy(pts), tcam, torch.from_numpy(styles),
                                       return_type=return_type, n_chunks=1)
    assert tuple(got.shape) == pts.shape[:-1] + (1,)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FIELD_ATOL)
    np.testing.assert_allclose(_np(one_chunk), _np(got), atol=1e-6)  # chunking changes nothing
    assert np.abs(np.asarray(want)).max() > 1e-2


def test_query_hit_prob_bf16_field_tracks_jax(setup):
    """occlusion_field_dtype='bfloat16' under an f32 field: the serving
    precision for the occlusion field only."""
    cfg, vs, pts, styles = setup
    jcam, tcam = _cams(cfg)
    jcfg = jc._with(cfg, renderer=dict(occlusion_field_dtype="bfloat16"))
    want = np.asarray(_jax(jcfg, vs, lambda r, p, c, s: r.query_hit_prob(p, c, s), pts, jcam, styles))
    ren = _port(tc._with(tc.tiny_full_config(), renderer=dict(occlusion_field_dtype="bfloat16")), vs)
    assert ren._occlusion_precision() == "serving"
    with torch.no_grad():
        got = _np(ren.query_hit_prob(torch.from_numpy(pts), tcam, torch.from_numpy(styles)))
    err = np.abs(got - want) / (np.abs(want).max() + 1e-6)
    assert err.mean() < BF16_REL, f"mean rel err {err.mean():.4f}"


def test_query_hit_prob_texture_matches_jax(setup):
    cfg, vs, pts, _ = setup
    jcam, tcam = _cams(cfg)
    r, s = cfg.renderer.out_im_res, cfg.renderer.n_samples
    vol = np.random.RandomState(22).uniform(0, 1, (2, r, r, s, 1)).astype(np.float32)
    want = _jax(cfg, vs, lambda ren, p, c, v: ren.query_hit_prob_texture(p, c, v), pts, jcam, vol)
    got = _port(tc.tiny_full_config(), vs).query_hit_prob_texture(torch.from_numpy(pts), tcam, torch.from_numpy(vol))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_query_hit_prob_adapted_matches_jax(setup):
    cfg, vs, pts, styles = setup
    jcam, tcam = _cams(cfg)
    want = _jax(cfg, vs, lambda r, p, c, s: r.query_hit_prob_adapted(p, c, s), pts, jcam, styles)
    with torch.no_grad():
        got = _port(tc.tiny_full_config(), vs).query_hit_prob_adapted(torch.from_numpy(pts), tcam,
                                                                      torch.from_numpy(styles))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FIELD_ATOL)
    assert np.abs(np.asarray(want)).max() > 1e-3


def test_query_sdf_and_render_sdf_grid_match_jax(setup):
    cfg, vs, pts, styles = setup
    jcam, tcam = _cams(cfg)
    ren = _port(tc.tiny_full_config(), vs)
    want = _jax(cfg, vs, lambda r, p, s: r.query_sdf(p, s), pts, styles)
    sf.reset_launch_counts()
    with torch.no_grad():
        got = ren.query_sdf(torch.from_numpy(pts), torch.from_numpy(styles))
    assert tuple(got.shape) == pts.shape[:-1] + (1,)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FIELD_ATOL)

    want = _jax(cfg, vs, lambda r, c, s: r.render_sdf_grid(c, s), jcam, styles)
    with torch.no_grad():
        got = ren.render_sdf_grid(tcam, torch.from_numpy(styles))
    r, s = cfg.renderer.out_im_res, cfg.renderer.n_samples
    assert tuple(got.shape) == (2, r, r, s, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FIELD_ATOL)
    assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}  # the CPU runs the plain version

    # query_raw: the JAX layout [rgb 3, sdf 1, features W]
    dirs = np.random.RandomState(23).randn(*pts.shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = _jax(cfg, vs, lambda r, p, d, s: r.query_raw(p, d, s), pts, dirs, styles)
    with torch.no_grad():
        got = ren.query_raw(torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(styles))
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FIELD_ATOL)


def test_sdf_queries_stay_f32_in_a_bf16_config(setup):
    """Under field_dtype='bfloat16' the JAX queries still run the network on
    their f32 points (only `forward` casts to the field dtype), so the SDF
    grid, and with it the mesh, is f32. At this size the two f32 fields agree
    to ~4e-7 and a bf16 field is ~2e-3 off, so 1e-4 tells them apart."""
    cfg, vs, pts, styles = setup
    jcam, tcam = _cams(cfg)
    jcfg = jc._with(cfg, renderer=dict(field_dtype="bfloat16"))
    ren = _port(tc._with(tc.tiny_full_config(), renderer=dict(field_dtype="bfloat16")), vs)
    want_sdf = _jax(jcfg, vs, lambda r, p, s: r.query_sdf(p, s), pts, styles)
    want_grid = _jax(jcfg, vs, lambda r, c, s: r.render_sdf_grid(c, s), jcam, styles)
    assert np.asarray(want_grid).dtype == np.float32
    with torch.no_grad():
        got_sdf = ren.query_sdf(torch.from_numpy(pts), torch.from_numpy(styles))
        got_grid = ren.render_sdf_grid(tcam, torch.from_numpy(styles))
    np.testing.assert_allclose(_np(got_sdf), np.asarray(want_sdf), atol=1e-4)
    np.testing.assert_allclose(_np(got_grid), np.asarray(want_grid), atol=1e-4)
