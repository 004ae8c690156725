"""Cameras, rays and volume integration of the port against the JAX package.

Tolerances: f32 closed-form geometry (a few trig / matrix ops per value), 1e-5
abs at unit scale; volume integration compares [-1, 1] colours and weights
built from exp/cumprod chains of 24 samples, 1e-5 abs as well."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3dge_torch.render import camera as tcam
from e3dge_torch.render import integrate as tint
from e3dge_torch.render import rays as trays
from e3dge_tpu.render import camera as jcam
from e3dge_tpu.render import integrate as jint
from e3dge_tpu.render import rays as jrays

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _cams(azim, elev, res=16):
    t = tcam.camera_params_from_angles(_t(azim), _t(elev), res, 6.0, 0.12)
    j = jcam.camera_params_from_angles(jnp.asarray(azim), jnp.asarray(elev), res, 6.0, 0.12)
    return t, j


def test_camera_params_match_jax():
    # includes a straight-down pole view (the degenerate look-at branch)
    azim = np.array([0.0, 0.3, -0.2, 0.1], np.float32)
    elev = np.array([0.0, -0.1, 0.15, np.pi / 2], np.float32)
    t, j = _cams(azim, elev)
    for name in tcam.CameraParams._fields:
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), atol=ATOL, err_msg=name)


def test_project_points_matches_jax():
    t, j = _cams(np.array([0.2, -0.1], np.float32), np.array([0.05, 0.1], np.float32))
    pts = np.random.RandomState(0).uniform(-0.12, 0.12, (2, 3, 50)).astype(np.float32)
    want = np.asarray(jcam.project_points(jnp.asarray(pts), j.calibs))
    np.testing.assert_allclose(tcam.project_points(_t(pts), t.calibs).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("static_viewdirs", [True, False])
def test_rays_and_points_match_jax(static_viewdirs):
    t, j = _cams(np.array([0.2, -0.1], np.float32), np.array([0.05, 0.1], np.float32), res=8)
    tr = trays.get_rays(t.focal, t.poses, 8, static_viewdirs=static_viewdirs)
    jr = jrays.get_rays(j.focal, j.poses, 8, static_viewdirs=static_viewdirs)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    for offset in (True, False):
        tz = trays.sample_z_vals(t.near, t.far, (2, 8, 8), 6, offset_sampling=offset)
        jz = jrays.sample_z_vals(
            None, jnp.broadcast_to(j.near.reshape(2, 1, 1), (2, 8, 8)),
            jnp.broadcast_to(j.far.reshape(2, 1, 1), (2, 8, 8)), (2, 8, 8), 6, offset_sampling=offset,
        )
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL)
    tp = trays.rays_to_points(tr[0], tr[1], tz)
    jp = jrays.rays_to_points(jr[0], jr[1], jz)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)


@pytest.mark.parametrize("force_background,no_force_stop", [(True, False), (False, False), (True, True)])
def test_volume_integrate_matches_jax(force_background, no_force_stop):
    rng = np.random.RandomState(1)
    B, H, W, S, F = 2, 4, 4, 6, 5
    rgb = rng.randn(B, H, W, S, 3).astype(np.float32)
    sdf = (0.1 * rng.randn(B, H, W, S, 1)).astype(np.float32)
    feats = rng.randn(B, H, W, S, F).astype(np.float32)
    z = np.sort(rng.uniform(0.88, 1.12, (B, H, W, S)), axis=-1).astype(np.float32)
    rays_d = rng.randn(B, H, W, 3).astype(np.float32)
    pts = rng.randn(B, H, W, S, 3).astype(np.float32)
    beta = np.array([0.1], np.float32)
    want = jint.volume_integrate(
        *(jnp.asarray(a) for a in (rgb, sdf, feats, z, rays_d, pts, beta)),
        force_background=force_background, no_force_stop=no_force_stop,
    )
    got = tint.volume_integrate(
        *(_t(a) for a in (rgb, sdf, feats, z, rays_d, pts, beta)),
        force_background=force_background, no_force_stop=no_force_stop,
    )
    for name in tint.IntegrationOut._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=ATOL, rtol=1e-5, err_msg=name
        )
    np.testing.assert_allclose(
        tint.sdf_to_density(_t(sdf), _t(beta)).numpy(),
        np.asarray(jint.sdf_to_density(jnp.asarray(sdf), jnp.asarray(beta))), rtol=1e-5,
    )
