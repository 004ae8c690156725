"""Every loss and metric of the port's `training/losses.py` against the JAX
package's `training/losses.py` on the same random inputs (made with numpy),
within 1e-5 relative (f32 sums in another order); and the ID loss's adaptive
pool against the JAX one at 188 -> 112 and 32 -> 112."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3dge_torch.ops.grid_sample import adaptive_avg_pool2d as t_pool
from e3dge_torch.training import losses as TL
from e3dge_tpu.ops.grid_sample import adaptive_avg_pool2d as j_pool
from e3dge_tpu.training import losses as JL

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _images(seed, shape=(2, 3, 24, 24)):
    rng = np.random.RandomState(seed)
    pred = rng.uniform(-1, 1, shape).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.2, shape), -1, 1).astype(np.float32)
    return pred, gt


PAIRWISE = ["l1", "mse", "smooth_l1", "psnr", "ssim", "ssim_ref", "mae_ref", "viewpoint_loss", "depth_consistency_loss"]
PER_SAMPLE = ["ssim", "ssim_ref", "mae_ref"]


@pytest.mark.parametrize("name,per_sample", [(n, False) for n in PAIRWISE] + [(n, True) for n in PER_SAMPLE])
def test_pairwise_losses_match_jax(name, per_sample):
    pred, gt = _images(PAIRWISE.index(name))
    if name in ("psnr", "ssim"):  # [0, 1] metrics
        pred, gt = (pred + 1) / 2, (gt + 1) / 2
    kw = {"per_sample": True} if per_sample else {}
    want = getattr(JL, name)(jnp.asarray(pred), jnp.asarray(gt), **kw)
    got = getattr(TL, name)(_t(pred), _t(gt), **kw)
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want)


def test_smooth_l1_beta_and_gan_losses_match_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(4, 7).astype(np.float32), rng.randn(4, 7).astype(np.float32)
    _close(TL.smooth_l1(_t(a), _t(b), beta=0.3), JL.smooth_l1(jnp.asarray(a), jnp.asarray(b), beta=0.3))
    real, fake = rng.randn(4, 1).astype(np.float32), rng.randn(4, 1).astype(np.float32)
    _close(TL.d_logistic_loss(_t(real), _t(fake)), JL.d_logistic_loss(jnp.asarray(real), jnp.asarray(fake)))
    _close(TL.g_nonsaturating_loss(_t(fake)), JL.g_nonsaturating_loss(jnp.asarray(fake)))


def test_r1_penalty_matches_jax():
    """R1 on a fixed quadratic-tanh critic, written once per framework."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 2, 5, 5).astype(np.float32)
    w = rng.randn(2 * 5 * 5).astype(np.float32)
    want = JL.d_r1_penalty(lambda v, im: jnp.tanh(im.reshape(im.shape[0], -1) @ v) ** 2, jnp.asarray(w),
                           jnp.asarray(x))
    wt = _t(w).requires_grad_()
    got = TL.d_r1_penalty(lambda im: torch.tanh(im.reshape(im.shape[0], -1) @ wt) ** 2, _t(x))
    _close(got, want)
    assert got.requires_grad  # the penalty trains the critic


@pytest.mark.parametrize("with_sdf", [False, True])
def test_eikonal_loss_matches_jax(with_sdf):
    rng = np.random.RandomState(3)
    g = rng.randn(2, 50, 3).astype(np.float32)
    sdf = (0.05 * rng.randn(2, 50, 1)).astype(np.float32)
    want = JL.eikonal_loss(jnp.asarray(g), jnp.asarray(sdf) if with_sdf else None)
    got = TL.eikonal_loss(_t(g), _t(sdf) if with_sdf else None)
    for a, b in zip(got, want):
        _close(a, b)


def test_consistency_losses_match_jax():
    rng = np.random.RandomState(4)
    p1 = rng.uniform(0, 1, (2, 4, 4, 6, 1)).astype(np.float32)
    p0 = rng.uniform(0, 1, p1.shape).astype(np.float32)
    _close(TL.hit_prob_consistency_loss(_t(p1), _t(p0)), JL.hit_prob_consistency_loss(jnp.asarray(p1), jnp.asarray(p0)))
    d1, d0 = rng.randn(2, 4, 4, 1).astype(np.float32), rng.randn(2, 4, 4, 1).astype(np.float32)
    _close(TL.depth_consistency_loss(_t(d1), _t(d0), beta=0.1),
           JL.depth_consistency_loss(jnp.asarray(d1), jnp.asarray(d0), beta=0.1))


def test_adaptive_weight_adopt_weight_and_path_lengths_match_jax():
    rng = np.random.RandomState(5)
    rec = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    adv = [rng.randn(3, 4).astype(np.float32), 3 * rng.randn(5).astype(np.float32)]
    for a, b, mx in ((rec, adv, 1.0), (adv, rec, 1.0), (adv, rec, 10.0)):
        _close(TL.calculate_adaptive_weight([_t(x) for x in a], [_t(x) for x in b], mx),
               JL.calculate_adaptive_weight([jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b], mx))
    for step in (5, 10, 15):
        _close(TL.adopt_weight(0.7, step, threshold=10), JL.adopt_weight(0.7, step, threshold=10))
    grads = rng.randn(4, 9, 16).astype(np.float32)
    want = JL.path_lengths_from_grads(jnp.asarray(grads), jnp.asarray(0.3))
    got = TL.path_lengths_from_grads(_t(grads), torch.tensor(0.3))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("with_nets", [False, True])
def test_calc_2d_rec_loss_matches_jax(with_nets):
    """The composite 2D loss and its metrics; the LPIPS/ID terms through the
    same simple stand-in functions on both sides."""
    pred, gt = _images(6, (2, 3, 32, 32))
    lambdas = dict(l2_lambda=0.7, lpips_lambda=0.8, id_lambda=0.1)
    fns = {}
    if with_nets:
        fns = dict(lpips_fn=lambda p, t: jnp.mean(jnp.abs(p - t) ** 1.5),
                   id_fn=lambda p, t: (jnp.mean((p - t) ** 2) * 2, jnp.mean(p * t)))
        tfns = dict(lpips_fn=lambda p, t: torch.mean(torch.abs(p - t) ** 1.5),
                    id_fn=lambda p, t: (torch.mean((p - t) ** 2) * 2, torch.mean(p * t)))
    want_loss, want = JL.calc_2d_rec_loss(jnp.asarray(pred), jnp.asarray(gt), lambdas, **fns)
    got_loss, got = TL.calc_2d_rec_loss(_t(pred), _t(gt), lambdas, **(tfns if with_nets else {}))
    assert set(got) == set(want)
    _close(got_loss, want_loss)
    for k in want:
        _close(got[k], want[k])


def test_calc_shape_rec_loss_matches_jax():
    rng = np.random.RandomState(7)
    pred = {
        "uniform_points_sdf": (0.1 * rng.randn(2, 64, 1)).astype(np.float32),
        "surface_sdf": (0.05 * rng.randn(2, 4, 4, 1)).astype(np.float32),
        "surface_eikonal_term": rng.randn(2, 4, 4, 3).astype(np.float32),
        "eikonal_term": rng.randn(2, 4, 4, 3).astype(np.float32),
    }
    gt = {
        "uniform_points_sdf": (0.1 * rng.randn(2, 64, 1)).astype(np.float32),
        "surface_eikonal_term": rng.randn(2, 4, 4, 3).astype(np.float32),
    }
    lambdas = dict(shape_uniform_lambda=0.2, shape_surface_lambda=1.0, shape_normal_lambda=0.5, eikonal_lambda=0.1)
    want_loss, want = JL.calc_shape_rec_loss({k: jnp.asarray(v) for k, v in pred.items()},
                                             {k: jnp.asarray(v) for k, v in gt.items()}, lambdas)
    got_loss, got = TL.calc_shape_rec_loss({k: _t(v) for k, v in pred.items()}, {k: _t(v) for k, v in gt.items()},
                                           lambdas)
    assert set(got) == set(want) and len(want) == 5
    _close(got_loss, want_loss)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("size_in", [188, 32])
def test_adaptive_avg_pool2d_matches_jax(size_in):
    """torch's bin rule at the ID loss's 188 -> 112 (a crop of a 256 image)
    and at the tiny configuration's 32 -> 112 (pooling up)."""
    x = np.random.RandomState(size_in).randn(2, 3, size_in, size_in).astype(np.float32)
    want = j_pool(jnp.asarray(x), (112, 112))
    got = t_pool(_t(x), (112, 112))
    assert tuple(got.shape) == (2, 3, 112, 112)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
