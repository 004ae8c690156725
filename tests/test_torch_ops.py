"""L0 ops of the PyTorch port against the JAX package's (and the numpy
upfirdn2d oracle), on seeded numpy inputs.

Tolerances: these are single f32 passes of a few multiply-adds per output, so
1e-5 abs (a few f32 ulps at unit scale) unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3dge_torch import ops as tops
from e3dge_tpu import ops as jops
from e3dge_tpu.models import e3dge as je3dge
from e3dge_tpu.ops.fast_math import fast_sin as jfast_sin
from e3dge_tpu.ops.upfirdn2d import upfirdn2d_ref

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize(
    "up,down,pad,taps",
    [
        (1, 1, (1, 1), (1, 3, 3, 1)),
        (2, 1, (2, 1), (1, 3, 3, 1)),
        (1, 2, (1, 1), (1, 3, 3, 1)),
        (2, 2, (1, 2, 0, 1), (1, 2, 1)),
        (1, 1, (-1, 2), (1, 3, 3, 1)),
    ],
)
def test_upfirdn2d_matches_oracle_and_jax(up, down, pad, taps):
    x = np.random.RandomState(0).randn(2, 3, 9, 7).astype(np.float32)
    k = np.asarray(jops.make_kernel(taps))
    want = upfirdn2d_ref(x, k, up=up, down=down, pad=pad)
    got = tops.upfirdn2d(_t(x), tops.make_kernel(taps), up=up, down=down, pad=pad).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jops.upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad)), atol=ATOL)


def test_resampling_wrappers_match_jax():
    x = np.random.RandomState(1).randn(1, 4, 8, 8).astype(np.float32)
    k_np, k_t = jops.make_kernel((1, 3, 3, 1)), tops.make_kernel((1, 3, 3, 1))
    np.testing.assert_allclose(tops.make_kernel((1, 3, 3, 1)).numpy(), k_np, atol=0)
    for jf, tf in ((jops.upsample2x, tops.upsample2x), (jops.downsample2x, tops.downsample2x)):
        np.testing.assert_allclose(tf(_t(x), k_t).numpy(), np.asarray(jf(jnp.asarray(x), k_np)), atol=ATOL)
    got = tops.blur(_t(x), k_t, pad=(2, 1), upsample_factor=2).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.blur(jnp.asarray(x), k_np, pad=(2, 1), upsample_factor=2)), atol=ATOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(16, 12), (4, 5)])
def test_bilinear_resize_matches_jax(align_corners, size):
    x = np.random.RandomState(2).randn(2, 3, 8, 6).astype(np.float32)
    want = np.asarray(jops.interpolate_bilinear(jnp.asarray(x), size, align_corners=align_corners))
    got = tops.interpolate_bilinear(_t(x), size, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_bicubic_resize_matches_jax_cubic_matrix(align_corners):
    """torch's bicubic (A = -0.75, clamped taps) against the JAX package's
    `_cubic_matrix` form; the hourglass upsample uses align_corners=True."""
    x = np.random.RandomState(3).randn(2, 5, 6, 6).astype(np.float32)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    want = np.asarray(jops.interpolate_bicubic_nhwc(nhwc, (12, 12), align_corners=align_corners))
    got = tops.interpolate_bicubic(_t(x), (12, 12), align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=ATOL)
    want = np.asarray(jops.interpolate_bicubic(jnp.asarray(x), (12, 12), align_corners=align_corners))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_grid_sample_with_out_of_image_points():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 5, 7).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 6, 4, 2)).astype(np.float32)  # ~30% outside [-1, 1]
    grid[0, 0, 0] = [1.0, -1.0]  # exact corner
    want = np.asarray(jops.grid_sample(jnp.asarray(x), jnp.asarray(grid)))
    np.testing.assert_allclose(tops.grid_sample(_t(x), _t(grid)).numpy(), want, atol=ATOL)
    assert (np.abs(grid) > 1).any()


@pytest.mark.parametrize("src,out", [(32, 8), (8, 32), (16, 16)])
def test_pools_match_jax(src, out):
    x = np.random.RandomState(5).randn(2, 3, src, src).astype(np.float32)
    want = np.asarray(je3dge.adaptive_avg_pool(jnp.asarray(x), out))
    np.testing.assert_allclose(tops.adaptive_avg_pool(_t(x), out).numpy(), want, atol=ATOL)
    if out > src:
        want = np.asarray(je3dge.upsample_nearest(jnp.asarray(x), out))
        np.testing.assert_allclose(tops.upsample_nearest(_t(x), out).numpy(), want, atol=0)


def test_pos_encoding_matches_jax():
    x = np.random.RandomState(6).uniform(-0.2, 0.2, (2, 4, 3)).astype(np.float32)
    want = np.asarray(jops.pos_encoding(jnp.asarray(x), n_freqs=7))
    got = tops.pos_encoding(_t(x), n_freqs=7).numpy()
    assert got.shape == (2, 4, 45)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fast_sin_matches_jax_and_sin():
    """Same reduction and polynomial as the JAX function (round half to even on
    both sides, exact .5 multiples of 2pi included); 5e-6 against sin over
    |x| <= 60 (polynomial 1e-7 + |x|*2^-24 ~ 3.6e-6 from the f32 reduction)."""
    x = np.concatenate([
        np.linspace(-60, 60, 20001, dtype=np.float32),
        (np.arange(-9, 10) * np.float32(np.pi)).astype(np.float32),
    ])
    got = tops.fast_sin(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfast_sin(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(got, np.sin(x.astype(np.float64)), atol=5e-6)
    assert tops.fast_sin(_t(x).bfloat16()).dtype == torch.bfloat16


def test_fused_leaky_relu_matches_jax():
    rng = np.random.RandomState(7)
    x4, b = rng.randn(2, 3, 4, 4).astype(np.float32), rng.randn(3).astype(np.float32)
    x2, b2 = rng.randn(5, 6).astype(np.float32), rng.randn(6).astype(np.float32)
    for x, bias in ((x4, b), (x2, b2)):
        want = np.asarray(jops.fused_leaky_relu(jnp.asarray(x), jnp.asarray(bias)))
        np.testing.assert_allclose(tops.fused_leaky_relu(_t(x), _t(bias)).numpy(), want, atol=ATOL)
    want = np.asarray(jops.scaled_leaky_relu(jnp.asarray(x4)))
    np.testing.assert_allclose(tops.scaled_leaky_relu(_t(x4)).numpy(), want, atol=ATOL)
