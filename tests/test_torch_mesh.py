"""The port's mesh path against the JAX package's: the trilinear sampler and
the frustum-to-cube alignment (1e-5 abs: a few f32 multiply-adds per
output), the numpy marching tetrahedra against the JAX package's (the same
triangles in the same order, vertices to 1e-5), the native library against
the numpy version, and the .obj export."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3dge_torch.ops import grid_sample_3d as t_grid_sample_3d
from e3dge_torch.utils import mesh as tmesh
from e3dge_tpu.ops.grid_sample import grid_sample_3d as j_grid_sample_3d
from e3dge_tpu.utils import mesh as jmesh

ATOL = 1e-5


def _sphere_sdf(n=12, r=0.35):
    g = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x**2 + y**2 + z**2) - r).astype(np.float32)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_3d_matches_jax(padding_mode):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 5, 6, 7).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 3, 5, 3)).astype(np.float32)  # some outside the volume
    want = np.asarray(j_grid_sample_3d(jnp.asarray(x), jnp.asarray(grid), padding_mode=padding_mode))
    got = t_grid_sample_3d(torch.from_numpy(x), torch.from_numpy(grid), padding_mode=padding_mode).numpy()
    assert got.shape == want.shape == (2, 3, 4, 3, 5)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_align_volume_matches_jax():
    sdf = np.random.RandomState(1).randn(2, 8, 7, 6, 1).astype(np.float32)
    want = np.asarray(jmesh.align_volume(jnp.asarray(sdf)))
    got = tmesh.align_volume(torch.from_numpy(sdf)).numpy()
    assert got.shape == sdf.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got == 1.0).any() and (got != 1.0).any()  # outside the frustum set to +1, the rest sampled


def test_march_reference_matches_jax_numpy():
    sdf = _sphere_sdf(10)
    want = jmesh._march_numpy(sdf)
    got = tmesh.march_reference(sdf)
    assert len(got) == len(want) > 100
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_native_march_matches_reference():
    sdf = _sphere_sdf(10)
    got, want = tmesh.march(sdf), tmesh.march_reference(sdf)
    assert got.dtype == np.float32 and len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # an empty surface gives no triangles
    assert tmesh.march(np.ones((4, 4, 4), np.float32)).shape == (0, 3, 3)


def test_marching_library_build_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(tmesh, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="compiler"):
        tmesh.build_marching_library()


def test_extract_mesh_and_obj_round_trip(tmp_path):
    sdf = _sphere_sdf(16)
    verts, faces = tmesh.extract_mesh(sdf)
    want_v, want_f = jmesh.extract_mesh(sdf)
    assert len(faces) > 100 and faces.max() < len(verts)
    np.testing.assert_allclose(verts, want_v, atol=ATOL)
    np.testing.assert_array_equal(faces, want_f)
    assert np.abs(verts).max() <= 0.12 + 1e-5  # scene scale
    path = tmp_path / "mesh.obj"
    tmesh.save_obj(path, verts, faces)
    v2, f2 = tmesh.load_obj(path)
    np.testing.assert_allclose(v2, verts, atol=1e-6)  # 6 decimals in the file
    np.testing.assert_array_equal(f2, faces)
