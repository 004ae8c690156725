"""The NoW 3D eval of the PyTorch port against the JAX package: the metrics
and the point-to-scan score of `training/eval3d.py`, the NoW loader, the scan
readers, `Runner.evaluate3d` at `tiny_full_config` on NoW's 224^2 crops, the
encoder path on those crops at the full width's 256^2 load size, and
`python -m e3dge_torch.eval --mode now`.

Tolerances: chamfer, depth and normal metrics rtol 1e-6; `umeyama` 1e-10
(f64 numpy on both sides); the nearest-vertex distances, `scan_to_mesh_distance`
and `now_scan_error` 1e-5 absolute in scan units (f32 searches); `icp_align`'s
(s, R, t) 1e-5; the readers and the NoW crops exactly; `evaluate3d`'s mesh
vertices the mesh tests' 1e-5 and its scores, on the same meshes, 1e-4
(`test_evaluate3d_matches_jax` says why on the same meshes). The eval3d helpers run
with device="cpu", the port's default being the card."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_now import _make_now_assets
from test_torch_eval import runner_pair
from test_torch_models import seeded_variables

from e3dge_torch import config as tc
from e3dge_torch import eval as teval
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.ops import adaptive_avg_pool
from e3dge_torch.training import eval3d as te
from e3dge_torch.training.now_data import NoWDataset as TNoW
from e3dge_torch.utils import mesh as tmesh
from e3dge_torch.utils.weights import load_jax_variables
from e3dge_tpu.models import e3dge as je3dge
from e3dge_tpu.ops.grid_sample import adaptive_avg_pool2d as j_adaptive_avg_pool2d
from e3dge_tpu.training import eval3d as je
from e3dge_tpu.training.now_data import NoWDataset as JNoW
from e3dge_tpu.utils import config as jc
from e3dge_tpu.utils import mesh as jmesh

MESH_ATOL, SCORE_ATOL, DIST_ATOL = 1e-5, 1e-4, 1e-5
# the encoder path at a 256^2 load size: the pooled crops, the latents
# (tests/test_torch_novel_view.py's 1e-4) and the field's outputs, with the
# residual and the hourglass volume downstream of them (3e-3,
# tests/test_golden_oracle.py:40-41)
POOL_ATOL, LATENT_ATOL, FIELD_ATOL = 1e-6, 1e-4, 3e-3
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _sphere_mesh(n_lat: int = 12, n_lon: int = 16, radius: float = 1.0):
    """A UV sphere (verts [V, 3] f32, faces [F, 3])."""
    th = np.linspace(0.15, np.pi - 0.15, n_lat)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts = np.stack([np.sin(th)[:, None] * np.cos(ph), np.sin(th)[:, None] * np.sin(ph),
                      np.cos(th)[:, None] * np.ones_like(ph)], -1).reshape(-1, 3) * radius
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            faces += [[a, b, a + n_lon], [b, b + n_lon, a + n_lon]]
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def _rotation(seed: int) -> np.ndarray:
    q, _ = np.linalg.qr(np.random.RandomState(seed).randn(3, 3))
    return q * np.sign(np.linalg.det(q))


# ------------------------------------------------------------------ metrics


def test_point_and_map_metrics_match_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(40, 3), rng.randn(55, 3)
    np.testing.assert_allclose(float(te.chamfer_distance(_t(a), _t(b))),
                               float(je.chamfer_distance(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))),
                               rtol=1e-6)
    ab, bb = rng.randn(3, 20, 3), rng.randn(3, 30, 3)
    np.testing.assert_allclose(te.batched_chamfer(_t(ab), _t(bb)).numpy(),
                               np.asarray(je.batched_chamfer(jnp.asarray(ab, jnp.float32), jnp.asarray(bb, jnp.float32))),
                               rtol=1e-6)
    d1, d2, m = rng.rand(2, 8, 8), rng.rand(2, 8, 8), (rng.rand(2, 8, 8) > 0.3).astype(np.float32)
    for mask in (None, m):
        got = te.depth_error(_t(d1), _t(d2), None if mask is None else _t(mask))
        want = je.depth_error(jnp.asarray(d1, jnp.float32), jnp.asarray(d2, jnp.float32),
                              None if mask is None else jnp.asarray(mask))
        for k in ("depth_l1", "depth_rmse"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    n1, n2 = rng.randn(2, 6, 6, 3), rng.randn(2, 6, 6, 3)
    for mask in (None, m[:, :6, :6]):
        got = te.normal_consistency(_t(n1), _t(n2), None if mask is None else _t(mask))
        want = je.normal_consistency(jnp.asarray(n1, jnp.float32), jnp.asarray(n2, jnp.float32),
                                     None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_matches_jax(with_scale):
    rng = np.random.RandomState(1)
    src = rng.randn(7, 3)
    dst = 1.7 * src @ _rotation(2).T + rng.randn(3) + 0.01 * rng.randn(7, 3)
    for got, want in zip(te.umeyama(src, dst, with_scale), je.umeyama(src, dst, with_scale)):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_nearest_vertex_and_scan_to_mesh_match_jax():
    verts, faces = _sphere_mesh()
    rng = np.random.RandomState(3)
    scan = (rng.randn(3000, 3) * 0.7).astype(np.float32)
    got_d, got_i = te._nearest_vertex_dist(_t(scan), _t(verts), chunk=512)
    want_d, want_i = je._nearest_vertex_dist(jnp.asarray(scan), jnp.asarray(verts), chunk=512)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=DIST_ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for k in (16, 3):  # 3: fewer slots than incident faces, the table keeps the first ones
        got = te.scan_to_mesh_distance(scan, verts, faces, max_incident=k, device=CPU)
        want = je.scan_to_mesh_distance(scan, verts, faces, max_incident=k)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=DIST_ATOL)
    assert np.isinf(te.scan_to_mesh_distance(scan[:4], verts, faces[:0], device=CPU)).all()


def test_icp_and_now_scan_error_match_jax():
    """The predicted mesh is the scan's surface under a seeded similarity:
    ICP's (s, R, t) and the scores of both alignments (ICP; landmarks)."""
    verts, faces = _sphere_mesh(20, 28)
    rng = np.random.RandomState(4)
    R = _rotation(5) @ _rotation(6)
    scan = 90.0 * verts.astype(np.float64) @ np.eye(3) + 0.5 * rng.randn(*verts.shape)
    pred = ((verts.astype(np.float64) - np.array([0.1, 0.0, 0.2])) @ R.T * 0.02).astype(np.float32)
    got = te.icp_align(pred, scan, device=CPU)
    want = je.icp_align(pred, scan)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
    np.testing.assert_allclose(te.now_scan_error(pred, faces, scan, device=CPU),
                               je.now_scan_error(pred, faces, scan), atol=DIST_ATOL)
    idx = [0, 50, 100, 150, 200, 250, 300]
    lms = scan[idx]
    np.testing.assert_allclose(te.now_scan_error(pred, faces, scan, pred_lms=pred[idx], scan_lms=lms, device=CPU),
                               je.now_scan_error(pred, faces, scan, pred_lms=pred[idx], scan_lms=lms), atol=DIST_ATOL)


# ------------------------------------------------------------- the readers


def _write_scan(root: Path, subject: str, n: int, seed: int) -> np.ndarray:
    """scans/<subject>/scan.obj (n points on a 90-unit sphere, with a face
    record the reader skips) and scans_lmks_onlypp/<subject>/lmks.pp (7 of
    them as MeshLab picked points)."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3)
    pts = 90.0 * pts / np.linalg.norm(pts, axis=1, keepdims=True)
    (root / "scans" / subject).mkdir(parents=True, exist_ok=True)
    (root / "scans_lmks_onlypp" / subject).mkdir(parents=True, exist_ok=True)
    with open(root / "scans" / subject / "scan.obj", "w") as f:
        f.write("# scan\n" + "".join(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n" for p in pts) + "f 1 2 3\n")
    with open(root / "scans_lmks_onlypp" / subject / "lmks.pp", "w") as f:
        f.write("<!DOCTYPE PickedPoints>\n<PickedPoints>\n"
                + "".join(f' <point x="{p[0]:.6f}" y="{p[1]:.6f}" z="{p[2]:.6f}" active="1" name="{i}"/>\n'
                          for i, p in enumerate(pts[:7]))
                + "</PickedPoints>\n")
    return pts


def test_readers_match_jax(tmp_path):
    _write_scan(tmp_path, "s", 50, 0)
    got = tmesh.load_obj_vertices(tmp_path / "scans" / "s" / "scan.obj")
    want = jmesh.load_obj_vertices(tmp_path / "scans" / "s" / "scan.obj")
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    pp = tmp_path / "scans_lmks_onlypp" / "s" / "lmks.pp"
    np.testing.assert_array_equal(te.parse_picked_points(pp), je.parse_picked_points(pp))
    lm98 = np.random.RandomState(1).rand(98, 2) * 224
    np.testing.assert_array_equal(te.landmark_98_to_7(lm98), je.landmark_98_to_7(lm98))


@pytest.mark.parametrize("crop_size", [224, 64])
def test_now_dataset_matches_jax(tmp_path, crop_size):
    _make_now_assets(tmp_path, n=3)
    got, want = TNoW(tmp_path, crop_size=crop_size), JNoW(tmp_path, crop_size=crop_size)
    assert len(got) == len(want) == 3
    for i in range(3):
        g, w = got[i], want[i]
        assert (g["imagename"], g["subject"]) == (w["imagename"], w["subject"])
        np.testing.assert_array_equal(g["image"], w["image"])
    for g, w in zip(got.iter_batches(2), want.iter_batches(2)):
        assert g["imagename"] == w["imagename"] and g["subject"] == w["subject"]
        np.testing.assert_array_equal(g["image"], w["image"])


def test_pool_of_sizes_that_do_not_divide():
    """NoW's 224^2 crops into a 256^2 model: torch's AdaptiveAvgPool2d bins
    (the JAX pool raises going down and keeps 224 going up); sizes that
    divide keep the box filter and the nearest repeat."""
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 224, 224).astype(np.float32))
    for out in (256, 64, 100):
        torch.testing.assert_close(adaptive_avg_pool(x, out), torch.nn.AdaptiveAvgPool2d(out)(x), rtol=0, atol=1e-6)
    torch.testing.assert_close(adaptive_avg_pool(x, 32), torch.nn.functional.avg_pool2d(x, 7), rtol=0, atol=0)
    torch.testing.assert_close(adaptive_avg_pool(x[..., :32, :32], 64),
                               x[..., :32, :32].repeat_interleave(2, 2).repeat_interleave(2, 3), rtol=0, atol=0)


def test_encoder_input_at_load_size_256_matches_jax_with_torch_bins(tiny_full_setup, tmp_path, monkeypatch):
    """NoW's 224^2 crops into a model with the full width's 256^2 load size
    (tiny_full_config otherwise): `encode_ref_images` pools them 224 -> 256 by
    AdaptiveAvgPool2d's bins, the reference's pool. The JAX pool emulates it
    only for sizes that divide (it keeps 224 here), so the JAX side runs with
    `e3dge_tpu.models.e3dge.adaptive_avg_pool` taking the package's own
    exact-bin `adaptive_avg_pool2d` where the sizes do not divide. The pooled
    input, the latents, the camera, the residual and the hourglass volume
    (what `evaluate3d` meshes and scores) against that run."""
    divisible_pool = je3dge.adaptive_avg_pool

    def torch_bins(x, out):
        h = x.shape[-1]
        return divisible_pool(x, out) if h == out or max(h, out) % min(h, out) == 0 \
            else j_adaptive_avg_pool2d(x, (out, out))

    monkeypatch.setattr(je3dge, "adaptive_avg_pool", torch_bins)
    _make_now_assets(tmp_path, n=2)
    x = next(TNoW(tmp_path).iter_batches(2))["image"]
    assert x.shape == (2, 3, 224, 224)
    _, _, variables, _ = tiny_full_setup
    vs = seeded_variables(variables, 1)
    rng = np.random.RandomState(11)
    cfg = jc._with(jc.tiny_full_config(), pifu=dict(load_size=256))
    ml = ((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32),
          (0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32))
    m = je3dge.E3DGE(cfg)
    want = jax.jit(lambda v, x, r, d: m.apply(v, x, je3dge.LatentMeans(r, d), method=je3dge.E3DGE.encode_ref_images,
                                              rngs={"noise": jax.random.key(4)}))(
        vs, *(jnp.asarray(a) for a in (x, *ml)))
    tm = TE3DGE(tc._with(tc.tiny_full_config(), pifu=dict(load_size=256)), device="cpu")
    load_jax_variables(tm, vs)
    with torch.no_grad():
        got = tm.encode_ref_images(torch.from_numpy(x), TLM(*(torch.from_numpy(a) for a in ml)))
    assert tuple(got["imgs"].shape) == (2, 3, 256, 256) == want["imgs"].shape
    np.testing.assert_allclose(got["imgs"].numpy(), np.asarray(want["imgs"]), atol=POOL_ATOL, rtol=0)
    for g, w in zip(got["pred_latents"], want["pred_latents"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LATENT_ATOL, rtol=0)
    for g, w in zip(got["cam_settings"], want["cam_settings"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LATENT_ATOL, rtol=0)
    np.testing.assert_allclose(got["orig_res_gt"].numpy(), np.asarray(want["orig_res_gt"]), atol=FIELD_ATOL, rtol=0)
    np.testing.assert_allclose(got["ref_view_aligned_feat"].numpy(), np.asarray(want["ref_view_aligned_feat"]),
                               atol=FIELD_ATOL, rtol=0)


# ---------------------------------------------------------- evaluate3d, CLI


def now_layout(root: Path, n_images: int = 3, scan_points: int = 900) -> Path:
    """tests/test_now.py's NoW layout (subject subj1, 640x480 JPEGs and their
    boxes) plus the subject's scan and landmarks."""
    _make_now_assets(root, n=n_images)
    _write_scan(root, "subj1", scan_points, 7)
    return root


def test_evaluate3d_matches_jax(tiny_full_setup, tmp_path, monkeypatch):
    """`Runner.evaluate3d` on one seeded state dict at tiny_full_config, the
    crops at NoW's 224^2, 3 images at batch 2 (a ragged last batch), a scan
    above max_scan_points (the strided subsample runs). The weights are
    seeded_variables' seed 1: its seed 0 leaves these crops without a surface.

    The meshes: the same names and triangle counts, and every vertex of each
    side within MESH_ATOL of the other's. The vertex lists themselves may
    differ by a duplicate or two: `weld` merges vertices rounded to 5
    decimals, and SDF grids that agree to ~6e-7 move a vertex lying within
    ~1e-6 of a rounding boundary across it. ICP samples the vertex list, so
    the scores are held on the same meshes: the port's run again, its
    `latent2surface` giving the JAX run's meshes, within SCORE_ATOL."""
    jr, tr, _, _ = runner_pair(tiny_full_setup, tmp_path, perceptual=False, seed=1)
    root = now_layout(tmp_path / "now")
    jax_meshes, jax_surface = [], jr.latent2surface

    def recording(*args, **kwargs):
        jax_meshes.append(jax_surface(*args, **kwargs))
        return jax_meshes[-1]

    monkeypatch.setattr(jr, "latent2surface", recording)
    want = jr.evaluate3d(root, batch_size=2, out_dir=tmp_path / "jax_meshes", max_scan_points=400)
    got = tr.evaluate3d(root, batch_size=2, out_dir=tmp_path / "port_meshes", max_scan_points=400)
    assert got["num_meshes"] == want["num_meshes"] == 3
    assert got["num_scored"] == want["num_scored"] == 3
    names = sorted(p.relative_to(tmp_path / "jax_meshes") for p in (tmp_path / "jax_meshes").rglob("*.obj"))
    assert names == sorted(p.relative_to(tmp_path / "port_meshes") for p in (tmp_path / "port_meshes").rglob("*.obj"))
    for name in names:
        gv, gf = tmesh.load_obj(tmp_path / "port_meshes" / name)
        wv, wf = tmesh.load_obj(tmp_path / "jax_meshes" / name)
        assert len(gf) == len(wf) > 0 and abs(len(gv) - len(wv)) <= 0.02 * len(wv)
        for a, b in ((gv, wv), (wv, gv)):
            assert float(te._nearest_vertex_dist(_t(a), _t(b))[0].max()) <= MESH_ATOL
    replay = iter(jax_meshes)
    monkeypatch.setattr(tr, "latent2surface", lambda latents, camera=None: next(replay))
    got = tr.evaluate3d(root, batch_size=2, out_dir=tmp_path / "port_on_jax_meshes", max_scan_points=400)
    for k in ("mean", "median", "std"):
        np.testing.assert_allclose(got[k], want[k], atol=SCORE_ATOL)
    assert json.loads((tmp_path / "port_on_jax_meshes" / "now_scores.json").read_text())["num_meshes"] == 3


def test_eval_cli_now_mode(tmp_path, capsys):
    root = now_layout(tmp_path / "now", n_images=2, scan_points=300)
    out = tmp_path / "out"
    assert teval.main(["--tiny", "--device", "cpu", "--data", str(root), "--mode", "now", "--batch", "2",
                       "--out", str(out)]) == 0
    scores = json.loads((out / "now_meshes" / "now_scores.json").read_text())
    assert scores["num_meshes"] == 2 and len(list((out / "now_meshes" / "subj1").glob("*.obj"))) == 2
    assert all(np.isfinite(scores[k]) for k in ("mean", "median", "std"))
    assert "'num_meshes': 2" in capsys.readouterr().out
