"""The eval slice of the PyTorch port against the JAX package at
`tiny_full_config`: image loading, image and video files, the mesh and rasterizer helpers,
`Runner.validation`, `render_hdtf`, `render_video_projected_noise`,
`render_depth_mesh`, the partial perceptual checkpoints and the eval CLI.

One seeded state dict (`test_torch_models.seeded_variables`, NoiseInjection
weights zero where the JAX side draws its own decoder noise) feeds both
sides; the perceptual nets load the same seeded `.pth` files on both sides.

Tolerances: `load_image`, image grids and GIF videos exactly (Pillow on both
sides); the mesh helpers 1e-6; the rasterizer and the noise projection exactly (the JAX source built
as the port builds its own, without fused multiply-adds; the JAX package's
own library, built with -march=native, contracts and differs by rounding);
validation scores 1e-3 absolute and PSNR 0.05 dB (the images agree to 1e-3,
tests/test_torch_pipeline.py); video frames 1e-3; depth-mesh frames 1e-3 on
at least 99% of the pixels (a z-buffer edge may flip a pixel); LPIPS and ID
1e-4."""

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_models import seeded_variables
from test_torch_training import _seeded_sd

from e3dge_torch import config as tc
from e3dge_torch import eval as teval
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.render.camera import camera_params_from_angles as t_cam
from e3dge_torch.runner import Runner
from e3dge_torch.training import data as tdata
from e3dge_torch.training import perceptual as tp
from e3dge_torch.utils import editing as tedit
from e3dge_torch.utils import image_io as tio
from e3dge_torch.utils import mesh as tmesh
from e3dge_torch.utils.weights import load_jax_variables
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.render.camera import camera_params_from_angles as j_cam
from e3dge_tpu.runner import Runner as JRunner
from e3dge_tpu.training import data as jdata
from e3dge_tpu.training import perceptual as jp
from e3dge_tpu.training.train_utils import make_noise as j_make_noise
from e3dge_tpu.utils import image_io as jio
from e3dge_tpu.utils import mesh as jmesh

REPO = Path(__file__).resolve().parents[1]
IMG_ATOL, SCORE_ATOL, PSNR_ATOL_DB, PERCEPTUAL_ATOL = 1e-3, 1e-3, 0.05, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as tests/test_torch_training.py: in a
    parallel test run more threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ shared set-up


def image_folder(root: Path, n: int = 5, size: int = 32, seed: int = 0) -> Path:
    """n seeded RGB PNGs 0.png .. written by Pillow."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(root / f"{i}.png")
    return root


def perceptual_files(root: Path) -> tuple[Path, Path]:
    """Seeded LPIPS and ArcFace state dicts, every key, saved as .pth."""
    lp, idl = tp.make_perceptual_fns("cpu")
    paths = root / "lpips.pth", root / "arcface.pth"
    torch.save(_seeded_sd(lp.state_dict(), 1), paths[0])
    torch.save(_seeded_sd(idl.facenet.state_dict(), 2), paths[1])
    return paths


def runner_pair(setup, root: Path, perceptual: bool = True, seed: int = 0):
    """(JAX runner, port runner, seeded variables, mean latents) on one seeded
    state dict (`seeded_variables(..., seed)`) and one pair of perceptual files."""
    cfg, _, variables, _ = setup
    vs = seeded_variables(variables, seed)
    rng = np.random.RandomState(11)
    ml = ((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32),
          (0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32))
    fns = (None, None), (None, None)
    if perceptual:
        p_lp, p_arc = perceptual_files(root)
        fns = (jp.make_perceptual_fns(image_size=min(cfg.decoder.size, 256), lpips_ckpt=str(p_lp),
                                      arcface_ckpt=str(p_arc)),
               tp.make_perceptual_fns("cpu", lpips_ckpt=p_lp, arcface_ckpt=p_arc))
    jr = JRunner(cfg, vs, JLM(jnp.asarray(ml[0]), jnp.asarray(ml[1])), work_dir=root / "jax",
                 lpips_fn=fns[0][0], id_fn=fns[0][1])
    tm = TE3DGE(tc.tiny_full_config(), device="cpu")
    load_jax_variables(tm, vs)
    tr = Runner(tm, TLM(torch.from_numpy(ml[0]), torch.from_numpy(ml[1])), "cpu", work_dir=root / "port",
                lpips_fn=fns[1][0], id_fn=fns[1][1])
    return jr, tr, vs, ml


@pytest.fixture(scope="module")
def pair(tiny_full_setup, tmp_path_factory):
    return runner_pair(tiny_full_setup, tmp_path_factory.mktemp("eval"))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return image_folder(tmp_path_factory.mktemp("imgs"))


def _x(cfg, batch: int, seed: int) -> np.ndarray:
    L = cfg.pifu.load_size
    return np.clip(0.3 * np.random.RandomState(seed).randn(batch, 3, L, L), -1, 1).astype(np.float32)


# ---------------------------------------------------------------- image files


@pytest.mark.parametrize("mode,shape", [("RGB", (32, 32)), ("RGB", (64, 64)), ("RGB", (40, 48)), ("RGB", (20, 20)),
                                        ("RGBA", (64, 64)), ("L", (48, 48)), ("LA", (32, 32))])
def test_load_image_matches_jax(tmp_path, mode, shape):
    """PNGs of each mode, read at the load size (32) and resized down or up,
    and a JPEG: the port's pixels equal the JAX package's."""
    rng = np.random.RandomState(3)
    c = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    arr = (rng.rand(*shape, c) * 255).astype(np.uint8)
    img = Image.fromarray(arr[..., 0] if c == 1 else arr, mode=mode)
    img.save(tmp_path / "a.png")
    got, want = tdata.load_image(tmp_path / "a.png", 32), jdata.load_image(tmp_path / "a.png", 32)
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 32, 32)
    np.testing.assert_array_equal(got, want)
    if mode == "RGB":
        img.save(tmp_path / "a.jpg")
        np.testing.assert_array_equal(tdata.load_image(tmp_path / "a.jpg", 32), jdata.load_image(tmp_path / "a.jpg", 32))


def test_save_image_grid_and_panel_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    imgs = rng.uniform(-1.2, 1.2, (3, 3, 8, 8)).astype(np.float32)
    tio.save_image_grid(tmp_path / "port.png", imgs, nrow=2)
    jio.save_image_grid(tmp_path / "jax.png", imgs, nrow=2)
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert want.shape == (16, 16, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), want)
    rows = {"gt": imgs[:2], "thumb": imgs[:2, :, :4, :4]}
    tio.save_panel(tmp_path / "p.png", rows)
    jio.save_panel(tmp_path / "q.png", rows)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")), np.asarray(Image.open(tmp_path / "q.png")))


@pytest.mark.parametrize("blocked", [(), ("cv2",), ("cv2", "PIL")])
def test_write_video_returns_the_file_it_wrote(tmp_path, monkeypatch, blocked):
    """The JAX chain: OpenCV's mp4v, else a Pillow GIF of 4 frames (the same
    bytes as the JAX package's), else an ImportError."""
    for name in blocked:
        monkeypatch.setitem(sys.modules, name, None)
    frames = np.random.RandomState(6).uniform(-1, 1, (4, 3, 16, 24)).astype(np.float32)
    if "PIL" in blocked:
        with pytest.raises(ImportError):
            tio.write_video(tmp_path / "v.mp4", frames, fps=10)
        return
    suffix = ".gif"
    if not blocked:
        try:
            import cv2  # noqa: F401

            suffix = ".mp4"
        except ImportError:
            pass
    path = tio.write_video(tmp_path / "v.mp4", frames, fps=10)
    jpath = jio.write_video(tmp_path / "jax" / "v.mp4", frames, fps=10)
    assert path.name == jpath.name and path.suffix == suffix and path.exists() and path.stat().st_size > 0
    if suffix == ".gif":
        assert path.read_bytes() == jpath.read_bytes()
        monkeypatch.undo()
        with Image.open(path) as im:
            assert im.n_frames == 4
            for i in range(4):
                im.seek(i)
                assert np.asarray(im.convert("RGB")).shape == (16, 24, 3)


def test_eval_dataset_sorts_and_batches_as_jax(tmp_path):
    rng = np.random.RandomState(7)
    for name in ("10.png", "2.png", "img_1.png", "b.png", "a3.png"):
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(tmp_path / name)
    (tmp_path / "notes.txt").write_text("not an image")
    got, want = tdata.EvalImageDataset(tmp_path, 32), jdata.EvalImageDataset(tmp_path, 32)
    assert [p.name for p in got.paths] == [p.name for p in want.paths] == ["b.png", "img_1.png", "2.png", "a3.png",
                                                                          "10.png"]
    for g, w in zip(got.iter_batches(2), want.iter_batches(2), strict=True):
        assert g["img_path"] == w["img_path"]
        np.testing.assert_array_equal(g["image"], w["image"])
    with pytest.raises(FileNotFoundError):
        tdata.EvalImageDataset(tmp_path / "empty", 32)


# ----------------------------------------------------------- mesh and raster


def sphere_mesh(radius: float = 0.08, n: int = 12):
    """A closed mesh in scene coordinates (the `extract_mesh` convention)."""
    g = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sdf = (np.sqrt(x**2 + y**2 + z**2) - radius / 0.12).astype(np.float32)
    return tmesh.extract_mesh(sdf)


def random_screen_mesh(seed: int, w: int = 40, h: int = 32, nv: int = 60, nf: int = 90):
    """Seeded triangles over an h x w image, some past its border, with a bad
    index and a degenerate face."""
    rng = np.random.RandomState(seed)
    verts = np.concatenate([rng.uniform(-3, w + 3, (nv, 1)), rng.uniform(-3, h + 3, (nv, 1)),
                            rng.uniform(0.5, 2.0, (nv, 1))], 1).astype(np.float32)
    faces = rng.randint(0, nv, (nf, 3)).astype(np.int32)
    faces[3] = [0, 0, 1]
    faces[7] = [1, 2, nv + 5]
    return verts, faces, rng.randn(nv).astype(np.float32)


@pytest.fixture(scope="module")
def jax_lib_no_fma(tmp_path_factory):
    """The JAX package's marching.cpp built with the port's flags (no fused
    multiply-adds), with the argument types the JAX loader declares."""
    jax_lib = jmesh._load_native()
    out = tmp_path_factory.mktemp("jaxlib") / "libmarching_jax.so"
    cxx = shutil.which(os.environ.get("CXX", "")) or shutil.which("c++") or shutil.which("g++")
    subprocess.run([cxx, "-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(out),
                    str(REPO / "e3dge_tpu" / "native" / "marching.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name in ("rasterize", "march_tetrahedra"):
        getattr(lib, name).argtypes = getattr(jax_lib, name).argtypes
        getattr(lib, name).restype = getattr(jax_lib, name).restype
    return lib


def test_mesh_helpers_match_jax():
    rng = np.random.RandomState(8)
    xyz = rng.uniform(-0.1, 0.1, (6, 7, 3)).astype(np.float32)
    (tv, tf), (jv, jf) = tmesh.xyz2mesh(xyz), jmesh.xyz2mesh(xyz)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tmesh.vertex_normals(tv, tf), jmesh.vertex_normals(jv, jf), atol=1e-6)
    n = tmesh.vertex_normals(tv, tf)
    cam = np.array([0.3, 0.1, 0.95], np.float32)
    np.testing.assert_allclose(tmesh.phong_vertex_intensity(tv, n, cam), jmesh.phong_vertex_intensity(jv, n, cam),
                               atol=1e-6)
    calib = np.asarray(j_cam(jnp.asarray([0.2]), jnp.asarray([-0.1]), 64).calibs[0])
    np.testing.assert_allclose(tmesh.project_to_screen(tv, calib, 64, 48), jmesh.project_to_screen(jv, calib, 64, 48),
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_matches_the_reference_and_jax(jax_lib_no_fma, monkeypatch, seed):
    verts, faces, color = random_screen_mesh(seed)
    got = tmesh.rasterize(verts, faces, color, 32, 40)
    want_jax = jmesh.rasterize(verts, faces, color, 32, 40)  # its own -march=native build
    for g, r in zip(got, tmesh.rasterize_reference(verts, faces, color, 32, 40)):
        np.testing.assert_array_equal(g, r)
    assert (got[1] > 0).mean() > 0.3
    monkeypatch.setattr(jmesh, "_LIB", jax_lib_no_fma)
    for g, w in zip(got, jmesh.rasterize(verts, faces, color, 32, 40)):
        np.testing.assert_array_equal(g, w)
    # the JAX package's own library rounds differently at some pixels only
    assert ((got[1] > 0) == (want_jax[1] > 0)).mean() >= 0.99
    both = (got[1] > 0) & (want_jax[1] > 0)
    np.testing.assert_allclose(got[0][both], want_jax[0][both], atol=1e-5)


def test_project_noise_matches_jax(jax_lib_no_fma, monkeypatch):
    monkeypatch.setattr(jmesh, "_LIB", jax_lib_no_fma)
    verts, faces = sphere_mesh()
    assert len(verts) > 100
    rng = np.random.RandomState(9)
    calib = np.asarray(j_cam(jnp.asarray([0.15]), jnp.asarray([0.05]), 32).calibs[0])
    noise = rng.randn(1, 1, 32, 32).astype(np.float32)
    (tn, tvn), (jn, jvn) = tmesh.project_noise(noise, verts, faces, calib), jmesh.project_noise(noise, verts, faces,
                                                                                                calib)
    np.testing.assert_array_equal(tvn, jvn)
    np.testing.assert_array_equal(tn, jn)
    covered = (tn != noise).mean()
    assert 0.05 < covered < 0.95, covered
    prev = rng.randn(1, 1, 32, 32).astype(np.float32)
    np.testing.assert_array_equal(tmesh.project_noise(noise, verts, faces, calib, tvn, prev)[0],
                                  jmesh.project_noise(noise, verts, faces, calib, jvn, prev)[0])


def test_rasterize_triangle():
    """tests/test_eval3d.py::test_rasterize_triangle on the port."""
    verts = np.array([[0, 0, 1.0], [8, 0, 1.0], [0, 8, 1.0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    color, depth = tmesh.rasterize(verts, faces, np.array([2.0, 2.0, 2.0], np.float32), 8, 8)
    assert color[1, 1] == 2.0 and depth[1, 1] == 1.0
    assert depth[7, 7] == 0.0
    verts2 = np.concatenate([verts, verts * np.array([1, 1, 0.5], np.float32)])
    faces2 = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    c2, d2 = tmesh.rasterize(verts2, faces2, np.array([2, 2, 2, 5, 5, 5], np.float32), 8, 8)
    assert c2[1, 1] == 5.0 and abs(d2[1, 1] - 0.5) < 1e-6


def test_project_noise_quad():
    """tests/test_eval3d.py::test_project_noise on the port (its camera)."""
    verts = np.array([[-0.02, -0.02, 0.0], [0.02, -0.02, 0.0], [0.02, 0.02, 0.0], [-0.02, 0.02, 0.0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    cam = t_cam(torch.zeros(1), torch.zeros(1), 64)
    noise = np.random.RandomState(10).randn(1, 1, 64, 64).astype(np.float32)
    out, _ = tmesh.project_noise(noise, verts, faces, cam.calibs[0].numpy())
    assert out.shape == noise.shape
    assert not np.allclose(out[0, 0, 28:36, 28:36], noise[0, 0, 28:36, 28:36])
    np.testing.assert_allclose(out[0, 0, :4, :4], noise[0, 0, :4, :4])


def test_xyz2mesh():
    verts, faces = tmesh.xyz2mesh(np.random.rand(4, 5, 3).astype(np.float32))
    assert verts.shape == (20, 3) and faces.shape == (2 * 3 * 4, 3)


def test_vertex_normals_and_phong():
    """tests/test_mesh.py::test_vertex_normals_and_phong on the port."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    n = tmesh.vertex_normals(verts, faces)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(n, np.tile([[0, 0, 1.0]], (3, 1)), atol=1e-6)
    cam = np.array([0, 0, 1.0], np.float32)
    lit, unlit = tmesh.phong_vertex_intensity(verts, n, cam), tmesh.phong_vertex_intensity(verts, -n, cam)
    assert np.all(lit > unlit)
    np.testing.assert_allclose(unlit, 0.1, atol=1e-6)
    assert np.all((lit >= 0) & (lit <= 1))


def test_project_to_screen_center():
    screen = tmesh.project_to_screen(np.array([[0, 0, -1.0]], np.float32), np.eye(4, dtype=np.float32), 64, 64)
    np.testing.assert_allclose(screen[0, :2], [32.0, 32.0], atol=1e-5)
    assert screen[0, 2] > 0


# --------------------------------------------------------------- the runner


def test_validation_matches_jax(pair, folder):
    """5 PNGs at batch 2 (a ragged last batch) with LPIPS and ID; also the
    reference conventions of tests/test_runner.py::test_validation_scores."""
    jr, tr, _, _ = pair
    want = jr.validation(folder, batch_size=2)
    got = tr.validation(folder, batch_size=2, save_panels=True)
    assert set(got) == set(want) and {"loss_lpips", "id_sim", "mae_std", "ssim_std"} <= set(got)
    assert got["num_images"] == want["num_images"] == 5
    for k in set(got) - {"num_images", "sec_per_image"}:
        tol = PSNR_ATOL_DB if k == "psnr" else SCORE_ATOL
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    assert got["ssim"] >= got["ssim_std"] - 1e-6
    np.testing.assert_allclose(got["mae"], 2 * got["mae_std"], rtol=1e-4)
    saved = json.loads((tr.work_dir / "scores.json").read_text())
    assert len(saved) == 1 and saved[0]["num_images"] == 5
    panel = np.asarray(Image.open(tr.work_dir / "images_for_vis" / "val_0002.png"))
    assert panel.shape == (2 * 32, 5 * 32, 3)  # gt | rec | thumb | residual | aligned residual
    assert tr.validation(folder, batch_size=2, max_images=2)["num_images"] == 2


def test_render_hdtf_matches_jax(pair, folder):
    jr, tr, _, _ = pair
    want = jr.render_hdtf(folder, max_frames=5, batch_size=2)
    got = tr.render_hdtf(folder, max_frames=5, batch_size=2)
    assert got["num_frames"] == want["num_frames"] == 5 and Path(got["video"]).exists()
    g = np.load(Path(got["out_dir"]) / "HDTF_nvs_video.npy")
    w = np.load(Path(want["out_dir"]) / "HDTF_nvs_video.npy")
    assert g.shape == w.shape == (5, 3, 32, 32)
    np.testing.assert_allclose(g, w, atol=IMG_ATOL)
    # the trajectory moves the camera: consecutive frames of one image differ
    assert np.abs(g[0] - g[1]).max() > 1e-3


def _with_noise_weights(vs: dict, value: float) -> dict:
    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}/{k}") if isinstance(v, dict) else
                (np.full_like(v, value) if f"{prefix}/{k}".endswith("noise/weight") else v) for k, v in tree.items()}

    return walk(vs, "")


def test_render_video_projected_noise_matches_jax(pair, monkeypatch, tmp_path):
    """Live decoder noise weights and JAX's own base noise on both sides; the
    seeded tiny SDF has no surface, so both runners get one sphere mesh (the
    port's latent2surface still runs, at the estimated camera)."""
    jr, tr, vs, ml = pair
    cfg = tr.cfg
    live = _with_noise_weights(vs, 0.5)
    tm = TE3DGE(tc.tiny_full_config(), device="cpu")
    load_jax_variables(tm, live)
    runner = Runner(tm, tr.mean_latents, "cpu", work_dir=tmp_path)
    verts, faces = sphere_mesh()
    cams, real_surface = [], runner.latent2surface

    def port_surface(latents, camera=None):
        cams.append(camera)
        real_surface(latents, camera)
        return [(verts, faces)]

    monkeypatch.setattr(runner, "latent2surface", port_surface)
    monkeypatch.setattr(jr, "latent2surface", lambda latents, camera=None: [(verts, faces)])
    monkeypatch.setattr(jr, "variables", live)
    x = _x(cfg, 1, 12)
    base = j_make_noise(jax.random.key(0), cfg.decoder.size, cfg.decoder.in_res, batch=1)
    base_t = [torch.from_numpy(np.asarray(n)) for n in base]
    want = jr.render_video_projected_noise(x, n_views=3)
    got = runner.render_video_projected_noise(torch.from_numpy(x), n_views=3, noise=base_t)
    assert tuple(got.shape) == want.shape == (1, 3, 3, cfg.decoder.size, cfg.decoder.size)
    np.testing.assert_allclose(got.numpy(), want, atol=IMG_ATOL)
    assert len(cams) == 1 and cams[0] is not None
    # the projected noise shows: an empty mesh (the base noise) renders otherwise
    monkeypatch.setattr(runner, "latent2surface", lambda latents, camera=None: [(verts[:0], faces[:0])])
    plain = runner.render_video_projected_noise(torch.from_numpy(x), n_views=3, noise=base_t)
    assert float((plain - got).abs().max()) > 1e-2
    with pytest.raises(ValueError):
        runner.render_video_projected_noise(torch.zeros(2, 3, 32, 32))


def test_render_depth_mesh_matches_jax(pair):
    jr, tr, _, _ = pair
    x = _x(tr.cfg, 2, 13)
    for kw in (dict(), dict(trajectory_location=(0.2, -0.1), filter_out_bg=False)):
        want = jr.render_depth_mesh(images=x, image_size=64, **kw)
        got = tr.render_depth_mesh(images=torch.from_numpy(x), image_size=64, **kw)
        assert got.shape == want.shape == (2, 64, 64) and got.dtype == np.float32
        assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
        assert (np.abs(got - want) <= 1e-3).mean() >= 0.99
        assert got.std() > 1e-3


# --------------------------------------------------------- perceptual files


def test_perceptual_checkpoints_load_partially(tmp_path):
    """As the JAX ingestion: a file with a subset of the keys (the LPIPS alex
    .pth holds only the linear heads) fills those, keeps the seeded value of
    the others and ignores keys the net does not have; a wrong shape raises.
    The strict loader this replaces refused the subset."""
    seeded_lp, seeded_id = tp.make_perceptual_fns("cpu")
    full_lp = _seeded_sd(seeded_lp.state_dict(), 1)
    heads = {k: v for k, v in full_lp.items() if k.startswith("lin")}
    heads["lin9.model.1.weight"] = torch.ones(1)
    torch.save(heads, tmp_path / "heads.pth")
    body = {k: v for k, v in _seeded_sd(seeded_id.facenet.state_dict(), 2).items() if k.startswith("body.")}
    for lp, idl in (tp.make_perceptual_fns("cpu", lpips_state_dict=heads, arcface_state_dict=body),
                    tp.make_perceptual_fns("cpu", lpips_ckpt=tmp_path / "heads.pth", arcface_state_dict=body)):
        for net, seeded, part in ((lp, seeded_lp, heads), (idl.facenet, seeded_id.facenet, body)):
            sd, ref = net.state_dict(), seeded.state_dict()
            for k in sd:
                torch.testing.assert_close(sd[k], part[k] if k in part else ref[k], rtol=0, atol=0, msg=k)
    assert len(tp.load_partial(tp.LPIPS(), heads)) == len(full_lp) - 5
    bad = dict(heads)
    bad["lin0.model.1.weight"] = torch.ones(1, 3, 1, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.make_perceptual_fns("cpu", lpips_state_dict=bad)


def test_full_perceptual_files_match_jax(pair):
    jr, tr, _, _ = pair
    rng = np.random.RandomState(14)
    a = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    with torch.no_grad():
        got_lp = tr.lpips_fn(torch.from_numpy(a), torch.from_numpy(b), per_sample=True).numpy()
        got_id = tr.id_fn(torch.from_numpy(a), torch.from_numpy(b), per_sample=True)[1].numpy()
    np.testing.assert_allclose(got_lp, np.asarray(jr.lpips_fn(jnp.asarray(a), jnp.asarray(b), per_sample=True)),
                               atol=PERCEPTUAL_ATOL, rtol=PERCEPTUAL_ATOL)
    np.testing.assert_allclose(got_id, np.asarray(jr.id_fn(jnp.asarray(a), jnp.asarray(b), per_sample=True)[1]),
                               atol=PERCEPTUAL_ATOL)
    assert got_lp.min() > 1e-2


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = image_folder(root / "imgs")
    rng = np.random.RandomState(15)
    cfg = tc.tiny_full_config()
    for attr in tedit.ATTRS[:4]:
        for space, dim in (("renderer", cfg.renderer.style_dim), ("decoder", cfg.decoder.style_dim)):
            (root / "bounds" / f"{space}_{attr}").mkdir(parents=True)
            np.save(root / "bounds" / f"{space}_{attr}" / "boundary.npy", rng.randn(1, dim).astype(np.float32))
    lp, _ = tp.make_perceptual_fns("cpu")
    torch.save({k: v for k, v in _seeded_sd(lp.state_dict(), 1).items() if k.startswith("lin")}, root / "lpips.pth")
    return data, root


def _finite(path: Path, shape: tuple) -> np.ndarray:
    a = np.load(path)
    assert a.shape == shape and np.isfinite(a).all(), (path, a.shape)
    return a


@pytest.mark.parametrize("mode", teval.MODES)
def test_eval_cli_mode_on_the_cpu(cli_inputs, tmp_path, mode):
    data, root = cli_inputs
    base = ["--tiny", "--device", "cpu", "--data", str(data), "--out", str(tmp_path), "--batch", "2"]
    if mode == "metrics":
        assert teval.main(base + ["--mode", "metrics", "--lpips-ckpt", str(root / "lpips.pth")]) == 0
        (scores,) = json.loads((tmp_path / "scores.json").read_text())
        assert scores["num_images"] == 5 and all(np.isfinite(v) for v in scores.values())
        assert {"loss_lpips", "id_sim"} <= set(scores)
    elif mode == "project":
        args = ["--mode", "project", "--batch", "1", "--max-images", "2", "--project-steps", "2", "--pti",
                "--pti-steps", "1", "--no-perceptual"]
        assert teval.main(base + args) == 0
        for stem in ("0", "1"):
            for name in ("latent_in.npz", "rec.png", "pti_g.pt"):
                assert (tmp_path / "projection" / stem / name).exists()
        assert np.asarray(Image.open(tmp_path / "projection" / "0" / "rec.png")).shape == (32, 32, 3)
        assert teval.main(base + ["--mode", "metrics", "--projection-root", str(tmp_path / "projection"), "--pti",
                                  "--no-perceptual"]) == 0
        (scores,) = json.loads((tmp_path / "scores.json").read_text())
        assert scores["projection_validation"] is True and scores["num_images"] == 2
    elif mode == "video":
        assert teval.main(base + ["--mode", "video", "--views", "3"]) == 0
        _finite(tmp_path / "video_frames.npy", (2, 3, 3, 32, 32))
        assert len(list((tmp_path / "videos").iterdir())) == 2
    elif mode == "edit":
        assert teval.main(base + ["--mode", "edit", "--boundaries", str(root / "bounds")]) == 0
        _finite(tmp_path / "edited.npy", (2, 3, 32, 32))
    elif mode == "mesh":
        assert teval.main(base + ["--mode", "mesh"]) == 0
        assert sorted(p.name for p in tmp_path.glob("*.obj")) == ["mesh_0.obj", "mesh_1.obj"]
    else:
        assert teval.main(base + ["--mode", "hdtf", "--max-images", "5"]) == 0
        _finite(tmp_path / "trajectory_videos" / "HDTF_nvs_video.npy", (5, 3, 32, 32))


def test_eval_cli_runs_as_a_module_and_defaults_to_the_card(cli_inputs, tmp_path):
    data, _ = cli_inputs
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    args = [sys.executable, "-m", "e3dge_torch.eval", "--tiny", "--data", str(data), "--out", str(tmp_path),
            "--mode", "mesh", "--batch", "1"]
    proc = subprocess.run(args + ["--device", "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "mesh_0.obj").exists()
    if torch.cuda.is_available():
        return
    proc = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
