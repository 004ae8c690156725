"""The port's ShapeNet loader and offline tools against the JAX package:
`training/data.py::ShapeNetDataset` on test_components.py:186's fixture
(equal arrays); `python -m e3dge_torch.tools.calc_losses` in every mode on
seeded PNG pairs against `scripts/calc_losses.py` run as a subprocess on the
same folders (l2, ssim, ssim_ref and mae_ref within 1e-5, psnr within 1e-5
relative: at 20-34 dB an f32 psnr's last place is 2e-6-4e-6, and the mean
of squares summed in another order moves it by a few places; lpips and id
through one pair of seeded perceptual .pth files that both read, within
1e-4 of their scale, the conv-stack tolerance of test_torch_models.py); and
`python -m e3dge_torch.tools.gallery_video`'s `mix_tex_geo` / `tile` equal to
`scripts/gallery_video.py`'s (test_video_tools.py:28), its CLI writing a
video that reads back."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image
from test_torch_eval import perceptual_files

from e3dge_torch.tools import calc_losses as tcl
from e3dge_torch.tools import gallery_video as tgv
from e3dge_torch.training.data import ShapeNetDataset as TShapeNet
from e3dge_tpu.training.data import ShapeNetDataset as JShapeNet

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
TOL = {"l2": 1e-5, "ssim": 1e-5, "ssim_ref": 1e-5, "mae_ref": 1e-5}


def test_shapenet_dataset_matches_jax(tmp_path):
    (tmp_path / "renders").mkdir()
    (tmp_path / "pose").mkdir()
    rng = np.random.RandomState(0)
    names = []
    for i in range(3):
        Image.fromarray((rng.rand(20, 20, 3) * 255).astype("uint8")).save(tmp_path / "renders" / f"v{i}.png")
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
        pose[:3, 3] = rng.randn(3)
        np.savetxt(tmp_path / "pose" / f"v{i}.txt", pose)
        names.append(f"renders/v{i}.png")
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n\n")
    for zero_pose in (True, False):
        want = list(JShapeNet(tmp_path / "list.txt", size=16, zero_pose=zero_pose).iter_batches(2))
        got = list(TShapeNet(tmp_path / "list.txt", size=16, zero_pose=zero_pose).iter_batches(2))
        assert [len(b["img_path"]) for b in got] == [2, 1]
        for g, w in zip(got, want):
            assert g["img_path"] == w["img_path"]
            for k in ("image", "poses", "extrinsics"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    zeroed = TShapeNet(tmp_path / "list.txt", size=16)[1]
    np.testing.assert_array_equal(zeroed["poses"], np.eye(4, dtype=np.float32)[:3])
    assert not np.allclose(TShapeNet(tmp_path / "list.txt", size=16, zero_pose=False)[1]["poses"], np.eye(4)[:3])
    (tmp_path / "empty.txt").write_text("\n")
    with pytest.raises(FileNotFoundError, match="empty ShapeNet list"):
        TShapeNet(tmp_path / "empty.txt")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """5 seeded result / ground-truth PNG pairs of 48^2 (smooth images plus
    noise, the ground truth a perturbed copy), one result without its
    ground truth, and one pair of seeded perceptual .pth files."""
    root = tmp_path_factory.mktemp("calc_losses")
    res, gt = root / "results", root / "gt"
    res.mkdir()
    gt.mkdir()
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:48, 0:48] / 48.0
    for i in range(5):
        base = 0.5 + 0.4 * np.sin(2 * np.pi * (xx * (i + 1) + yy))[..., None] * rng.uniform(0.3, 1.0, 3)
        a = np.clip(base + 0.05 * rng.randn(48, 48, 3), 0, 1)
        b = np.clip(a + (0.02 + 0.03 * i) * rng.randn(48, 48, 3), 0, 1)
        Image.fromarray((a * 255).astype(np.uint8)).save(res / f"{i}.png")
        Image.fromarray((b * 255).astype(np.uint8)).save(gt / f"{i}.png")
    Image.fromarray(np.zeros((48, 48, 3), np.uint8)).save(res / "orphan.png")
    return root, perceptual_files(root)


@pytest.fixture(scope="module")
def jax_scores(folders):
    """scripts/calc_losses.py in every mode, one subprocess each, all at
    once; its id mode at batch size 1 (at a larger batch the JAX script
    converts the (loss, similarity) pair its id net returns, and fails)."""
    root, (p_lp, p_arc) = folders
    procs = {}
    for mode in tcl.MODES:
        argv = [sys.executable, str(REPO / "scripts" / "calc_losses.py"), "--mode", mode, "--data-path",
                str(root / "results"), "--gt-path", str(root / "gt"), "--size", "48", "--out", str(root / "jax"),
                "--batch-size", "1" if mode == "id" else "2", "--lpips-ckpt", str(p_lp), "--arcface-ckpt", str(p_arc)]
        procs[mode] = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                       env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    for mode, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out[-3000:]
    return {m: json.loads((root / "jax" / f"scores_{m}.json").read_text()) for m in tcl.MODES}


@pytest.mark.parametrize("mode", tcl.MODES)
def test_calc_losses_matches_the_jax_script(folders, jax_scores, mode):
    root, (p_lp, p_arc) = folders
    out = root / "port"
    argv = ["--mode", mode, "--data-path", str(root / "results"), "--gt-path", str(root / "gt"), "--size", "48",
            "--out", str(out), "--batch-size", "2", "--lpips-ckpt", str(p_lp), "--arcface-ckpt", str(p_arc),
            "--device", "cpu"]
    assert tcl.main(argv) == 0
    got = json.loads((out / f"scores_{mode}.json").read_text())
    want = jax_scores[mode]
    assert list(got) == list(want) == [f"{i}.png" for i in range(5)]  # the orphan skipped
    g, w = np.array(list(got.values())), np.array(list(want.values()))
    if mode == "psnr":
        np.testing.assert_allclose(g, w, rtol=1e-5)
    else:
        np.testing.assert_allclose(g, w, atol=TOL.get(mode, 1e-4 * max(1.0, np.abs(w).max())))
    assert np.ptp(w) > 0  # the pairs differ, so do their scores
    stat = (out / f"stat_{mode}.txt").read_text()
    assert stat == f"Average loss is {g.mean():.4f}+-{g.std():.4f}"


def test_calc_losses_writes_beside_the_results_by_default(folders):
    root, _ = folders
    assert tcl.main(["--mode", "l2", "--data-path", str(root / "results"), "--gt-path", str(root / "gt"),
                     "--size", "48", "--device", "cpu"]) == 0
    assert set(json.loads((root / "inference_metrics" / "scores_l2.json").read_text())) == {f"{i}.png"
                                                                                            for i in range(5)}


def test_gallery_mix_and_tile_match_jax():
    from gallery_video import mix_tex_geo, tile

    rng = np.random.RandomState(0)
    tex = rng.uniform(-1, 1, (3, 2, 3, 4, 8)).astype(np.float32)
    for geo in (rng.uniform(-1, 1, (3, 2, 3, 2, 4)).astype(np.float32),
                rng.uniform(-1, 1, tex.shape).astype(np.float32)):
        mixed = tgv.mix_tex_geo(tex, geo)
        np.testing.assert_array_equal(mixed, mix_tex_geo(tex, geo))
        np.testing.assert_array_equal(mixed[..., :4], tex[..., :4])
    for cols in (1, 2, 3, 4):
        got = tgv.tile(tex, cols)
        np.testing.assert_array_equal(got, tile(tex, cols))
    grid = tgv.tile(np.ones((3, 2, 3, 4, 8), np.float32), cols=2)
    assert grid.shape == (2, 3, 8, 16) and np.all(grid[:, :, 4:, 8:] == -1)  # the 4th slot black


def test_gallery_video_cli_writes_a_video_that_reads_back(tmp_path):
    from e3dge_torch.utils.image_io import to_uint8

    rng = np.random.RandomState(1)
    frames = rng.uniform(-1, 1, (2, 4, 3, 16, 16)).astype(np.float32)
    geo = rng.uniform(-1, 1, (2, 4, 3, 8, 8)).astype(np.float32)
    np.save(tmp_path / "tex.npy", frames)
    np.save(tmp_path / "geo.npy", geo)
    assert tgv.main(["--frames", str(tmp_path / "tex.npy"), "--geo-frames", str(tmp_path / "geo.npy"), "--cols", "2",
                     "--bounce", "--fps", "5", "--out", str(tmp_path / "g.mp4")]) == 0
    out = next(tmp_path.glob("g.*"))
    want = tgv.tile(tgv.mix_tex_geo(frames, geo), 2)
    want = np.concatenate([want, want[::-1]])
    if out.suffix == ".gif":
        im = Image.open(out)
        assert im.n_frames == len(want) and im.size == (32, 16)
        im.seek(0)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), to_uint8(want[0]))
    else:
        import cv2

        cap = cv2.VideoCapture(str(out))
        n = 0
        while True:
            ok, f = cap.read()
            if not ok:
                break
            assert f.shape == (16, 32, 3)
            n += 1
        assert n == len(want)
