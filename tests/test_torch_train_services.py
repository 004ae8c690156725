"""The trainer's services of the PyTorch port: the training image folder,
the parameter audit and the metric log against the JAX package, the
checkpoints (`Runner.save_checkpoint` / `load_checkpoint`), and
`python -m e3dge_torch.training.train` in-process at tiny size on the CPU:
`--resume` replaying an uninterrupted run, `--data` as the D's reals,
panels off the training stream, `--debug-nans`, the perceptual warning.

No JAX program is compiled here: the JAX parameter shapes come from
`jax.eval_shape`. Tolerances: the image folder and its heatmaps 1e-7 (the
same numpy on both sides); a resumed run against the uninterrupted one rtol
1e-6 on every logged metric and every saved tensor (both are one process on
the CPU, so they agree to the bit in practice)."""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_eval import perceptual_files

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.runner import Runner
from e3dge_torch.training import data as tdata
from e3dge_torch.training import steps as ts
from e3dge_torch.training import train
from e3dge_torch.utils import logger as tlog
from e3dge_torch.utils.weights import init_weights
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.training import data as jdata
from e3dge_tpu.utils import config as jc
from e3dge_tpu.utils import logger as jlog

DATA_ATOL, RESUME_RTOL = 1e-7, 1e-6
CPU = ["--device", "cpu", "--tiny", "--batch", "2", "--log-every", "1"]
STAGE22 = ["--stage", "2.2", "--adv-lambda", "0.01", "--d-reg-every", "2", "--train-volume-d", "--optimizer", "ranger",
           "--ema"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def free_checkpoints(tmp_path):
    """Each run saves the whole model, optimizer and Ds (~0.5 GB at tiny
    size): the test's files go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _folder(root: Path, n: int = 5, size: int = 40, seed: int = 0) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(root / f"img{i}.png")
    return root


def _records(work: Path) -> list[dict]:
    return [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]


def _flat(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Every tensor and number of a saved checkpoint tree, by its path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return {prefix: torch.tensor(float(tree), dtype=torch.float64)}
    return {}


def _saved(ckpt: Path) -> dict[str, torch.Tensor]:
    return {k: v for f in ("variables.pt", "state.pt", "d_state.pt") if (ckpt / f).exists()
            for k, v in _flat(torch.load(ckpt / f, weights_only=True), f).items()}


# ------------------------------------------------------------ image folder


@pytest.mark.parametrize("n,res,sigma", [(5, 32, 2.0), (3, 16, 1.0)])
def test_landmark_heatmaps_match_jax(n, res, sigma):
    lms = np.random.RandomState(n).uniform(-4, res + 4, (n, 2)).astype(np.float32)  # some outside the image
    got, want = tdata.landmark_heatmaps(lms, res, sigma), jdata.landmark_heatmaps(lms, res, sigma)
    assert got.shape == (n, res, res) and (got.reshape(n, -1).max(1) == 0).any()
    np.testing.assert_allclose(got, want, atol=DATA_ATOL, rtol=0)


@pytest.mark.parametrize("with_lms", [False, True])
def test_image_folder_dataset_matches_jax(tmp_path, with_lms):
    """Items and endless batches (3 batches of 2 from 5 images: across a new
    pass's order), size 32 with 8^2 thumbs, with and without landmark
    heatmaps; the JAX flips from the global numpy state seeded as the
    port's RandomState."""
    root = _folder(tmp_path / "imgs")
    lms_root = None
    if with_lms:
        lms_root = tmp_path / "lms"
        lms_root.mkdir()
        rng = np.random.RandomState(1)
        for i in range(5):
            np.save(lms_root / f"img{i}.npy", rng.uniform(0, 40, (4, 2)).astype(np.float32))
    got = tdata.ImageFolderDataset(root, size=32, thumb_size=8, lms_root=lms_root, rng=np.random.RandomState(7))
    want = jdata.ImageFolderDataset(root, size=32, thumb_size=8, lms_root=lms_root)
    np.random.seed(7)
    items = [(got[i], want[i]) for i in (0, 3, 3, 1)]
    batches = []
    g_it, w_it = got.iter_batches(2, seed=3), want.iter_batches(2, seed=3)
    for _ in range(3):
        batches.append((next(g_it), next(w_it)))
    for g, w in items + batches:
        assert list(g) == list(w) == (["lms", "image", "thumb"] if with_lms else ["image", "thumb"])
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_allclose(g[k], w[k], atol=DATA_ATOL, rtol=0)
    assert batches[0][0]["image"].shape == (2, 3, 32, 32) and batches[0][0]["thumb"].shape == (2, 3, 8, 8)


# ------------------------------------------------------------ logger


def _jax_param_shapes(cfg):
    """The JAX model's params as shapes, traced by jax.eval_shape (nothing
    compiled)."""
    model = JE3DGE(cfg)
    imgs = jnp.zeros((2, 3, cfg.pifu.load_size, cfg.pifu.load_size))
    ml = JLM(jnp.zeros((1, cfg.renderer.depth + 1, cfg.renderer.style_dim)),
             jnp.zeros((1, cfg.decoder.n_latent, cfg.decoder.style_dim)))
    return jax.eval_shape(model.init, {"params": jax.random.key(0), "noise": jax.random.key(1)}, imgs, ml)["params"]


@pytest.mark.parametrize("stage", ["1", "2.1", "2.2", "2.2 --fix-ada"])
def test_print_parameter_matches_jax(stage, capsys):
    """Each stage's trainable set (tiny_test_config for stage 1,
    tiny_full_config for stage 2): the same count per top module and in
    total as the JAX audit."""
    stage1 = stage == "1"
    keys = {"1": ts.STAGE1_TRAINABLE, "2.1": ts.STAGE21_TRAINABLE, "2.2": ts.stage22_trainable(False),
            "2.2 --fix-ada": ts.stage22_trainable(True)}[stage]
    jparams = _jax_param_shapes(jc.tiny_test_config() if stage1 else jc.tiny_full_config())
    want_lines = []
    want = jlog.print_parameter({k: jparams[k] for k in keys}, out=want_lines.append)
    model = TE3DGE(tc.tiny_test_config() if stage1 else tc.tiny_full_config(), device="cpu")
    capsys.readouterr()
    got = tlog.print_parameter(ts.split_params(model, keys))
    got_lines = capsys.readouterr().out.splitlines()
    assert got == want > 0
    summary = [line for line in want_lines if line.startswith("[trainable]")]
    assert [line for line in got_lines if line.startswith("[trainable]")] == summary
    assert len(summary) == len(keys) + 1


def test_metric_logger_matches_jax(tmp_path):
    metrics = {"loss": np.float32(0.25), "d_r1": 0.0, "psnr": torch.tensor(21.5)}
    jl, tl = jlog.MetricLogger(tmp_path / "jax"), tlog.MetricLogger(tmp_path / "port")
    for logger in (jl, tl):
        logger.log(3, {k: float(v) for k, v in metrics.items()})
        logger.log(4, {"x": 1})
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [list(r) for r in got] == [list(r) for r in want] == [["step", "time", "loss", "d_r1", "psnr"],
                                                                  ["step", "time", "x"]]
    assert [{k: v for k, v in r.items() if k != "time"} for r in got] == \
        [{k: v for k, v in r.items() if k != "time"} for r in want]


# ------------------------------------------------------------ checkpoints


def _tiny_runner(work: Path):
    cfg = tc.tiny_test_config()
    model = TE3DGE(cfg, device="cpu")
    init_weights(model, 0)
    ml = TLM(torch.zeros(1, cfg.renderer.depth + 1, cfg.renderer.style_dim),
             torch.zeros(1, cfg.decoder.n_latent, cfg.decoder.style_dim))
    return Runner(model, ml, "cpu", work_dir=work)


def test_checkpoint_rotation_and_load(tmp_path):
    """As tests/test_runner.py::test_checkpoint_rotation: a second save
    rotates the first to models_<name>_old; loading by name and by path
    restores the variables; a state template gets the saved step, optimizer
    and EMA; a checkpoint without a state returns None for it."""
    runner = _tiny_runner(tmp_path / "run")
    model = runner.model
    state = ts.create_train_state(model, ts.STAGE1_TRAINABLE, 1e-3, ema=True)
    state.step = 7
    sum(p.sum() for p in state.params.values()).backward()
    ts.optimizer_step(state)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    runner.save_checkpoint(state=state, name="latest", d_state={"full": None, "volume": None})
    runner.save_checkpoint(name="latest")
    work = runner.work_dir
    assert {p.name for p in (work / "models_latest").iterdir()} == {"variables.pt"}
    assert {p.name for p in (work / "models_latest_old").iterdir()} == {"variables.pt", "state.pt", "d_state.pt"}
    for target in ("latest", str(work / "models_latest"), str(work / "models_latest_old")):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        fresh = ts.create_train_state(model, ts.STAGE1_TRAINABLE, 1e-3, ema=True)
        got_state, got_d = runner.load_checkpoint(target, state_template=fresh, d_template={"full": None})
        assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())
        if target.endswith("_old"):
            assert got_state is fresh and fresh.step == 8 and got_d == {"full": None}
            assert all(torch.equal(fresh.ema[k], state.ema[k]) for k in state.ema)
            want_opt = state.optimizer.state_dict()["state"]
            got_opt = fresh.optimizer.state_dict()["state"]
            assert set(got_opt) == set(want_opt) and all(torch.equal(got_opt[i]["nu"], want_opt[i]["nu"]) for i in want_opt)
        else:
            assert got_state is None and got_d is None
    with pytest.raises(ValueError, match="EMA"):
        runner.load_checkpoint(str(work / "models_latest_old"),
                               state_template=ts.create_train_state(model, ts.STAGE1_TRAINABLE, 1e-3, ema=False))


def test_legacy_module_files_still_warm_start(tmp_path, capsys):
    """A work dir of the earlier layout (<module>.pt at its root) warm-starts
    the trainer through --ckpt and the Runner's load_checkpoint (the eval
    CLI's --ckpt), variables only."""
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    donor = TE3DGE(tc.tiny_test_config(), device="cpu")
    init_weights(donor, 5)
    torch.save(donor.encoder.state_dict(), legacy / "encoder.pt")
    assert train.main([*CPU, "--iters", "0", "--ckpt", str(legacy), "--work-dir", str(tmp_path / "run")]) == 0
    assert "warm-started from" in capsys.readouterr().out
    final = torch.load(tmp_path / "run" / "models_final" / "variables.pt", weights_only=True)
    assert all(torch.equal(final[f"encoder.{k}"], v) for k, v in donor.encoder.state_dict().items())
    runner = _tiny_runner(tmp_path / "eval")
    assert runner.load_checkpoint(str(legacy)) == (None, None)
    assert all(torch.equal(runner.model.encoder.state_dict()[k], v) for k, v in donor.encoder.state_dict().items())
    with pytest.raises(FileNotFoundError):
        runner.load_checkpoint(str(tmp_path / "nothing_here"))


def test_resume_without_a_training_state_raises(tmp_path):
    runner = _tiny_runner(tmp_path / "run")
    runner.save_checkpoint(name="vars_only")
    with pytest.raises(SystemExit, match="no training state in checkpoint"):
        train.main([*CPU, "--iters", "2", "--resume", str(tmp_path / "run" / "models_vars_only"),
                    "--work-dir", str(tmp_path / "resumed")])


# ------------------------------------------------------------ the trainer


@pytest.mark.parametrize("flags", [["--ema"], STAGE22], ids=["stage1_ema", "stage22_both_ds_ranger"])
def test_resume_replays_the_uninterrupted_run(tmp_path, flags):
    """4 iterations against 2, saved by --ckpt-every 2, then --resume to 4:
    every logged metric (the E terms, both Ds') and every saved tensor
    (variables with BatchNorm statistics, the step, the optimizer moments,
    the EMA, the full-res D and its optimizer, the volume D's optimizer)."""
    whole, part = tmp_path / "whole", tmp_path / "part"
    assert train.main([*CPU, *flags, "--iters", "4", "--work-dir", str(whole)]) == 0
    assert train.main([*CPU, *flags, "--iters", "2", "--ckpt-every", "2", "--work-dir", str(part)]) == 0
    assert train.main([*CPU, *flags, "--iters", "4", "--resume", str(part / "models_latest"),
                       "--work-dir", str(part)]) == 0
    want, got = _records(whole), _records(part)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
    if flags is STAGE22:
        assert [r["d_r1"] > 0 for r in want] == [True, False, True, False]  # the lazy R1 spans the resume
        assert {"vd_d", "loss_e_adv", "res_loss"} <= set(want[0])
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_allclose([g[k] for k in w if k != "time"], [w[k] for k in w if k != "time"],
                                   rtol=RESUME_RTOL, atol=0)
    want_sd, got_sd = _saved(whole / "models_final"), _saved(part / "models_final")
    assert set(got_sd) == set(want_sd)
    assert any("/ema/" in k for k in want_sd) and any("/optimizer/state/" in k for k in want_sd)
    if flags is STAGE22:
        assert any(k.startswith("d_state.pt/full/d/") for k in want_sd)
        assert any(k.startswith("d_state.pt/volume/optimizer/state/") for k in want_sd)
    for k, w in want_sd.items():
        torch.testing.assert_close(got_sd[k].double(), w.double(), rtol=RESUME_RTOL, atol=0, msg=k)


def test_data_folder_feeds_the_d_step(tmp_path, monkeypatch, capsys):
    """--data: the full-res D step's reals are the folder's batches (at the
    D's 32^2, flips from RandomState(--seed), order from RandomState(--seed)
    too), not frozen-GAN samples."""
    root = _folder(tmp_path / "reals", size=64)
    seen, make = [], ts.make_full_d_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def call(reals, fakes):
            seen.append(reals.clone())
            return step(reals, fakes)

        return call

    monkeypatch.setattr(ts, "make_full_d_step", recording)
    args = [*CPU, "--stage", "2.2", "--adv-lambda", "0.01", "--iters", "2", "--seed", "3"]
    assert train.main([*args, "--data", str(root), "--work-dir", str(tmp_path / "run")]) == 0
    assert "without --data" not in capsys.readouterr().out
    ds = tdata.ImageFolderDataset(root, size=32, thumb_size=32, rng=np.random.RandomState(3))
    it = ds.iter_batches(2, 3)
    assert len(seen) == 2
    for got in seen:
        np.testing.assert_array_equal(got.numpy(), next(it)["image"])
    seen.clear()
    assert train.main([*args, "--work-dir", str(tmp_path / "synthetic")]) == 0
    assert "WARNING: --adv-lambda set without --data" in capsys.readouterr().out
    first = tdata.ImageFolderDataset(root, size=32, thumb_size=32, rng=np.random.RandomState(3)).iter_batches(2, 3)
    assert len(seen) == 2 and not np.allclose(seen[0].numpy(), next(first)["image"])


def test_panels_and_validation_do_not_move_the_loss_stream(tmp_path):
    """--saveimg-every 1 and --val-every 1 draw from their own streams: the
    logged metrics equal those of a run without them, which writes no panel."""
    val = _folder(tmp_path / "val", n=3, size=32)
    base = [*CPU, "--iters", "2"]
    assert train.main([*base, "--saveimg-every", "0", "--work-dir", str(tmp_path / "plain")]) == 0
    assert train.main([*base, "--saveimg-every", "1", "--val-every", "1", "--val-data", str(val),
                       "--work-dir", str(tmp_path / "services")]) == 0
    strip = lambda rs: [{k: v for k, v in r.items() if k != "time"} for r in rs]  # noqa: E731
    assert strip(_records(tmp_path / "services")) == strip(_records(tmp_path / "plain"))
    panels = sorted(p.name for p in (tmp_path / "services" / "train" / "images").iterdir())
    assert panels == ["iter_0000001.png", "iter_0000002.png"]
    assert Image.open(tmp_path / "services" / "train" / "images" / panels[0]).size == (32 * 3, 32 * 2)
    scores = json.loads((tmp_path / "services" / "scores.json").read_text())
    assert [s["num_images"] for s in scores] == [3, 3]
    assert not (tmp_path / "plain" / "train").exists()


def test_debug_nans_raises_on_a_planted_nan(tmp_path, monkeypatch):
    """A NaN planted in the stage-1 loss through E0's parameters: the run
    carries on without --debug-nans (E0 updated to NaN) and raises at the
    backward with it; anomaly mode is off again after the run."""
    real = ts.stage1_loss

    def planted(model, *args, **kwargs):
        loss, metrics, out = real(model, *args, **kwargs)
        return loss + torch.sqrt(next(model.encoder.parameters()).sum() * 0 - 1.0), metrics, out

    monkeypatch.setattr(ts, "stage1_loss", planted)
    args = [*CPU, "--iters", "1"]
    assert train.main([*args, "--work-dir", str(tmp_path / "plain")]) == 0
    final = torch.load(tmp_path / "plain" / "models_final" / "variables.pt", weights_only=True)
    assert any(torch.isnan(v).any() for k, v in final.items() if k.startswith("encoder."))  # through Adam
    with pytest.raises(RuntimeError, match="nan"):
        train.main([*args, "--debug-nans", "--work-dir", str(tmp_path / "debug")])
    assert not torch.is_anomaly_enabled()


def test_perceptual_warning(tmp_path, capsys):
    """Seeded perceptual nets are named as such; checkpoints silence it."""
    lpips, arcface = perceptual_files(tmp_path)
    assert train.main([*CPU, "--iters", "0", "--work-dir", str(tmp_path / "a")]) == 0
    assert "RANDOM-INIT perceptual nets" in capsys.readouterr().out
    assert train.main([*CPU, "--iters", "0", "--lpips-ckpt", str(lpips), "--arcface-ckpt", str(arcface),
                       "--work-dir", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "RANDOM-INIT" not in out and "[trainable] encoder:" in out and "[trainable] total:" in out
