"""The PyTorch port's `E3DGE.image2image` end to end against the JAX package's,
plus the port's package rules: weights round-trip through the JAX ingestion,
no JAX import anywhere in the port or in chip_smoke.py, and the card is the
default device.

Tolerances: `gen_thumb_imgs` (the texture pass through the field) at the
goldens' field tolerance, 3e-3 abs (tests/test_golden_oracle.py:40-41);
`gen_imgs` chains the encoder, field, two hourglass filters, the aligner, the
fusion MLPs and the decoder, each held at 1e-4 of its scale by
test_torch_models.py, so 1e-3 abs (10x one stack) on [-1, 1]-scale images. The
bf16 configuration: mean relative error < 0.05, as tests/test_precision.py:94."""

import ast
import dataclasses
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
from test_torch_models import seeded_variables

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.ops import siren_field as sf
from e3dge_torch.runner import Runner
from e3dge_torch.utils import device as tdevice
from e3dge_torch.utils.weights import TOPS, init_weights, load_jax_variables
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.utils import config as jc
from e3dge_tpu.utils.torch_ckpt import flatten_tree, ingest_variables

REPO = Path(__file__).resolve().parents[1]


def _bf16(cfg, with_):
    return dataclasses.replace(with_(cfg, renderer=dict(field_dtype="bfloat16")), dtype="bfloat16").validate()


@pytest.fixture(scope="module")
def setup(tiny_full_setup):
    cfg, _, variables, _ = tiny_full_setup
    vs = seeded_variables(variables)
    rng = np.random.RandomState(11)
    L = cfg.pifu.load_size
    x = (0.3 * rng.randn(2, 3, L, L)).astype(np.float32)
    ml_r = (0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)
    ml_d = (0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32)
    return cfg, variables, vs, x, ml_r, ml_d


def _jax_image2image(cfg, vs, x, ml_r, ml_d):
    m = JE3DGE(cfg)
    fn = jax.jit(lambda v, i, r, d: m.apply(
        v, i, JLM(r, d), method=JE3DGE.image2image, rngs={"noise": jax.random.key(2)}))
    return fn(vs, jnp.asarray(x), jnp.asarray(ml_r), jnp.asarray(ml_d))


def _port_image2image(cfg, vs, x, ml_r, ml_d):
    m = TE3DGE(cfg, device="cpu")
    load_jax_variables(m, vs)
    sf.reset_launch_counts()
    return m.image2image(torch.from_numpy(x), TLM(torch.from_numpy(ml_r), torch.from_numpy(ml_d)))


def test_image2image_f32_matches_jax(setup):
    cfg, _, vs, x, ml_r, ml_d = setup
    want = _jax_image2image(cfg, vs, x, ml_r, ml_d)
    got = _port_image2image(tc.tiny_full_config(), vs, x, ml_r, ml_d)
    # the CPU run takes the plain field version: no kernel launch
    assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}
    w, g = want["res_render_out"], got["res_render_out"]
    assert tuple(g["gen_imgs"].shape) == (2, 3, cfg.decoder.size, cfg.decoder.size)
    np.testing.assert_allclose(g["gen_thumb_imgs"].numpy(), np.asarray(w["gen_thumb_imgs"]), atol=3e-3)
    np.testing.assert_allclose(g["gen_imgs"].numpy(), np.asarray(w["gen_imgs"]), atol=1e-3)
    # the E1 branch is live: its modulations move the texture pass off pass 1
    pass1 = got["ref_info"]["global_render_out"]["gen_thumb_imgs"].numpy()
    assert np.abs(g["gen_thumb_imgs"].numpy() - pass1).max() > 1e-3


def test_image2image_bf16_tracks_jax(setup):
    cfg, _, vs, x, ml_r, ml_d = setup
    want = np.asarray(_jax_image2image(_bf16(cfg, jc._with), vs, x, ml_r, ml_d)["res_render_out"]["gen_imgs"])
    got = _port_image2image(_bf16(tc.tiny_full_config(), tc._with), vs, x, ml_r, ml_d)
    assert got["ref_info"]["global_render_out"]["raw_h"].dtype == torch.bfloat16
    img = got["res_render_out"]["gen_imgs"]
    assert img.dtype == torch.float32 and bool(torch.isfinite(img).all())
    err = np.abs(img.numpy() - want) / (np.abs(want).max() + 1e-6)
    assert err.mean() < 0.05, f"bf16 port drifted from the bf16 JAX pipeline: mean rel err {err.mean():.4f}"


def test_state_dicts_round_trip_through_jax_ingestion(setup):
    """The port's state dicts, loaded strictly, give back every JAX leaf exactly
    through `torch_ckpt.ingest_variables(strict=True)`."""
    _, variables, vs, *_ = setup
    m = TE3DGE(tc.tiny_full_config(), device="cpu")
    load_jax_variables(m, vs)
    sds = {top: {k: v.numpy() for k, v in getattr(m, top).state_dict().items()} for top in TOPS}
    back, missing = ingest_variables(jax.tree.map(np.asarray, dict(variables)), sds, strict=True)
    assert not missing
    want, got = flatten_tree(vs), flatten_tree(back)
    assert set(want) == set(got)
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]), want[path], err_msg=path)


def test_init_weights_is_seeded_and_keeps_the_local_branch_live():
    """The seeded weights of runs without JAX (what chip_smoke.py drives on the
    card): the same seed gives the same weights, the texture-modulation head is
    not zero (else the E1 path would be a no-op), and image2image on them gives
    a finite image of the configured size."""
    cfg = tc.tiny_full_config()
    a, b = TE3DGE(cfg, device="cpu"), TE3DGE(cfg, device="cpu")
    init_weights(a, 3)
    init_weights(b, 3)
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)
    assert float(a.generator.renderer.sigmoid_beta.detach()) > 0
    head = a.local.local_feat_to_tex_modulations_linear
    assert all(float(p.detach().abs().max()) > 0 for n, p in head.named_parameters() if n.endswith("weight"))
    rng = np.random.RandomState(0)
    L = cfg.pifu.load_size
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, L, L)).astype(np.float32))
    ml = TLM(torch.from_numpy((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)),
             torch.from_numpy((0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32)))
    out = a.image2image(x, ml, generator=torch.Generator().manual_seed(0))
    img = out["res_render_out"]["gen_imgs"]
    assert tuple(img.shape) == (1, 3, cfg.decoder.size, cfg.decoder.size)
    assert bool(torch.isfinite(img).all())
    pass1 = out["ref_info"]["global_render_out"]["gen_thumb_imgs"]
    assert float((out["res_render_out"]["gen_thumb_imgs"] - pass1).abs().max()) > 1e-4


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "e3dge_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "field_variants.py"]
    assert len(files) > 25
    for name in ("runner.py", "eval.py", "utils/mesh.py", "utils/editing.py", "utils/checkpoint.py",
                 "utils/image_io.py", "training/losses.py", "training/perceptual.py", "training/steps.py",
                 "training/train_utils.py", "training/train.py", "training/data.py", "training/projector.py",
                 "training/now_data.py", "training/eval3d.py", "utils/logger.py"):
        assert REPO / "e3dge_torch" / name in files
    banned = ("jax", "flax", "optax", "e3dge_tpu", "__graft_entry__")
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in banned, f"{path.relative_to(REPO)} imports {name}"


def test_default_device_is_the_card(monkeypatch):
    if torch.cuda.is_available():
        assert tdevice.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TE3DGE(tc.tiny_full_config())
    # the global-only model and the Runner default to the card too
    with pytest.raises(RuntimeError, match="CUDA"):
        TE3DGE(tc.tiny_test_config())
    cfg = tc.tiny_test_config()
    m = TE3DGE(cfg, device="cpu")
    ml = TLM(torch.zeros(1, cfg.renderer.depth + 1, cfg.renderer.style_dim),
             torch.zeros(1, cfg.decoder.n_latent, cfg.decoder.style_dim))
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(m, ml)
    assert Runner(m, ml, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve_device(None) == torch.device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No card, or a directory that holds chip_smoke.py alone: a non-zero exit
    and no result line."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
                              timeout=120, env=env)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
