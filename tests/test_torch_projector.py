"""Optimisation inversion of the PyTorch port against the JAX package at
`tiny_full_config`: `project` (W+ and W), `pti`, `Runner.project_images` and
`validation_from_latents` (with PTI, and from a projection the JAX runner
wrote), on one seeded state dict (NoiseInjection weights zero: the JAX side
draws its own decoder noise) and one pair of seeded perceptual files.

Both sides run noise-free: the latent noise scale is patched to 0 in each
package's projector (`_latent_noise_scale`). Tolerances: after 3 steps the
latents within 1e-4 and each step's loss within 1e-4 relative; PTI's last
loss 1e-4 relative, 95% of the tuned parameters within 1e-6 and all within
three Adam steps (3 x 5e-5), the tuned generator's image 1e-3 (the images
agree to 1e-3, tests/test_torch_pipeline.py); validation scores 1e-3, PSNR
0.05 dB.""" 

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import image_folder, runner_pair

from e3dge_torch.training import projector as tproj
from e3dge_torch.utils.weights import state_dicts_from_jax
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.training import projector as jproj

LATENT_ATOL, LOSS_RTOL, IMG_ATOL, SCORE_ATOL, PSNR_ATOL_DB = 1e-4, 1e-4, 1e-3, 1e-3, 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as tests/test_torch_training.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tiny_full_setup, tmp_path_factory):
    return runner_pair(tiny_full_setup, tmp_path_factory.mktemp("proj"))


@pytest.fixture
def noise_free(monkeypatch):
    monkeypatch.setattr(jproj, "_latent_noise_scale", lambda step, total, initial=0.03: 0.0)
    monkeypatch.setattr(tproj, "_latent_noise_scale", lambda step, total, initial=0.03: 0.0)


def _image(cfg, seed: int = 3) -> np.ndarray:
    L = cfg.pifu.load_size
    return np.clip(0.4 * np.random.RandomState(seed).randn(1, 3, L, L), -1, 1).astype(np.float32)


def _cameras(jr, tr, x):
    jcam = jr.model.apply(jr.variables, jnp.asarray(x), method=JE3DGE.image2camsettings)
    with torch.no_grad():
        tcam = tr.model.image2camsettings(torch.from_numpy(x))
    return jcam, tcam


@pytest.mark.parametrize("wspace", [False, True])
def test_project_matches_jax(pair, noise_free, wspace):
    """3 Adam steps from the mean latents; W+ with LPIPS in the objective,
    W without. With wspace every W+ row carries the same offset."""
    jr, tr, _, _ = pair
    x = _image(tr.cfg)
    jcam, tcam = _cameras(jr, tr, x)
    flags = [p.requires_grad for p in tr.model.parameters()]
    jl, tl = (None, None) if wspace else (jr.lpips_fn, tr.lpips_fn)
    want, wloss = jproj.project(jr.model, jr.variables, jr.mean_latents, jnp.asarray(x), jcam, jax.random.key(0),
                                steps=3, lpips_fn=jl, wspace=wspace)
    got, gloss = tproj.project(tr.model, tr.mean_latents, torch.from_numpy(x), tcam, torch.Generator().manual_seed(0),
                               steps=3, lpips_fn=tl, wspace=wspace, noise=tr.make_noise(1))
    np.testing.assert_allclose(gloss.numpy(), np.asarray(wloss), rtol=LOSS_RTOL)
    assert float(gloss[-1]) < float(gloss[0])
    for g, w, m in zip(got, want, tr.mean_latents):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LATENT_ATOL)
        off = (g - m).numpy()
        assert np.abs(off).max() > 1e-3
        if wspace:  # one offset, added to each mean row: f32 rounding of the sums apart
            np.testing.assert_allclose(off, np.broadcast_to(off[:, :1], off.shape), rtol=0, atol=1e-7)
    assert [p.requires_grad for p in tr.model.parameters()] == flags


def test_project_latent_noise_follows_the_schedule(pair):
    """The latent noise decays linearly from 0.03 and comes from the given
    generator: the same seed repeats the run, another seed moves it."""
    _, tr, _, _ = pair
    assert tproj._latent_noise_scale(0, 300) == pytest.approx(0.03)
    assert tproj._latent_noise_scale(150, 300) == pytest.approx(0.015)
    x = torch.from_numpy(_image(tr.cfg))
    with torch.no_grad():
        cam = tr.model.image2camsettings(x)

    def run(seed):
        return tproj.project(tr.model, tr.mean_latents, x, cam, torch.Generator().manual_seed(seed), steps=2,
                             noise=tr.make_noise(1))[1]

    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 0


def test_pti_matches_jax(pair):
    """3 PTI steps from the same latents; the port tunes its generator in
    place (restored here). PTI trains the NoiseInjection weights too, on each
    framework's own decoder noise, so the tuned parameters are held without
    them and the tuned image is rendered with them at zero on both sides."""
    jr, tr, _, ml = pair
    x = _image(tr.cfg, 5)
    jcam, tcam = _cameras(jr, tr, x)
    rng = np.random.RandomState(6)
    lat = [(m + 0.1 * rng.randn(*m.shape)).astype(np.float32) for m in ml]
    jv, jloss = jproj.pti(jr.model, jr.variables, [jnp.asarray(v) for v in lat], jnp.asarray(x), jcam, steps=3,
                          lpips_fn=jr.lpips_fn)
    g = tr.model.generator
    original = {k: v.clone() for k, v in g.state_dict().items()}
    try:
        tlat = [torch.from_numpy(v) for v in lat]
        tloss = tproj.pti(tr.model, tlat, torch.from_numpy(x), tcam, steps=3, lpips_fn=tr.lpips_fn,
                          noise=tr.make_noise(1))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
        tuned, jtuned = g.state_dict(), state_dicts_from_jax(jax.tree.map(np.asarray, dict(jv)))["generator"]
        moved = max(float((v - original[k]).abs().max()) for k, v in tuned.items())
        assert 1e-5 < moved < 1e-3  # three Adam steps at 5e-5
        gaps = torch.cat([(v - jtuned[k]).abs().flatten() for k, v in tuned.items() if not k.endswith("noise.weight")])
        # Adam moves an entry by up to lr per step whatever its gradient's size,
        # and after step 1 the two frameworks' noise weights (trained on their
        # own noise) differ: an entry whose gradient is near zero moves apart
        # by up to a step (4.1e-5 here; 97.7% of the entries within 1e-6)
        assert float(gaps.max()) <= 3 * 5e-5 and float((gaps <= 1e-6).float().mean()) >= 0.95
        with torch.no_grad():
            for k, v in tuned.items():
                if k.endswith("noise.weight"):
                    v.zero_()
        got = tr.model.latent2image(tlat, tcam, noise=tr.make_noise(1))["gen_imgs"].numpy()
        jv = _zero_noise_weights(jv)
        want = jr.model.apply(jv, [jnp.asarray(v) for v in lat], jcam, method=JE3DGE.latent2image,
                              rngs={"noise": jax.random.key(0)})["gen_imgs"]
        np.testing.assert_allclose(got, np.asarray(want), atol=IMG_ATOL)
    finally:
        g.load_state_dict(original)


def _zero_noise_weights(tree, prefix=""):
    return {k: _zero_noise_weights(v, f"{prefix}/{k}") if isinstance(v, dict) else
            (jnp.zeros_like(v) if f"{prefix}/{k}".endswith("noise/weight") else v) for k, v in tree.items()}


def test_project_images_and_validation_from_latents(pair, tmp_path):
    """tests/test_runner.py::test_project_images_and_validation_from_latents
    on the port: the artifacts, the generator restored after PTI, validation
    from the latents with each image's PTI generator."""
    _, tr, _, _ = pair
    d = image_folder(tmp_path / "imgs", n=2)
    before = {k: v.clone() for k, v in tr.model.generator.state_dict().items()}
    results = tr.project_images(d, steps=3, pti_steps=2, batch_size=1)
    assert [r["name"] for r in results] == ["0", "1"] and all(np.isfinite(r["final_loss"]) for r in results)
    proj = tr.work_dir / "projection"
    for r in results:
        for name in ("latent_in.npz", "rec.png", "pti_g.pt"):
            assert (proj / r["name"] / name).exists()
    lat = np.load(proj / "0" / "latent_in.npz")
    assert lat["renderer"].shape == (tr.cfg.renderer.depth + 1, tr.cfg.renderer.style_dim)
    assert lat["decoder"].shape == (tr.cfg.decoder.n_latent, tr.cfg.decoder.style_dim)
    assert float(lat["final_loss"]) == results[0]["final_loss"]
    for k, v in tr.model.generator.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    tuned = torch.load(proj / "0" / "pti_g.pt", weights_only=True)
    assert max(float((tuned[k] - before[k]).abs().max()) for k in before) > 0
    scores = tr.validation_from_latents(d, batch_size=1, use_pti=True)
    assert scores["num_images"] == 2 and scores["projection_validation"] is True
    assert np.isfinite(scores["psnr"])
    with pytest.raises(ValueError, match="batch_size=1"):
        tr.validation_from_latents(d, batch_size=2, use_pti=True)


def test_port_validates_a_projection_the_jax_runner_wrote(pair, tmp_path):
    jr, tr, _, _ = pair
    d = image_folder(tmp_path / "imgs", n=3, seed=2)
    jr.project_images(d, steps=2, batch_size=1, max_images=2)
    root = jr.work_dir / "projection"
    want = jr.validation_from_latents(d, root, batch_size=2)
    got = tr.validation_from_latents(d, root, batch_size=2)
    assert got["num_images"] == want["num_images"] == 2
    assert set(got) == set(want)
    for k in set(got) - {"num_images", "projection_validation"}:
        tol = PSNR_ATOL_DB if k == "psnr" else SCORE_ATOL
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
