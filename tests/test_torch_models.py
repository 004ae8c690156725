"""Each module of the PyTorch port's inversion path against its JAX counterpart
at `tiny_full_config`, on the same seeded weights: the JAX variables of the
shared `tiny_full_setup` fixture with every leaf replaced by seeded numpy
values (the zero-initialised texture-modulation head included, so the E1 path
is live), carried into the port through `state_dicts_from_jax` and loaded with
`load_state_dict(strict=True)`.

Tolerances start from the goldens' f32 values (tests/test_golden_oracle.py:
40-41): 3e-3 abs for field outputs (renderer), 1e-4 for conv stacks — the
latter relative to the output's scale (1e-4 * max(1, max|ref|)), since deep
stacks (24 IR-SE blocks, the hourglass) sum thousands of products per output in
another order than XLA does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.pifu.local_net import points_in_image as t_points_in_image
from e3dge_torch.render.camera import camera_params_from_angles as t_cam
from e3dge_torch.utils.weights import load_jax_variables
from e3dge_tpu.models.pifu.local_net import points_in_image as j_points_in_image
from e3dge_tpu.render.camera import camera_params_from_angles as j_cam

FIELD_ATOL = 3e-3


def seeded_variables(variables, seed: int = 0) -> dict:
    """Every leaf of a flax variables tree replaced by seeded numpy values at
    the leaf's own scale (mean + std * N(0, 1), std 0.05 where the init is
    constant); BatchNorm statistics mean 0.1 * N(0, 1) and variance U(0.5, 1.5);
    sigmoid_beta 0.1; NoiseInjection weights zero (the two frameworks draw
    different noise)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if "sigmoid_beta" in path:
            return np.full_like(x, 0.1)
        if path.endswith("noise/weight"):
            return np.zeros_like(x)
        if path.startswith("batch_stats"):
            if path.endswith("/var"):
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        std = float(x.std())
        return (x.mean() + (std if std > 0 else 0.05) * rng.randn(*x.shape)).astype(np.float32)

    def walk(tree, prefix):
        return {
            k: walk(v, f"{prefix}/{k}") if isinstance(v, dict) else leaf(f"{prefix}/{k}", v)
            for k, v in sorted(tree.items())
        }

    return {k: walk(v, k) for k, v in jax.tree.map(np.asarray, dict(variables)).items()}


def conv_atol(ref) -> float:
    return 1e-4 * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return x.detach().float().numpy()


@pytest.fixture(scope="module")
def pair(tiny_full_setup):
    cfg, jmodel, variables, _ = tiny_full_setup
    vs = seeded_variables(variables)
    tmodel = TE3DGE(tc.tiny_full_config(), device="cpu")
    load_jax_variables(tmodel, vs)
    return cfg, jmodel, vs, tmodel


def _apply(pair, fn, *args):
    _, jmodel, vs, _ = pair
    return jmodel.apply(vs, *args, method=fn)


def test_texture_modulation_head_is_live(pair):
    _, _, vs, tmodel = pair
    head = vs["params"]["local"]["local_feat_to_tex_modulations"]
    assert all(np.abs(v).max() > 0 for v in head.values())
    x = torch.randn(4, tmodel.cfg.renderer.residual_local_feats_dim, generator=torch.Generator().manual_seed(0))
    alpha, beta = tmodel.local.tex_modulations(x)
    assert float(alpha.abs().max()) > 1e-3 and float(beta.abs().max()) > 1e-3


def test_renderer_both_passes_match_jax(pair):
    cfg, _, _, tmodel = pair
    rng = np.random.RandomState(1)
    azim, elev = np.array([0.1, -0.2], np.float32), np.array([0.05, -0.1], np.float32)
    styles = (0.3 * rng.randn(2, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)
    r, s = cfg.renderer.out_im_res, cfg.renderer.n_samples
    cond = [(0.2 * rng.randn(2, r, r, s, cfg.renderer.width)).astype(np.float32) for _ in range(2)]
    jcam = j_cam(jnp.asarray(azim), jnp.asarray(elev), r, cfg.camera.fov_ang, cfg.camera.dist_radius)

    def jfn(m, cam, st, a, b):
        out = m.generator.renderer(cam, st, return_raw_h=True)
        return out, m.generator.renderer.render_from_backbone(out, st, (a, b))

    j1, j2 = _apply(pair, jfn, jcam, jnp.asarray(styles), *(jnp.asarray(c) for c in cond))
    tcam = t_cam(_t(azim), _t(elev), r, cfg.camera.fov_ang, cfg.camera.dist_radius)
    with torch.no_grad():
        t1 = tmodel.generator.renderer(tcam, _t(styles), return_raw_h=True)
        t2 = tmodel.generator.renderer.render_from_backbone(t1, _t(styles), tuple(_t(c) for c in cond))
    for k in ("gen_thumb_imgs", "features", "sdf", "depth", "xyz", "hit_prob", "raw_h", "points", "z_vals"):
        np.testing.assert_allclose(_np(t1[k]), np.asarray(j1[k]), atol=FIELD_ATOL, err_msg=k)
    for k in ("gen_thumb_imgs", "features"):
        np.testing.assert_allclose(_np(t2[k]), np.asarray(j2[k]), atol=FIELD_ATOL, err_msg=f"pass 2 {k}")
    # the SFT really changes the texture pass
    assert np.abs(np.asarray(j2["features"]) - np.asarray(j1["features"])).max() > 1e-2


def _noise(cfg, batch, rng):
    sizes, res = [cfg.decoder.in_res], cfg.decoder.in_res
    while res < cfg.decoder.size:
        res *= 2
        sizes += [res, res]
    return [rng.randn(batch, 1, s, s).astype(np.float32) for s in sizes]


def test_decoder_and_generator_match_jax_with_explicit_noise(pair):
    cfg, _, _, tmodel = pair
    rng = np.random.RandomState(2)
    d = cfg.decoder
    feats = rng.randn(2, d.in_channels, d.in_res, d.in_res).astype(np.float32)
    styles = (0.3 * rng.randn(2, d.n_latent, d.style_dim)).astype(np.float32)
    noise = _noise(cfg, 2, rng)
    want, _ = _apply(pair, lambda m, f, s, n: m.generator.decoder(f, s, input_is_latent=True, noise=n),
                     jnp.asarray(feats), jnp.asarray(styles), [jnp.asarray(n) for n in noise])
    with torch.no_grad():
        got, _ = tmodel.generator.decoder(_t(feats), _t(styles), input_is_latent=True, noise=[_t(n) for n in noise])
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))

    w = rng.randn(5, cfg.renderer.style_dim).astype(np.float32)
    want = _apply(pair, lambda m, x: m.generator.decoder.mean_latent(x), jnp.asarray(w))
    with torch.no_grad():
        got = tmodel.generator.decoder.mean_latent(_t(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))

    # full generator forward on a W+ pair: renderer -> features -> decoder
    r_lat = (0.3 * rng.randn(2, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)
    azim, elev = np.array([0.0, 0.2], np.float32), np.array([0.1, 0.0], np.float32)
    r = cfg.renderer.out_im_res
    jc = j_cam(jnp.asarray(azim), jnp.asarray(elev), r, cfg.camera.fov_ang, cfg.camera.dist_radius)
    want = _apply(pair, lambda m, a, b, c, n: m.generator([a, b], c, input_is_latent=True, noise=n)["gen_imgs"],
                  jnp.asarray(r_lat), jnp.asarray(styles), jc, [jnp.asarray(n) for n in noise])
    tcam = t_cam(_t(azim), _t(elev), r, cfg.camera.fov_ang, cfg.camera.dist_radius)
    with torch.no_grad():
        got = tmodel.generator([_t(r_lat), _t(styles)], tcam, noise=[_t(n) for n in noise])["gen_imgs"]
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=max(FIELD_ATOL, conv_atol(want)))


def test_fpn_encoder_matches_jax(pair):
    cfg, _, _, tmodel = pair
    x = np.random.RandomState(3).randn(2, 3, cfg.encoder.input_res, cfg.encoder.input_res).astype(np.float32)
    want = _apply(pair, lambda m, v: m.encoder(v, return_featmap=True), jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.encoder(_t(x), return_featmap=True)
    for i in range(2):
        ref = np.asarray(want["pred_latents"][i])
        np.testing.assert_allclose(_np(got["pred_latents"][i]), ref, atol=conv_atol(ref))
    for k in ("feat_maps", "p32"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=conv_atol(want[k]), err_msg=k)


def test_volume_discriminator_matches_jax(pair):
    cfg, _, _, tmodel = pair
    r = cfg.renderer.out_im_res
    x = np.random.RandomState(4).randn(2, 3, r, r).astype(np.float32)
    want = _apply(pair, lambda m, v: m.volume_discriminator(v), jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.volume_discriminator(_t(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=conv_atol(b))


def test_local_net_filter_query_and_modulations_match_jax(pair):
    cfg, _, _, tmodel = pair
    rng = np.random.RandomState(5)
    L = cfg.pifu.load_size
    res = rng.randn(2, 3, L, L).astype(np.float32)
    depth = rng.uniform(0.9, 1.1, (2, 1, L, L)).astype(np.float32)
    want = _apply(pair, lambda m, a, b: m.local.filter(a, b), jnp.asarray(res), jnp.asarray(depth))
    with torch.no_grad():
        got = tmodel.local.filter(_t(res), _t(depth))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))

    # paired pixel-aligned lookup, some points outside the image
    feat_b = rng.randn(*np.asarray(want).shape).astype(np.float32)
    pts = rng.uniform(-0.15, 0.15, (2, 3, 40)).astype(np.float32)
    azim, elev = np.array([0.1, -0.3], np.float32), np.array([0.0, 0.1], np.float32)
    jc = j_cam(jnp.asarray(azim), jnp.asarray(elev), cfg.renderer.out_im_res, cfg.camera.fov_ang, 0.12)
    tcam = t_cam(_t(azim), _t(elev), cfg.renderer.out_im_res, cfg.camera.fov_ang, 0.12)
    jq = _apply(pair, lambda m, a, b, p, c: m.local.query_pair(a, b, p, c),
                want, jnp.asarray(feat_b), jnp.asarray(pts), jc.calibs)
    with torch.no_grad():
        tq = tmodel.local.query_pair(got, _t(feat_b), _t(pts), tcam.calibs)
    assert not np.asarray(jq["in_img"]).all()
    np.testing.assert_array_equal(tq["in_img"].numpy(), np.asarray(jq["in_img"]))
    for k in ("feats_a", "feats_b", "z_condition", "proj_xy"):
        np.testing.assert_allclose(_np(tq[k]), np.asarray(jq[k]), atol=conv_atol(jq[k]), err_msg=k)

    # the single lookup, and the in-image mask without the sample
    jq1 = _apply(pair, lambda m, a, p, c: m.local.query(a, p, c), want, jnp.asarray(pts), jc.calibs)
    with torch.no_grad():
        tq1 = tmodel.local.query(got, _t(pts), tcam.calibs)
    for k in ("feats", "depth"):
        np.testing.assert_allclose(_np(tq1[k]), np.asarray(jq1[k]), atol=conv_atol(jq1[k]), err_msg=k)
    mask = np.asarray(j_points_in_image(jnp.asarray(pts), jc.calibs))
    np.testing.assert_array_equal(t_points_in_image(_t(pts), tcam.calibs).numpy(), mask)
    np.testing.assert_array_equal(tq1["in_img"].numpy(), mask)

    # texture modulations from the unmaterialised (fused, pe) concat
    parts = [rng.randn(2, 5, cfg.pifu.hourglass_dim).astype(np.float32), rng.randn(2, 5, 45).astype(np.float32)]
    ja, jb = _apply(pair, lambda m, a, b: m.local.tex_modulations((a, b)), *(jnp.asarray(p) for p in parts))
    with torch.no_grad():
        ta, tb = tmodel.local.tex_modulations(tuple(_t(p) for p in parts))
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=conv_atol(ja))
    np.testing.assert_allclose(_np(tb), np.asarray(jb), atol=conv_atol(jb))


def test_aligner_and_sft_fusion_match_jax(pair):
    cfg, _, _, tmodel = pair
    rng = np.random.RandomState(6)
    L = cfg.pifu.load_size
    x = rng.randn(2, 6, L, L).astype(np.float32)
    want = _apply(pair, lambda m, v: m.grid_align(v), jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.grid_align(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))

    hd = cfg.pifu.hourglass_dim
    enc = rng.randn(2, 4, 3, hd + 1).astype(np.float32)
    dec = rng.randn(2, 4, 3, hd).astype(np.float32)
    want = _apply(pair, lambda m, a, b: m.fuse_sft_block(a, b, w=0.7), jnp.asarray(enc), jnp.asarray(dec))
    with torch.no_grad():
        got = tmodel.fuse_sft_block(_t(enc), _t(dec), w=0.7)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))
