"""The port's novel-view paths against the JAX package's at `tiny_full_config`
(`tiny_test_config` for the global path), on the seeded weights of
`test_torch_models.seeded_variables` (NoiseInjection weights zero, so the two
frameworks' decoder noise does not matter): the generic
`que_render_given_ref` at another camera in f32 and bf16, the ref-view
occlusion weighting in both modes with the force-background correction,
`render_multiview` at B=2, V=2, and `image2image_global`; then two checks
inside the port, as tests/test_pipeline.py makes them for the JAX package.

Tolerances as tests/test_torch_pipeline.py: the field's outputs
(`gen_thumb_imgs`, `ref_hit_prob`) 3e-3 abs (tests/test_golden_oracle.py:
40-41), `gen_imgs` 1e-3 abs, bf16 a mean relative error < 0.05
(tests/test_precision.py:94)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import seeded_variables
from test_torch_pipeline import _bf16

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.ops import grid_sample as t_grid_sample
from e3dge_torch.ops import siren_field as sf
from e3dge_torch.render.camera import camera_params_from_angles as t_cam
from e3dge_torch.utils.weights import load_jax_variables
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.ops.grid_sample import grid_sample as j_grid_sample
from e3dge_tpu.render.camera import camera_params_from_angles as j_cam
from e3dge_tpu.utils import config as jc

FIELD_ATOL, IMG_ATOL, BF16_REL = 3e-3, 1e-3, 0.05
QUE_AZIM, QUE_ELEV = np.array([0.25, -0.2], np.float32), np.array([0.1, 0.0], np.float32)


def _np(x):
    return x.detach().float().numpy()


def _inputs(cfg, seed=11):
    rng = np.random.RandomState(seed)
    L = cfg.pifu.load_size
    x = (0.3 * rng.randn(2, 3, L, L)).astype(np.float32)
    ml_r = (0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)
    ml_d = (0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32)
    return x, ml_r, ml_d


@pytest.fixture(scope="module")
def setup(tiny_full_setup):
    cfg, _, variables, _ = tiny_full_setup
    return cfg, seeded_variables(variables), _inputs(cfg)


def _port(cfg, vs):
    m = TE3DGE(cfg, device="cpu")
    load_jax_variables(m, vs)
    return m


def _jax_novel_view(cfg, vs, inputs, azim, elev, **kw):
    """JAX encode_ref_images + que_render_given_ref at (azim, elev), one program."""
    m = JE3DGE(cfg)

    def fn(v, x, r, d):
        ref = m.apply(v, x, JLM(r, d), method=JE3DGE.encode_ref_images, rngs={"noise": jax.random.key(4)})
        cam = j_cam(jnp.asarray(azim), jnp.asarray(elev), cfg.renderer.out_im_res, cfg.camera.fov_ang,
                    cfg.camera.dist_radius)
        return m.apply(v, ref, cam, method=JE3DGE.que_render_given_ref, rngs={"noise": jax.random.key(5)}, **kw)

    return jax.jit(fn)(vs, *(jnp.asarray(a) for a in inputs))


def _port_novel_view(cfg, vs, inputs, azim, elev, **kw):
    m = _port(cfg, vs)
    x, ml_r, ml_d = (torch.from_numpy(a) for a in inputs)
    ref = m.encode_ref_images(x, TLM(ml_r, ml_d))
    cam = t_cam(torch.from_numpy(azim), torch.from_numpy(elev), cfg.renderer.out_im_res, cfg.camera.fov_ang,
                cfg.camera.dist_radius)
    sf.reset_launch_counts()
    out = m.que_render_given_ref(ref, cam, **kw)
    assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}  # the CPU runs the plain version
    return out, ref


def test_bf16_lookup_samples_at_f32_coordinates():
    """A bf16 feature map is sampled at f32 coordinates, as the JAX sampler
    computes its corner indices and weights: rounding the coordinates to bf16
    first moved samples by up to 1/4 texel on a 64-wide map (max error 0.94
    on unit-scale features). What remains is the bf16 rounding of the output:
    one bf16 step, 2^-8 of the output's scale."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 64, 64).astype(np.float32)
    grid = rng.uniform(-0.95, 0.95, (1, 4000, 1, 2)).astype(np.float32)
    want = np.asarray(j_grid_sample(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(grid)).astype(jnp.float32))
    got = t_grid_sample(torch.from_numpy(x).bfloat16(), torch.from_numpy(grid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, atol=2.0**-8 * np.abs(want).max())


def test_generic_novel_view_f32_matches_jax(setup):
    cfg, vs, inputs = setup
    want = _jax_novel_view(cfg, vs, inputs, QUE_AZIM, QUE_ELEV)
    got, _ = _port_novel_view(tc.tiny_full_config(), vs, inputs, QUE_AZIM, QUE_ELEV)
    assert got["ref_hit_prob"] is None and want["ref_hit_prob"] is None
    w, g = want["res_render_out"], got["res_render_out"]
    np.testing.assert_allclose(_np(g["gen_thumb_imgs"]), np.asarray(w["gen_thumb_imgs"]), atol=FIELD_ATOL)
    np.testing.assert_allclose(_np(g["gen_imgs"]), np.asarray(w["gen_imgs"]), atol=IMG_ATOL)
    np.testing.assert_array_equal(got["in_img_mask"].numpy(), np.asarray(want["in_img_mask"]))
    assert tuple(got["in_img_mask"].shape)[3] == cfg.renderer.n_samples  # the per-point ref lookup
    np.testing.assert_allclose(_np(got["aligned_res"]), np.asarray(want["aligned_res"]), atol=FIELD_ATOL)


def test_generic_novel_view_bf16_tracks_jax(setup):
    cfg, vs, inputs = setup
    want = np.asarray(_jax_novel_view(_bf16(cfg, jc._with), vs, inputs, QUE_AZIM, QUE_ELEV)["res_render_out"]["gen_imgs"])
    got, _ = _port_novel_view(_bf16(tc.tiny_full_config(), tc._with), vs, inputs, QUE_AZIM, QUE_ELEV)
    img = got["res_render_out"]["gen_imgs"]
    assert img.dtype == torch.float32 and bool(torch.isfinite(img).all())
    err = np.abs(_np(img) - want) / (np.abs(want).max() + 1e-6)
    assert err.mean() < BF16_REL, f"bf16 novel view drifted from JAX's: mean rel err {err.mean():.4f}"


@pytest.mark.parametrize("mode", ["exact", "texture"])
def test_ref_view_weight_matches_jax(setup, mode):
    """use_ref_view_weight with force_background (the config default): every
    sample but the last re-integrated from the ref camera ("exact") or looked
    up in the ref render's weights ("texture"), the last 1 - sum."""
    cfg, vs, inputs = setup
    jcfg = jc._with(cfg, renderer=dict(occlusion_mode=mode))
    tcfg = tc._with(tc.tiny_full_config(), renderer=dict(occlusion_mode=mode))
    assert tcfg.renderer.force_background
    want = _jax_novel_view(jcfg, vs, inputs, QUE_AZIM, QUE_ELEV, use_ref_view_weight=True)
    got, _ = _port_novel_view(tcfg, vs, inputs, QUE_AZIM, QUE_ELEV, use_ref_view_weight=True)
    hp = _np(got["ref_hit_prob"])
    np.testing.assert_allclose(hp, np.asarray(want["ref_hit_prob"]), atol=FIELD_ATOL)
    assert np.abs(hp[..., :-1, :]).max() > 1e-2  # the weighting is live
    w, g = want["res_render_out"], got["res_render_out"]
    np.testing.assert_allclose(_np(g["gen_thumb_imgs"]), np.asarray(w["gen_thumb_imgs"]), atol=FIELD_ATOL)
    np.testing.assert_allclose(_np(g["gen_imgs"]), np.asarray(w["gen_imgs"]), atol=IMG_ATOL)


def test_render_multiview_matches_jax(setup):
    """B=2 references, V=2 views each, as one batch of 4 ordered b0v0, b0v1, b1v0, b1v1."""
    cfg, vs, inputs = setup
    n_views = 2
    azim = np.tile(np.array([-0.2, 0.3], np.float32), 2)
    elev = np.repeat(np.array([0.05, -0.1], np.float32), 2)
    m = JE3DGE(cfg)

    def fn(v, x, r, d):
        ref = m.apply(v, x, JLM(r, d), method=JE3DGE.encode_ref_images, rngs={"noise": jax.random.key(4)})
        cams = j_cam(jnp.asarray(azim), jnp.asarray(elev), cfg.renderer.out_im_res)
        return m.apply(v, ref, cams, n_views, method=JE3DGE.render_multiview, rngs={"noise": jax.random.key(5)})

    want = jax.jit(fn)(vs, *(jnp.asarray(a) for a in inputs))["res_render_out"]
    tm = _port(tc.tiny_full_config(), vs)
    ref = tm.encode_ref_images(*(torch.from_numpy(a) for a in inputs[:1]), TLM(*(torch.from_numpy(a) for a in inputs[1:])))
    got = tm.render_multiview(ref, t_cam(torch.from_numpy(azim), torch.from_numpy(elev), cfg.renderer.out_im_res),
                              n_views)["res_render_out"]
    assert tuple(got["gen_imgs"].shape) == (4, 3, cfg.decoder.size, cfg.decoder.size)
    np.testing.assert_allclose(_np(got["gen_thumb_imgs"]), np.asarray(want["gen_thumb_imgs"]), atol=FIELD_ATOL)
    np.testing.assert_allclose(_np(got["gen_imgs"]), np.asarray(want["gen_imgs"]), atol=IMG_ATOL)


def test_image2image_global_matches_jax(tiny_test_setup):
    cfg, _, variables, _ = tiny_test_setup
    vs = seeded_variables(variables)
    inputs = _inputs(cfg, seed=12)
    m = JE3DGE(cfg)
    want = jax.jit(lambda v, x, r, d: m.apply(v, x, JLM(r, d), method=JE3DGE.image2image_global,
                                              rngs={"noise": jax.random.key(3)}))(vs, *(jnp.asarray(a) for a in inputs))
    tm = _port(tc.tiny_test_config(), vs)
    assert not hasattr(tm, "local") and not hasattr(tm, "grid_align") and not hasattr(tm, "fuse_sft_block")
    x, r, d = (torch.from_numpy(a) for a in inputs)
    got = tm.image2image_global(x, TLM(r, d))
    assert tuple(got["gen_imgs"].shape) == (2, 3, cfg.decoder.size, cfg.decoder.size)
    np.testing.assert_allclose(_np(got["gen_thumb_imgs"]), np.asarray(want["gen_thumb_imgs"]), atol=FIELD_ATOL)
    np.testing.assert_allclose(_np(got["gen_imgs"]), np.asarray(want["gen_imgs"]), atol=IMG_ATOL)
    np.testing.assert_allclose(_np(got["pred_latents"][0]), np.asarray(want["pred_latents"][0]), atol=1e-4)


def test_same_view_matches_generic_at_the_ref_camera(setup):
    """The same-view branch (image2image's) against the generic one at the ref
    camera on the same query samples, 5e-4 as tests/test_pipeline.py:157: the
    ray-constant fused lookup equals the per-point one up to f32 rounding, and
    the generic visibility mask is all ones there."""
    cfg, vs, inputs = setup
    m = _port(tc.tiny_full_config(), vs)
    x, r, d = (torch.from_numpy(a) for a in inputs)
    ref = m.encode_ref_images(x, TLM(r, d))

    def render(same_view):
        return m.que_render_given_ref(ref, ref["cam_settings"], que_info=ref["global_render_out"], same_view=same_view)

    fused, generic = render(True), render(False)
    for k in ("gen_imgs", "gen_thumb_imgs"):
        np.testing.assert_allclose(_np(fused["res_render_out"][k]), _np(generic["res_render_out"][k]), atol=5e-4)
    assert bool(generic["in_img_mask"].all())


def test_zero_modulations_equal_latent2image(setup):
    """With the texture-modulation head zeroed, the SFT is (0 + 1) h + 0 and the
    conditioned render equals the plain one on the same z samples and noise,
    1e-5 as tests/test_pipeline.py:118."""
    cfg, vs, inputs = setup
    m = _port(tc.tiny_full_config(), vs)
    with torch.no_grad():
        for p in m.local.local_feat_to_tex_modulations_linear.parameters():
            p.zero_()
    x, r, d = (torch.from_numpy(a) for a in inputs)
    ref = m.encode_ref_images(x, TLM(r, d))
    noise = [torch.randn(2, 1, s, s, generator=torch.Generator().manual_seed(i))
             for i, s in enumerate([8, 16, 16, 32, 32])]
    out = m.que_render_given_ref(ref, ref["cam_settings"], que_info=ref["global_render_out"], noise=noise)
    plain = m.latent2image(ref["pred_latents"], ref["cam_settings"], z_vals=ref["global_render_out"]["z_vals"],
                           noise=noise)
    np.testing.assert_allclose(_np(out["res_render_out"]["gen_imgs"]), _np(plain["gen_imgs"]), atol=1e-5)
