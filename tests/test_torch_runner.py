"""The port's Runner and the utilities around it: editing and trajectories
against the JAX package's, the decoder's truncation and style mixing against
JAX's, the reference-checkpoint helpers against `e3dge_tpu/utils/torch_ckpt.py`
on seeded dicts (and a .pt round trip), and two properties of the runner
itself: the batched video equals the per-view loop, and a toonify swap is
undone exactly by swapping back; on the CPU `image2image` stays on its eager
path, and the key of its CUDA graphs (`utils.graphs`) moves with the input
signature and the weights only.

Tolerances: editing and trajectories are a few f32 adds, 1e-6; the decoder
1e-4 of its output's scale (tests/test_torch_models.py::conv_atol); the
generator's image with the field inside 3e-3; batched against per-view, the
same arithmetic on the same noise in another batch size, 1e-5 in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import conv_atol, seeded_variables

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import E3DGE as TE3DGE
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.render.camera import camera_params_from_angles as t_cam
from e3dge_torch.runner import Runner
from e3dge_torch.utils import checkpoint as tckpt
from e3dge_torch.utils import editing as tedit
from e3dge_torch.utils import graphs
from e3dge_torch.utils.weights import init_weights, load_jax_variables
from e3dge_tpu.render.camera import camera_params_from_angles as j_cam
from e3dge_tpu.runner import Runner as JRunner
from e3dge_tpu.utils import config as jc
from e3dge_tpu.utils import editing as jedit
from e3dge_tpu.utils import torch_ckpt as jckpt


def _np(x):
    return x.detach().float().numpy()


def _seeded_runner(seed=0):
    """A CPU runner on `init_weights` (live decoder noise weights), with seeded
    inputs of batch 2."""
    cfg = tc.tiny_full_config()
    m = TE3DGE(cfg, device="cpu")
    init_weights(m, seed)
    rng = np.random.RandomState(seed)
    ml = TLM(torch.from_numpy((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)),
             torch.from_numpy((0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32)))
    L = cfg.pifu.load_size
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, L, L)).astype(np.float32))
    return Runner(m, ml, device="cpu"), x


def test_edit_code_matches_jax():
    rng = np.random.RandomState(0)
    codes = [rng.randn(2, 9, 16).astype(np.float32), rng.randn(2, 6, 32).astype(np.float32)]
    bounds = {a: {"renderer": rng.randn(1, 16).astype(np.float32), "decoder": rng.randn(1, 32).astype(np.float32)}
              for a in tedit.ATTRS[:4]}
    for scales in ([0.0, 1.5, 0.0, -0.5], {"Young": 2.0, "Eyeglasses": 1.0}):
        want = jedit.edit_code([jnp.asarray(c) for c in codes], bounds, scales)
        got = tedit.edit_code([torch.from_numpy(c) for c in codes], bounds, scales)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6)
    # [B, D] codes and an absent decoder code
    want = jedit.edit_code([jnp.asarray(codes[0][:, 0]), None], bounds, [1.0, 1.0])
    got = tedit.edit_code([torch.from_numpy(codes[0][:, 0]), None], bounds, [1.0, 1.0])
    assert got[1] is None and want[1] is None
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-6)


def test_load_boundaries_reads_the_reference_layout(tmp_path):
    rng = np.random.RandomState(1)
    for attr in tedit.ATTRS[:4]:
        for space, dim in (("renderer", 16), ("decoder", 32)):
            (tmp_path / f"{space}_{attr}").mkdir()
            np.save(tmp_path / f"{space}_{attr}" / "boundary.npy", rng.randn(1, dim).astype(np.float32))
    got, want = tedit.load_boundaries(tmp_path), jedit.load_boundaries(tmp_path)
    assert got.keys() == want.keys()
    for attr in got:
        for space in tedit.SPACES:
            np.testing.assert_array_equal(got[attr][space], want[attr][space])


@pytest.mark.parametrize("azim_only", [False, True])
def test_create_trajectory_matches_jax(tmp_path, azim_only):
    runner, _ = _seeded_runner()
    want = JRunner(jc.tiny_full_config(), None, None, work_dir=tmp_path).create_trajectory(37, azim_only=azim_only)
    got = runner.create_trajectory(37, azim_only=azim_only)
    assert got.dtype == np.float32 and got.shape == (37, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.fixture(scope="module")
def pair(tiny_full_setup):
    cfg, jmodel, variables, _ = tiny_full_setup
    vs = seeded_variables(variables)
    tmodel = TE3DGE(tc.tiny_full_config(), device="cpu")
    load_jax_variables(tmodel, vs)
    return cfg, jmodel, vs, tmodel


def _noise(cfg, batch, rng):
    sizes, res = [cfg.decoder.in_res], cfg.decoder.in_res
    while res < cfg.decoder.size:
        res *= 2
        sizes += [res, res]
    return [rng.randn(batch, 1, s, s).astype(np.float32) for s in sizes]


def test_decoder_truncation_and_style_mixing_match_jax(pair):
    """z input mapped by the decoder, truncated toward a mean (as
    tests/test_generator.py:66), and two codes mixed at inject_index."""
    cfg, jmodel, vs, tmodel = pair
    rng = np.random.RandomState(2)
    d = cfg.decoder
    feats = rng.randn(2, d.in_channels, d.in_res, d.in_res).astype(np.float32)
    z1, z2 = (rng.randn(2, cfg.renderer.style_dim).astype(np.float32) for _ in range(2))
    mean = (0.1 * rng.randn(1, d.style_dim)).astype(np.float32)
    noise = _noise(cfg, 2, rng)
    for styles, kw in (([z1], dict(truncation=0.5, truncation_latent=mean)),
                       ([z1, z2], dict(inject_index=2)),
                       ([z1, z2], dict(inject_index=3, truncation=0.7, truncation_latent=mean))):
        want, wlat = jmodel.apply(
            vs, jnp.asarray(feats), [jnp.asarray(s) for s in styles], [jnp.asarray(n) for n in noise],
            method=lambda m, f, s, n: m.generator.decoder(
                f, s, noise=n, return_latents=True,
                **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))
        with torch.no_grad():
            got, glat = tmodel.generator.decoder(
                torch.from_numpy(feats), [torch.from_numpy(s) for s in styles], noise=[torch.from_numpy(n) for n in noise],
                return_latents=True, **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
        np.testing.assert_allclose(_np(glat), np.asarray(wlat), atol=conv_atol(wlat))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=conv_atol(want))
    # truncation really moves the image
    with torch.no_grad():
        plain, _ = tmodel.generator.decoder(torch.from_numpy(feats), [torch.from_numpy(z1)],
                                            noise=[torch.from_numpy(n) for n in noise])
    assert float((plain - got).abs().max()) > 1e-3


def test_generator_z_input_with_truncation_matches_jax(pair):
    cfg, jmodel, vs, tmodel = pair
    rng = np.random.RandomState(3)
    z = rng.randn(2, cfg.renderer.style_dim).astype(np.float32)
    means = ((0.1 * rng.randn(1, cfg.renderer.style_dim)).astype(np.float32),
             (0.1 * rng.randn(1, cfg.decoder.style_dim)).astype(np.float32))
    noise = _noise(cfg, 2, rng)
    azim, elev = np.array([0.1, -0.2], np.float32), np.array([0.0, 0.1], np.float32)
    r = cfg.renderer.out_im_res
    want = jmodel.apply(
        vs, [jnp.asarray(z)], j_cam(jnp.asarray(azim), jnp.asarray(elev), r), [jnp.asarray(n) for n in noise],
        method=lambda m, s, c, n: m.generator(s, c, input_is_latent=False, truncation=0.6,
                                              truncation_latent=tuple(jnp.asarray(x) for x in means), noise=n))
    with torch.no_grad():
        got = tmodel.generator([torch.from_numpy(z)], t_cam(torch.from_numpy(azim), torch.from_numpy(elev), r),
                               noise=[torch.from_numpy(n) for n in noise], input_is_latent=False, truncation=0.6,
                               truncation_latent=tuple(torch.from_numpy(x) for x in means))
    np.testing.assert_allclose(_np(got["styles"]), np.asarray(want["styles"]), atol=conv_atol(want["styles"]))
    np.testing.assert_allclose(_np(got["gen_imgs"]), np.asarray(want["gen_imgs"]), atol=3e-3)


def test_batched_video_equals_the_per_view_loop():
    runner, x = _seeded_runner()
    ref = runner.encode_ref(x)
    batched = runner.render_video(x, n_views=3, batched=True, ref_info=ref)
    loop = runner.render_video(x, n_views=3, batched=False, ref_info=ref)
    assert tuple(batched.shape) == (2, 3, 3, runner.cfg.decoder.size, runner.cfg.decoder.size)
    np.testing.assert_allclose(_np(batched), _np(loop), atol=1e-5)
    assert float((batched[:, 0] - batched[:, 2]).abs().max()) > 1e-3  # the views differ


def test_toonify_swap_and_swap_back():
    """A toonify swap changes the image; swapping the original generator back
    restores it bit for bit, so the field's cached weight pack was rebuilt
    both times."""
    runner, x = _seeded_runner()
    net = runner.model.generator.renderer.network
    orig = {k: v.clone() for k, v in runner.model.generator.state_dict().items()}
    toon_model = TE3DGE(runner.cfg, device="cpu")
    init_weights(toon_model, 7)
    toon = toon_model.generator.state_dict()

    before = runner.image2image(x)["res_render_out"]["gen_imgs"]
    runner.toonify(toon)
    torch.testing.assert_close(net.pack("highest")["w0t"], toon["renderer.network.pts_linears.0.weight"].t(),
                               rtol=0, atol=0)
    toonified = runner.image2image(x)["res_render_out"]["gen_imgs"]
    runner.toonify(orig)
    after = runner.image2image(x)["res_render_out"]["gen_imgs"]
    assert float((toonified - before).abs().max()) > 1e-2
    torch.testing.assert_close(after, before, rtol=0, atol=0)


def test_edit_and_render_and_latent2surface():
    runner, x = _seeded_runner()
    cfg = runner.cfg
    rng = np.random.RandomState(4)
    runner.boundaries = {a: {"renderer": 0.3 * rng.randn(1, cfg.renderer.style_dim).astype(np.float32),
                             "decoder": 0.3 * rng.randn(1, cfg.decoder.style_dim).astype(np.float32)}
                         for a in tedit.ATTRS[:4]}
    edited = runner.edit_and_render(x, [0.0, 1.0])["res_render_out"]["gen_imgs"]
    plain = runner.edit_and_render(x, [0.0, 0.0])["res_render_out"]["gen_imgs"]
    assert bool(torch.isfinite(edited).all()) and float((edited - plain).abs().max()) > 1e-3
    # zero scales: the generic branch at the ref camera, which equals image2image's same-view render
    same_view = runner.image2image(x)["res_render_out"]["gen_imgs"]
    np.testing.assert_allclose(_np(plain), _np(same_view), atol=5e-4)

    meshes = runner.latent2surface(runner.encode_ref(x)["pred_latents"])
    assert len(meshes) == 2
    for verts, faces in meshes:
        assert verts.ndim == 2 and verts.shape[1] == 3 and faces.ndim == 2 and faces.shape[1] == 3
        assert len(faces) == 0 or faces.max() < len(verts)


def _reference_dicts(model):
    """A port model's weights in the reference's checkpoint layout: g_ema with
    the DataParallel prefix, the netGlobal nesting and netLocal inside, and an
    E3DGE training save_dict."""
    g_ema = {"module." + k.replace("renderer.network.", "renderer.network.netGlobal."): v.clone()
             for k, v in model.generator.state_dict().items()}
    g_ema.update({tckpt.LOCAL_PREFIX + k: v.clone() for k, v in model.local.state_dict().items()})
    save_dict = {"iter": 1234, "encoder": {"module." + k: v.clone() for k, v in model.encoder.state_dict().items()},
                 "grid_align": model.grid_align.state_dict(), "Fuse_sft_block": model.fuse_sft_block.state_dict(),
                 "volume_discriminator": model.volume_discriminator.state_dict(), "netLocal": {}}
    return g_ema, save_dict


def test_checkpoint_helpers_match_jax():
    runner, _ = _seeded_runner()
    g_ema, save_dict = _reference_dicts(runner.model)
    np_g = {k: v.numpy() for k, v in g_ema.items()}
    want_gen, want_local = jckpt.split_generator_sd(jckpt.normalize_g_ema_keys(np_g))
    got_gen, got_local = tckpt.split_generator_sd(tckpt.normalize_g_ema_keys(g_ema))
    for got, want in ((got_gen, want_gen), (got_local, want_local)):
        assert got.keys() == want.keys() and len(got) > 0
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    want = jckpt.split_e3dge_save_dict(save_dict)
    got = tckpt.split_e3dge_save_dict(save_dict)
    assert got.keys() == want.keys() == {"encoder", "grid_align", "fuse_sft_block", "volume_discriminator"}
    for top in got:
        assert got[top].keys() == want[top].keys()
        for k in got[top]:
            np.testing.assert_array_equal(got[top][k].numpy(), want[top][k])


def test_reference_checkpoint_loads_strictly_from_pt(tmp_path):
    src, _ = _seeded_runner(seed=0)
    g_ema, save_dict = _reference_dicts(src.model)
    torch.save({"g_ema": g_ema}, tmp_path / "g.pt")
    torch.save(save_dict, tmp_path / "e3dge.pt")
    dst = TE3DGE(tc.tiny_full_config(), device="cpu")
    init_weights(dst, 5)
    loaded = tckpt.load_reference_checkpoint(
        dst, tckpt.load_torch_file(tmp_path / "g.pt")["g_ema"], tckpt.load_torch_file(tmp_path / "e3dge.pt"))
    assert set(loaded) == {"generator", "local", "encoder", "grid_align", "fuse_sft_block", "volume_discriminator"}
    want = src.model.state_dict()
    for k, v in dst.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    with pytest.raises(RuntimeError):  # strict: a missing key is an error
        tckpt.load_reference_checkpoint(dst, {k: v for k, v in list(g_ema.items())[1:]})


def test_image2image_on_the_cpu_stays_eager():
    """No graph cache on the CPU; the runner's answer is the model's own on
    the runner's NOISE_SEED noise, bit for bit, call after call."""
    runner, x = _seeded_runner()
    assert runner.graphs is None
    want = runner.model.image2image(x, runner.mean_latents, noise=runner.make_noise(2))
    for _ in range(2):
        got = runner.image2image(x)
        torch.testing.assert_close(got["res_render_out"]["gen_imgs"], want["res_render_out"]["gen_imgs"],
                                   rtol=0, atol=0)
        for g, w in zip(got["ref_info"]["pred_latents"], want["ref_info"]["pred_latents"]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("device, world_size, usable", [
    ("cpu", None, False), ("cuda", None, True), ("cuda", 1, True), ("cuda", 2, False)])
def test_graphs_are_used_on_a_card_with_at_most_one_rank(device, world_size, usable):
    world = None if world_size is None else type("World", (), {"size": world_size})()
    assert graphs.usable(torch.device(device), world) is usable


def _key_inputs(b=2, maps=(4, 8, 8)):
    g = torch.Generator().manual_seed(b + len(maps))
    return torch.randn(b, 3, 16, 16, generator=g), [torch.randn(b, 1, s, s, generator=g) for s in maps]


@pytest.mark.parametrize("change, moves", [
    ("other photo and noise values", False),
    ("images on another device", False),
    ("a call between", False),
    ("batch size", True),
    ("noise shapes", True),
    ("noise count", True),
    ("images dtype", True),
    ("parameter version", True),
    ("buffer version", True),
    ("replaced parameter", True),
    ("mean latents version", True),
])
def test_graph_key_moves_with_the_signature_and_the_weights_only(change, moves):
    runner, _ = _seeded_runner()
    cache = graphs.GraphCache(runner._invert, runner.model, torch.device("cpu"), extra=lambda: runner.mean_latents)
    images, noise = _key_inputs()
    before = cache.key(images, noise)
    if change == "other photo and noise values":
        images, noise = images + 1, [n * 2 for n in noise]
    elif change == "images on another device":
        images = images.to("meta")
    elif change == "a call between":
        runner.image2image(torch.rand(2, 3, runner.cfg.pifu.load_size, runner.cfg.pifu.load_size))
    elif change == "batch size":
        images, noise = _key_inputs(b=1)
    elif change == "noise shapes":
        images, noise = images, _key_inputs(maps=(4, 8, 16))[1]
    elif change == "noise count":
        noise = noise[:2]
    elif change == "images dtype":
        images = images.double()
    elif change == "parameter version":
        with torch.no_grad():
            next(runner.model.generator.renderer.network.parameters()).mul_(1.0)
    elif change == "buffer version":
        with torch.no_grad():
            next(b for b in runner.model.buffers() if b.is_floating_point()).add_(0.0)
    elif change == "replaced parameter":  # a new tensor: the cached list of the model's tensors is rebuilt
        mod = next(m for m in runner.model.fuse_sft_block.modules() if "weight" in m._parameters)
        mod.weight = torch.nn.Parameter(mod.weight.detach().clone())
    elif change == "mean latents version":
        runner.mean_latents.renderer.add_(0.0)
    after = cache.key(images, noise)
    assert (after != before) is moves
    assert (after[0] != before[0]) is (moves and change in ("batch size", "noise shapes", "noise count",
                                                            "images dtype"))


def test_graph_outputs_are_fresh_with_their_aliasing_kept():
    """`graphs._fresh`: every tensor a new copy, dicts, lists and named tuples
    rebuilt, one object met twice one copy."""
    cam = t_cam(torch.zeros(2), torch.zeros(2), 8)
    shared = {"gen_thumb_imgs": torch.rand(2, 3, 4, 4), "raw_h": torch.rand(2, 5)}
    out = {"res_render_out": {"gen_imgs": torch.rand(2, 3, 8, 8)}, "que_info": shared,
           "ref_info": {"global_render_out": shared, "cam_settings": cam, "pred_latents": [torch.rand(2, 4)],
                        "n": 3, "none": None}}
    got = graphs._fresh(out, {})
    assert got["que_info"] is got["ref_info"]["global_render_out"]
    assert type(got["ref_info"]["cam_settings"]) is type(cam)
    pairs = [(got["res_render_out"]["gen_imgs"], out["res_render_out"]["gen_imgs"]),
             (got["que_info"]["raw_h"], shared["raw_h"]),
             (got["ref_info"]["pred_latents"][0], out["ref_info"]["pred_latents"][0]),
             *zip(got["ref_info"]["cam_settings"], cam)]
    for g, w in pairs:
        assert g.data_ptr() != w.data_ptr()
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got["ref_info"]["n"] == 3 and got["ref_info"]["none"] is None
