"""The field kernel on a CUDA card against its plain version. Imports no JAX, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test needs the card and skips without one (the kernel has no CPU mode;
on CPU tensors the wrappers run the plain version, which the JAX parity tests
hold). Tolerances as chip_smoke.py: `siren_field.KERNEL_TOLERANCE`, a max and
a mean abs error per precision and kind of output, whose comment gives the
reasons.
"""

import pytest
import torch

from e3dge_torch.models.siren import SirenGenerator
from e3dge_torch.ops import siren_field as sf


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the field kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(card, precision, n=300, sft=True, b=2):
    g = torch.Generator().manual_seed(n)
    torch.manual_seed(0)
    net = SirenGenerator(8, 256, 256).to(card)
    dt = sf.io_dtype(precision)
    pts = (torch.rand(b, n, 3, generator=g) * 2 - 1).to(card)
    dirs = torch.nn.functional.normalize(torch.randn(b, n, 3, generator=g), dim=-1).to(card)
    styles = (0.3 * torch.randn(b, 9, 256, generator=g)).to(card)
    alpha = (0.1 * torch.randn(b, n, 256, generator=g)).to(card, dt) if sft else None
    lbeta = (0.1 * torch.randn(b, n, 256, generator=g)).to(card, dt) if sft else None
    with torch.no_grad():
        gamma, beta = net.film_vectors(styles.to(torch.bfloat16) if precision == "serving" else styles)
    return pts, dirs, net.pack(precision), gamma, beta, alpha, lbeta


# feat, rgb_sdf, raw_h of the full entry, then feat, rgb of the texture entry
KINDS = ("hidden", "head", "hidden", "hidden", "head")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sf.PRECISIONS)
@pytest.mark.parametrize("sft", [False, True])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 300, 128 * 5 + 37])
def test_full_and_texture_entries_match_plain(card, precision, sft, b, n):
    """The tile walk: B=2 (per-item FiLM rows in one launch, no tile across
    two items), N around the serving kernel's 128-point tile and its 64-point
    warpgroup halves (1, 127, 128, 129), and ragged last tiles (300, 677)."""
    args = _inputs(card, precision, n=n, sft=sft, b=b)
    sf.reset_launch_counts()
    with torch.no_grad():
        got = sf.siren_field_full(*args, precision=precision, return_raw_h=True)
        want = sf.siren_field_reference(*args, precision=precision, return_raw_h=True)
        tex_args = (want[2], args[1], args[2], args[3][:, -1].contiguous(), args[4][:, -1].contiguous(),
                    args[5], args[6])
        got_t = sf.siren_field_tex(*tex_args, precision=precision)
        want_t = sf.siren_field_tex_reference(*tex_args, precision=precision)
    torch.cuda.synchronize()
    assert sf.launch_counts == {"siren_field_full": 1, "siren_field_tex": 1}
    assert sf.precision_launch_counts == {(e, p): int(p == precision) for e, p in sf.precision_launch_counts}
    for g, w, kind in zip(got + got_t, want + want_t, KINDS):
        assert g.dtype == w.dtype and g.shape == w.shape
        mx, mean, ok = sf.kernel_errors(g, w, kind, precision)
        assert ok, f"{kind} output: max {mx:.3e} mean {mean:.3e} against {sf.KERNEL_TOLERANCE[precision][kind]}"


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    pts, dirs, pack, gamma, beta, alpha, lbeta = _inputs(card, "highest")
    with pytest.raises(TypeError):  # bf16 operands under the f32 precision
        sf.siren_field_full(pts, dirs, pack, gamma, beta, alpha.bfloat16(), lbeta.bfloat16(), precision="highest")
    with pytest.raises(ValueError):  # non-contiguous
        sf.siren_field_full(pts, dirs, pack, gamma, beta, alpha.transpose(0, 1).contiguous().transpose(0, 1),
                            lbeta, precision="highest")
    with pytest.raises(ValueError), torch.no_grad():  # another width than the kernel's
        narrow = SirenGenerator(2, 64, 16).to(card)
        g, b = narrow.film_vectors(torch.zeros(2, 3, 16, device=card))
        sf.siren_field_full(pts, dirs, narrow.pack("highest"), g, b, precision="highest")


@pytest.mark.cuda
def test_kernel_refuses_grad_operands_on_the_card(card):
    """No backward: a CUDA operand that requires grad under grad mode raises
    before the launch, as on the CPU."""
    pts, dirs, pack, gamma, beta, _, _ = _inputs(card, "highest")
    sf.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        sf.siren_field_full(pts.requires_grad_(), dirs, pack, gamma, beta, precision="highest")
    assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("field_dtype", ["float32", "bfloat16"])
def test_grad_render_takes_the_twin_on_the_card(card, field_dtype):
    """A render whose styles require grad runs the eager twin (no launch) and
    agrees with the kernel's no-grad render: f32 within the field tolerance
    3e-3, bf16 (the twin rounds every layer to bf16, the kernel only its
    operands) in mean."""
    from e3dge_torch.config import RendererConfig
    from e3dge_torch.models.volume_renderer import VolumeFeatureRenderer
    from e3dge_torch.render.camera import camera_params_from_angles

    torch.manual_seed(0)
    ren = VolumeFeatureRenderer(RendererConfig(out_im_res=16, n_samples=8, field_dtype=field_dtype)).to(card)
    ren.requires_grad_(False)
    cam = camera_params_from_angles(torch.tensor([0.1, -0.2], device=card), torch.tensor([0.05, 0.0], device=card),
                                    16)
    styles = 0.3 * torch.randn(2, 9, 256, device=card)
    sf.reset_launch_counts()
    with torch.no_grad():
        want = ren(cam, styles)
    assert sf.launch_counts["siren_field_full"] == 1
    s = styles.clone().requires_grad_()
    got = ren(cam, s)
    assert sf.launch_counts["siren_field_full"] == 1
    (g,) = torch.autograd.grad(got["gen_thumb_imgs"].sum(), s)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    err = (got["gen_thumb_imgs"].detach() - want["gen_thumb_imgs"]).abs()
    assert float(err.max() if field_dtype == "float32" else err.mean()) < 3e-3


@pytest.mark.cuda
def test_stage2_texture_tail_route_on_the_card(card):
    """Stage 2's conditioned re-render: with texture modulations that require
    grad, `render_from_backbone` runs the twin's texture head on the kernel's
    cached backbone (no launch) and agrees with the kernel's texture pass on
    the same modulations within the field tolerance 3e-3, with a finite,
    non-zero gradient on the modulations."""
    from e3dge_torch.config import RendererConfig
    from e3dge_torch.models.volume_renderer import VolumeFeatureRenderer
    from e3dge_torch.render.camera import camera_params_from_angles

    torch.manual_seed(0)
    ren = VolumeFeatureRenderer(RendererConfig(out_im_res=16, n_samples=8)).to(card)
    ren.requires_grad_(False)
    cam = camera_params_from_angles(torch.tensor([0.1, -0.2], device=card), torch.tensor([0.05, 0.0], device=card),
                                    16)
    styles = 0.3 * torch.randn(2, 9, 256, device=card)
    sf.reset_launch_counts()
    with torch.no_grad():
        cached = ren(cam, styles, return_raw_h=True)
    alpha, lbeta = (0.1 * torch.randn(*cached["raw_h"].shape, device=card) for _ in range(2))
    with torch.no_grad():
        want = ren.render_from_backbone(cached, styles, (alpha, lbeta))
    assert sf.launch_counts == {"siren_field_full": 1, "siren_field_tex": 1}
    a = alpha.clone().requires_grad_()
    got = ren.render_from_backbone(cached, styles, (a, lbeta))
    assert sf.launch_counts == {"siren_field_full": 1, "siren_field_tex": 1}
    for k in ("gen_thumb_imgs", "features"):
        assert float((got[k].detach() - want[k]).abs().max()) < 3e-3, k
    (g,) = torch.autograd.grad(got["gen_thumb_imgs"].square().sum() + got["features"].sum(), a)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("entry,raw_h", [("full", False), ("full", True), ("tex", False)])
def test_stage2_highest_launch_shapes_match_plain(card, entry, raw_h):
    """The f32 (`highest`) kernel at the stage-2 iteration's new shapes,
    B=4 x 64*64*24 points: the full pass without raw_h (the sample and ref
    renders) and with it (the query and image2image renders), the texture
    pass with SFT (the D's fake producer)."""
    n, precision = 64 * 64 * 24, "highest"
    args = _inputs(card, precision, n=n, sft=entry == "tex", b=4)
    sf.reset_launch_counts()
    with torch.no_grad():
        if entry == "full":
            got = sf.siren_field_full(*args[:5], precision=precision, return_raw_h=raw_h)
            want = sf.siren_field_reference(*args[:5], precision=precision, return_raw_h=raw_h)
            kinds = ("hidden", "head", "hidden")
        else:
            raw = sf.siren_field_reference(*args[:5], precision=precision, return_raw_h=True)[2]
            tex_args = (raw, args[1], args[2], args[3][:, -1].contiguous(), args[4][:, -1].contiguous(), args[5],
                        args[6])
            got = sf.siren_field_tex(*tex_args, precision=precision)
            want = sf.siren_field_tex_reference(*tex_args, precision=precision)
            kinds = ("hidden", "head")
    torch.cuda.synchronize()
    assert sf.launch_counts[f"siren_field_{entry}"] == 1
    for g, w, kind in zip(got, want, kinds):
        if w is None:
            assert g is None
            continue
        mx, mean, ok = sf.kernel_errors(g, w, kind, precision)
        assert ok, f"{kind} output: max {mx:.3e} mean {mean:.3e} against {sf.KERNEL_TOLERANCE[precision][kind]}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sdf_targets", "sdf_grid"])
def test_sdf_query_shapes_match_plain(card, case):
    """The f32 kernel at the SDF queries' shapes, with zero view dirs as the
    renderer passes them: the uniform SDF targets of stages 1 and 2 (B=4 x
    2,048 points in the box) and the mesh's SDF grid (B=1, the whole
    64 x 64 x 24 camera frustum, `sdf_grid_points` at the reference view, out
    to the grid's extent)."""
    from e3dge_torch.config import RendererConfig
    from e3dge_torch.models.volume_renderer import VolumeFeatureRenderer
    from e3dge_torch.render.camera import camera_params_from_angles

    precision = "highest"
    if case == "sdf_targets":
        pts, _, pack, gamma, beta, _, _ = _inputs(card, precision, n=2048, sft=False, b=4)
        args = (pts, torch.zeros_like(pts), pack, gamma, beta)
    else:
        torch.manual_seed(0)
        ren = VolumeFeatureRenderer(RendererConfig()).to(card)
        zero = torch.zeros(1, device=card)
        cam = camera_params_from_angles(zero, zero, ren.cfg.out_im_res)
        grid = ren.sdf_grid_points(cam)
        styles = 0.3 * torch.randn(1, ren.cfg.depth + 1, ren.cfg.style_dim, device=card)
        with torch.no_grad():
            args = ren.field_args(grid, None, styles, precision)
        assert args[0].shape == (1, 64 * 64 * 24, 3)
    sf.reset_launch_counts()
    with torch.no_grad():
        got = sf.siren_field_full(*args, precision=precision)
        want = sf.siren_field_reference(*args, precision=precision)
    torch.cuda.synchronize()
    assert sf.launch_counts == {"siren_field_full": 1, "siren_field_tex": 0}
    for g, w, kind in zip(got[:2], want[:2], ("hidden", "head")):
        mx, mean, ok = sf.kernel_errors(g, w, kind, precision)
        assert ok, f"{kind} output: max {mx:.3e} mean {mean:.3e} against {sf.KERNEL_TOLERANCE[precision][kind]}"


@pytest.mark.cuda
def test_rasterizer_library_builds_and_matches_its_reference(card):
    """The host rasterizer that the depth-mesh and projected-noise videos run
    beside the card: built from csrc/marching.cpp, bit for bit its numpy
    version."""
    import numpy as np

    from e3dge_torch.utils import mesh

    rng = np.random.RandomState(0)
    verts = np.concatenate([rng.uniform(-3, 67, (200, 2)), rng.uniform(0.5, 2, (200, 1))], 1).astype(np.float32)
    faces = rng.randint(0, 200, (300, 3)).astype(np.int32)
    color = rng.randn(200).astype(np.float32)
    got, want = mesh.rasterize(verts, faces, color, 48, 64), mesh.rasterize_reference(verts, faces, color, 48, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] > 0).mean() > 0.3


@pytest.mark.cuda
def test_eval_cli_metrics_on_the_card(card, tmp_path, monkeypatch):
    """`python -m e3dge_torch.eval --tiny --mode metrics` on its default
    device, the card: 5 PNGs at batch 2 give finite scores of 5 images, and
    the field kernel launches (1 + 1 per batch). The kernel is built for
    width 256, so the tiny config's field (and the decoder's input) is
    widened to it."""
    import json

    import numpy as np

    from e3dge_torch import config as tc
    from e3dge_torch import eval as teval
    from PIL import Image

    monkeypatch.setattr(teval, "make_config", lambda args: tc._with(
        tc.tiny_full_config(), renderer=dict(width=256), decoder=dict(in_channels=256)).validate())

    rng = np.random.RandomState(0)
    (tmp_path / "imgs").mkdir()
    for i in range(5):
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(tmp_path / "imgs" / f"{i}.png")
    sf.reset_launch_counts()
    assert teval.main(["--tiny", "--data", str(tmp_path / "imgs"), "--out", str(tmp_path / "out"), "--batch", "2"]) == 0
    assert sf.launch_counts == {"siren_field_full": 3, "siren_field_tex": 3}
    (scores,) = json.loads((tmp_path / "out" / "scores.json").read_text())
    assert scores["num_images"] == 5 and all(np.isfinite(v) for v in scores.values())


# -- Runner.image2image replayed as CUDA graphs (utils/graphs.py) --------------

SERVE_LAYERS = ("e0.encoder", "e0.pose", "g0.render", "e1.filter", "e1.fusion", "g1.decoder")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A Runner on the card at demo_view_synthesis_config's full widths, seeded
    weights and mean latents (the field f32 `highest`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs exist only there")
    from e3dge_torch import config as tc
    from e3dge_torch.models.e3dge import E3DGE, LatentMeans
    from e3dge_torch.runner import Runner
    from e3dge_torch.utils.weights import init_weights

    cfg = tc.demo_view_synthesis_config()
    model = E3DGE(cfg, device="cuda")
    init_weights(model, 0)
    g = torch.Generator().manual_seed(0)
    ml = LatentMeans(0.2 * torch.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim, generator=g),
                     0.2 * torch.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim, generator=g))
    return Runner(model, ml, "cuda", work_dir=tmp_path_factory.mktemp("served"))


def _request(runner, b, seed):
    """b seeded host photos in [-1, 1] and their decoder noise on the card."""
    g = torch.Generator().manual_seed(seed)
    res = runner.cfg.pifu.load_size
    photos = torch.rand(b, 3, res, res, generator=g) * 2 - 1
    noise = [torch.randn(n.shape, generator=g).cuda() for n in runner.make_noise(b)]
    return photos, noise


def _answers(out) -> dict:
    lat = out["ref_info"]["pred_latents"]
    return {"image": out["res_render_out"]["gen_imgs"], "thumb": out["ref_info"]["global_render_out"]["gen_thumb_imgs"],
            "latents": torch.cat([lat[0].flatten(1), lat[1].flatten(1)], 1)}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
    return [t for v in items for t in _tensors(v)]


def _assert_equal(got: dict, want: dict) -> None:
    for name in want:
        assert torch.equal(got[name], want[name]), f"{name}: max gap {float((got[name] - want[name]).abs().max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
def test_replay_equals_the_eager_path_bitwise(served, b):
    """The call that captures answers from its eager warm-up; the replays that
    follow, on other photos and noise, equal the eager path bit for bit in
    the image, the G0 thumb and the latents (so the field kernel's ctypes
    launches are in the graphs), from one chain of a few graphs."""
    from e3dge_torch.utils import graphs

    runner = served
    runner.graphs.chains.clear()
    for seed in range(3):
        photos, noise = _request(runner, b, 100 * b + seed)
        got = _answers(runner.image2image(photos, noise))
        want = _answers(runner._invert(photos, noise))
        _assert_equal(got, want)
    chain = runner.graphs.chains[graphs.signature((photos, noise))]
    assert len(runner.graphs.chains) == 1 and 5 <= chain.launches <= 25


@pytest.mark.cuda
def test_held_outputs_survive_later_calls(served):
    """A caller may keep an answer: the capture's (eager) and a replay's
    answers are unchanged by the calls after them, and no output tensor lies
    in the graphs' memory."""
    from e3dge_torch.utils import graphs

    runner = served
    runner.graphs.chains.clear()
    outs, kept = [], []
    for seed in range(3):
        out = runner.image2image(*_request(runner, 1, 200 + seed))
        outs.append(out)
        kept.append([t.clone() for t in _tensors(out)])
    for out, copies in zip(outs, kept):
        for t, c in zip(_tensors(out), copies):
            assert torch.equal(t, c)
    assert not torch.equal(outs[1]["res_render_out"]["gen_imgs"], outs[2]["res_render_out"]["gen_imgs"])
    (chain,) = runner.graphs.chains.values()
    pool = {t.untyped_storage().data_ptr() for t in _tensors(chain.out) + chain.static}
    assert not pool & {t.untyped_storage().data_ptr() for out in outs for t in _tensors(out)}
    assert outs[2]["que_info"] is outs[2]["ref_info"]["global_render_out"]
    assert graphs.signature(_request(runner, 1, 0)) in runner.graphs.chains


@pytest.mark.cuda
def test_an_in_place_weight_update_recaptures(served):
    """An in-place update of a field weight (whose kernel pack is cached)
    drops the chain: the next call captures again and both it and the replay
    after it equal the eager path at the new weights."""
    from e3dge_torch.utils import graphs

    runner = served
    photos, noise = _request(runner, 1, 300)
    sig = graphs.signature((photos, noise))
    before = _answers(runner.image2image(photos, noise))
    runner.image2image(photos, noise)
    chain = runner.graphs.chains[sig]
    weight = runner.model.generator.renderer.network.pts_linears[3].weight
    saved = weight.detach().clone()
    try:
        with torch.no_grad():
            weight.mul_(1.5)
        got = _answers(runner.image2image(photos, noise))
        assert runner.graphs.chains[sig] is not chain
        again = _answers(runner.image2image(photos, noise))
        want = _answers(runner._invert(photos, noise))
        _assert_equal(got, want)
        _assert_equal(again, want)
        assert not torch.equal(got["image"], before["image"])
    finally:
        with torch.no_grad():
            weight.copy_(saved)


@pytest.mark.cuda
def test_a_second_batch_size_captures_a_second_chain(served):
    runner = served
    runner.graphs.chains.clear()
    for b in (1, 2, 1, 2, 2):
        runner.image2image(*_request(runner, b, 400 + b))
    assert sorted(sig[0][0][0] for sig in runner.graphs.chains) == [1, 2]


@pytest.mark.cuda
def test_a_traced_replay_gives_each_layer_its_device_time(served):
    """Under the profiler each replayed kernel links to its graph's launch
    inside the right span: per layer span, the same device operations by
    name (memsets as one, memcpys as one) as the eager path, their device time within 5% of it (replayed,
    e0.pose's small kernels ran 1.3-2.6% faster than launched one by one)
    and all six spans' within 2%, the field kernels in g0.render, and one
    "graph.replay" per call."""
    from torch.profiler import ProfilerActivity, profile

    from e3dge_torch.utils import trace

    runner = served
    photos, noise = _request(runner, 1, 500)
    cache = runner.graphs

    def layers(graphed: bool, calls: int = 3):
        runner.graphs = cache if graphed else None
        try:
            for _ in range(2):
                runner.image2image(photos, noise)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    runner.image2image(photos, noise)
                torch.cuda.synchronize()
        finally:
            runner.graphs = cache
        ops, host = trace.read(prof)
        return trace.Layers(ops, host), [h for h in host if h[2] == trace.REPLAY]

    eager, no_replays = layers(False)
    graphed, replays = layers(True)
    assert not no_replays and len(replays) == 3
    def kinds(lay, name):  # a graph's memset and memcpy nodes may run as kernels ("memset32", "memcpy32_post")
        return sorted(next((k for k in ("memset", "memcpy") if k in op[0].lower()), op[0]) for op in lay.own[name])

    for name in SERVE_LAYERS:
        assert kinds(graphed, name) == kinds(eager, name), name
        assert graphed.device_ns(name) == pytest.approx(eager.device_ns(name), rel=0.05), name
    total = [sum(lay.device_ns(name) for name in SERVE_LAYERS) for lay in (graphed, eager)]
    assert total[0] == pytest.approx(total[1], rel=0.02)
    assert any("siren_field" in op[0] for op in graphed.own["g0.render"])
