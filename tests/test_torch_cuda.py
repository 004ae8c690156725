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
