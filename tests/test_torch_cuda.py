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


def _inputs(card, precision, n=300, sft=True):
    g = torch.Generator().manual_seed(n)
    torch.manual_seed(0)
    net = SirenGenerator(8, 256, 256).to(card)
    dt = sf.io_dtype(precision)
    pts = (torch.rand(2, n, 3, generator=g) * 2 - 1).to(card)
    dirs = torch.nn.functional.normalize(torch.randn(2, n, 3, generator=g), dim=-1).to(card)
    styles = (0.3 * torch.randn(2, 9, 256, generator=g)).to(card)
    alpha = (0.1 * torch.randn(2, n, 256, generator=g)).to(card, dt) if sft else None
    lbeta = (0.1 * torch.randn(2, n, 256, generator=g)).to(card, dt) if sft else None
    with torch.no_grad():
        gamma, beta = net.film_vectors(styles.to(torch.bfloat16) if precision == "serving" else styles)
    return pts, dirs, net.pack(precision), gamma, beta, alpha, lbeta


# feat, rgb_sdf, raw_h of the full entry, then feat, rgb of the texture entry
KINDS = ("hidden", "head", "hidden", "hidden", "head")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sf.PRECISIONS)
@pytest.mark.parametrize("sft", [False, True])
def test_full_and_texture_entries_match_plain(card, precision, sft):
    """B=2 (per-item FiLM rows in one launch), N=300 (a ragged last tile)."""
    args = _inputs(card, precision, sft=sft)
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
    with pytest.raises(ValueError):  # another width than the kernel's
        narrow = SirenGenerator(2, 64, 16).to(card)
        g, b = narrow.film_vectors(torch.zeros(2, 3, 16, device=card))
        sf.siren_field_full(pts, dirs, narrow.pack("highest"), g, b, precision="highest")
