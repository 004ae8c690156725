"""The FiLM-SIREN field: the port's plain kernel version (`siren_field_reference`,
`siren_field_tex_reference`) and its eager twin (`models/siren.py`) against the
JAX `SirenGenerator` and the JAX Pallas kernel `siren_query_fused`, which runs
in interpret mode on the CPU as tests/test_pallas_siren.py runs it.

Tolerances follow tests/test_pallas_siren.py: "highest" (f32) 2e-5 abs
(`:31-33`); "serving" (bf16 operands, fast_sin) mean abs error < 0.05 against
the bf16 field (`:55`) — the FiLM gain (~30) turns bf16 rounding into sine
phase error, so only the mean is bounded. On the CUDA card the kernel is held
against the plain version by chip_smoke.py and tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3dge_torch.models.siren import SirenGenerator as TSiren
from e3dge_torch.ops import siren_field as sf
from e3dge_tpu.models.siren import SirenGenerator as JSiren
from e3dge_tpu.ops.pallas.siren_kernel import film_vectors, pack_siren_params, siren_query_fused

DEPTH, WIDTH, STYLE = 3, 128, 16
ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _torch_params(jparams):
    """flax SirenGenerator params -> the port's state_dict names."""
    sd = {}
    for k, v in _flat(jparams).items():
        sd[k.replace("pts_linears_", "pts_linears.")] = _t(v)
    return sd


@pytest.fixture(scope="module")
def field():
    rng = np.random.RandomState(0)
    n = 300  # not a multiple of any tile
    pts = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    dirs = rng.randn(1, n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    styles = (0.5 * rng.randn(1, DEPTH + 1, STYLE)).astype(np.float32)
    alpha = (0.1 * rng.randn(1, n, WIDTH)).astype(np.float32)
    lbeta = (0.1 * rng.randn(1, n, WIDTH)).astype(np.float32)
    jm = JSiren(depth=DEPTH, width=WIDTH, style_dim=STYLE)
    v = jm.init(jax.random.key(3), pts, dirs, styles)
    tm = TSiren(DEPTH, WIDTH, STYLE)
    tm.load_state_dict(_torch_params(v["params"]), strict=True)
    return dict(pts=pts, dirs=dirs, styles=styles, alpha=alpha, lbeta=lbeta, jm=jm, v=v, tm=tm)


def _port(f, precision, sft=False, return_raw_h=True):
    styles = _t(f["styles"])
    gamma, beta = f["tm"].film_vectors(styles.bfloat16() if precision == "serving" else styles)
    dt = sf.io_dtype(precision)
    alpha = _t(f["alpha"]).to(dt) if sft else None
    lbeta = _t(f["lbeta"]).to(dt) if sft else None
    with torch.no_grad():
        return sf.siren_field_full(
            _t(f["pts"]), _t(f["dirs"]), f["tm"].pack(precision), gamma, beta, alpha, lbeta,
            precision=precision, return_raw_h=return_raw_h,
        ), (gamma, beta, alpha, lbeta)


@pytest.mark.parametrize("sft", [False, True])
def test_reference_highest_matches_jax_field_and_pallas(field, sft):
    f = field
    cond = (jnp.asarray(f["alpha"]), jnp.asarray(f["lbeta"])) if sft else None
    want = np.asarray(f["jm"].apply(f["v"], f["pts"], f["dirs"], f["styles"], cond))[0]  # [n, 3+1+W]
    want_plain = np.asarray(f["jm"].apply(f["v"], f["pts"], f["dirs"], f["styles"]))[0]
    (feat, rgb_sdf, _), _ = _port(f, "highest", sft)
    feat, rgb_sdf = feat[0].numpy(), rgb_sdf[0].numpy()
    np.testing.assert_allclose(rgb_sdf[:, :3], want[:, :3], atol=ATOL)
    np.testing.assert_allclose(feat, want[:, 4:], atol=ATOL)
    # sdf reads the UNMODULATED backbone: the SFT leaves it unchanged
    np.testing.assert_allclose(rgb_sdf[:, 3], want_plain[:, 3], atol=ATOL)

    params = f["v"]["params"]
    pack = pack_siren_params(params, depth=DEPTH, width=WIDTH)
    gamma, beta = film_vectors(params, f["styles"][0], depth=DEPTH)
    pfeat, prgb_sdf = siren_query_fused(
        f["pts"][0], f["dirs"][0], pack, gamma, beta,
        cond[0][0] if sft else None, cond[1][0] if sft else None,
        depth=DEPTH, width=WIDTH, tile=128, precision="highest",
    )
    np.testing.assert_allclose(feat, np.asarray(pfeat), atol=ATOL)
    np.testing.assert_allclose(rgb_sdf[:, :3], np.asarray(prgb_sdf[:, :3]), atol=ATOL)
    np.testing.assert_allclose(rgb_sdf[:, 3], np.asarray(prgb_sdf[:, 3]), atol=ATOL)


@pytest.mark.parametrize("sft", [False, True])
def test_reference_serving_tracks_bf16_field_and_pallas(field, sft):
    f = field
    bf = jnp.bfloat16
    cond = (jnp.asarray(f["alpha"], bf), jnp.asarray(f["lbeta"], bf)) if sft else None
    want16 = np.asarray(
        f["jm"].apply(f["v"], *(jnp.asarray(f[k], bf) for k in ("pts", "dirs", "styles")), cond), np.float32
    )[0]
    (feat, rgb_sdf, raw_h), _ = _port(f, "serving", sft)
    assert feat.dtype == raw_h.dtype == torch.bfloat16 and rgb_sdf.dtype == torch.float32
    err = np.abs(feat[0].float().numpy() - want16[:, 4:])
    assert err.mean() < 0.05, f"serving field drifted from the bf16 JAX field: {err.mean():.4f}"
    err = np.abs(rgb_sdf[0].numpy() - want16[:, :4])
    assert err.mean() < 0.05

    params = f["v"]["params"]
    gamma, beta = film_vectors(params, jnp.asarray(f["styles"][0], bf), depth=DEPTH)
    pfeat, _ = siren_query_fused(
        f["pts"][0], f["dirs"][0], pack_siren_params(params, depth=DEPTH, width=WIDTH), gamma, beta,
        jnp.asarray(f["alpha"][0]) if sft else None, jnp.asarray(f["lbeta"][0]) if sft else None,
        depth=DEPTH, width=WIDTH, tile=128, precision="serving",
    )
    err = np.abs(feat[0].float().numpy() - np.asarray(pfeat))
    assert err.mean() < 0.05, f"serving field drifted from the Pallas serving kernel: {err.mean():.4f}"


@pytest.mark.parametrize("precision", ["highest", "serving"])
def test_raw_h_and_texture_entry_match_jax_heads(field, precision):
    """raw_h equals the JAX backbone, and the texture-only entry on that cache
    equals the JAX tex_head with the SFT conditions — the two passes of the
    same-view re-render."""
    f = field
    jm, v = f["jm"], f["v"]
    cond = (jnp.asarray(f["alpha"]), jnp.asarray(f["lbeta"]))
    h = jm.apply(v, jnp.asarray(f["pts"]), jnp.asarray(f["styles"]), method=JSiren.backbone)
    rgb_j, feat_j = jm.apply(v, h, jnp.asarray(f["dirs"]), jnp.asarray(f["styles"]), cond, method=JSiren.tex_head)
    (_, _, raw_h), (gamma, beta, alpha, lbeta) = _port(f, precision, sft=True)
    with torch.no_grad():
        feat, rgb = sf.siren_field_tex(
            raw_h, _t(f["dirs"]), f["tm"].pack(precision), gamma[:, -1], beta[:, -1], alpha, lbeta,
            precision=precision,
        )
        full_feat, full_rgb_sdf, _ = _port(f, precision, sft=True)[0]
    if precision == "highest":
        np.testing.assert_allclose(raw_h[0].numpy(), np.asarray(h)[0], atol=ATOL)
        np.testing.assert_allclose(feat[0].numpy(), np.asarray(feat_j)[0], atol=ATOL)
        np.testing.assert_allclose(rgb[0].numpy(), np.asarray(rgb_j)[0], atol=ATOL)
    else:
        assert np.abs(raw_h[0].float().numpy() - np.asarray(h)[0]).mean() < 0.05
        assert np.abs(feat[0].float().numpy() - np.asarray(feat_j)[0]).mean() < 0.05
    # the texture pass on the cache is the full pass's tail, exactly
    assert torch.equal(feat, full_feat)
    assert torch.equal(rgb, full_rgb_sdf[..., :3])


def test_twin_matches_jax_in_both_dtypes(field):
    f = field
    x = [f[k] for k in ("pts", "dirs", "styles")]
    cond = (f["alpha"], f["lbeta"])
    want = np.asarray(f["jm"].apply(f["v"], *x, tuple(jnp.asarray(c) for c in cond)))
    with torch.no_grad():
        got = f["tm"](*(_t(a) for a in x), tuple(_t(c) for c in cond)).numpy()
        got16 = f["tm"](*(_t(a).bfloat16() for a in x), tuple(_t(c).bfloat16() for c in cond))
    np.testing.assert_allclose(got, want, atol=ATOL)
    bf = jnp.bfloat16
    want16 = np.asarray(
        f["jm"].apply(f["v"], *(jnp.asarray(a, bf) for a in x), tuple(jnp.asarray(c, bf) for c in cond)),
        np.float32,
    )
    assert got16.dtype == torch.bfloat16
    assert np.abs(got16.float().numpy() - want16).mean() < 0.05


@pytest.mark.parametrize("precision", ["highest", "serving"])
@pytest.mark.parametrize("fault", ["zero_rgb", "zero_sdf", "zero_feat", "sdf_from_modulated_h", "nan"])
def test_kernel_tolerance_fails_planted_faults(field, precision, fault):
    """The limits that hold the kernel to its plain version on the card pass
    the plain version against itself and fail a wrong output: a zeroed head or
    hidden output, the sdf head reading the SFT-modulated h, a NaN."""
    (feat, rgb_sdf, _), (gamma, beta, alpha, lbeta) = _port(field, precision, sft=True)
    assert sf.kernel_errors(feat, feat.clone(), "hidden", precision)[2]
    assert sf.kernel_errors(rgb_sdf, rgb_sdf.clone(), "head", precision)[2]
    bad_feat, bad_rgb_sdf = feat.clone(), rgb_sdf.clone()
    if fault == "zero_rgb":
        bad_rgb_sdf[..., :3] = 0
    elif fault == "zero_sdf":
        bad_rgb_sdf[..., 3] = 0
    elif fault == "zero_feat":
        bad_feat.zero_()
    elif fault == "sdf_from_modulated_h":
        pack = field["tm"].pack(precision)
        with torch.no_grad():
            h = sf.siren_field_full(_t(field["pts"]), _t(field["dirs"]), pack, gamma, beta,
                                    precision=precision, return_raw_h=True)[2].float()
            h = (alpha.float() + 1.0) * h + lbeta.float()
            bad_rgb_sdf[..., 3] = (h @ pack["wsig"].float() + pack["bheads"][3])
    else:
        bad_rgb_sdf[0, 7, 1] = float("nan")
    assert not (sf.kernel_errors(bad_feat, feat, "hidden", precision)[2]
                and sf.kernel_errors(bad_rgb_sdf, rgb_sdf, "head", precision)[2])


def test_cpu_tensors_take_the_plain_version_and_count_nothing(field):
    sf.reset_launch_counts()
    (feat, _, _), _ = _port(field, "highest")
    assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        sf.siren_field_full(*(t.to("meta") for t in (_t(field["pts"]), _t(field["dirs"]))),
                            {}, None, None, precision="highest")
