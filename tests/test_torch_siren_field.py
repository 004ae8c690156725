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


def _unswizzle(stages: torch.Tensor) -> torch.Tensor:
    """[K/64, out, 64] stages -> the [out, K] weight, by the byte layout the
    serving kernel reads: element (n, k) of stage k // 64 at row n, 16-byte
    chunk ((k % 64) // 8) ^ (n % 8), place k % 8."""
    nst, n_out, _ = stages.shape
    n, k = np.meshgrid(np.arange(n_out), np.arange(nst * 64), indexing="ij")
    flat = (k // 64) * n_out * 64 + n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8
    return stages.reshape(-1)[torch.from_numpy(flat)]


def test_serving_pack_weight_stages_unswizzle_bit_for_bit(field):
    net = field["tm"]
    pack = net.pack("serving")
    bits = lambda t: t.to(torch.bfloat16).view(torch.int16)  # noqa: E731
    for i in range(1, DEPTH):
        assert torch.equal(bits(_unswizzle(pack["wring"][i - 1])), bits(net.pts_linears[i].weight.detach()))
    assert torch.equal(bits(_unswizzle(pack["wvring"])), bits(net.views_linears.weight.detach()[:, :WIDTH]))
    # the f32 kernel reads its own stages: TF32 hi|lo parts as f32 bit patterns
    ring = net.pack("highest")["wring"]
    assert ring.dtype == torch.float32 and ring.shape == (DEPTH - 1, sf.tf32_layer_stages(WIDTH), WIDTH, 32)


def test_serving_pack_stage_sizes_and_alignment(field):
    """One stage = one bulk copy of W rows x 128 bytes, contiguous, 16-byte
    aligned in memory and a whole number of 1024-byte swizzle atoms."""
    pack = field["tm"].pack("serving")
    ring, vring = pack["wring"], pack["wvring"]
    assert ring.shape == (DEPTH - 1, WIDTH // sf.STAGE_K, WIDTH, sf.STAGE_K) and ring.dtype == torch.bfloat16
    assert vring.shape == (WIDTH // sf.STAGE_K, WIDTH, sf.STAGE_K) and vring.dtype == torch.bfloat16
    for t in (ring, vring):
        stage_bytes = t.stride(-3) * t.element_size()
        assert t.is_contiguous() and stage_bytes == WIDTH * 128 and stage_bytes % 1024 == 0
        assert t.data_ptr() % 16 == 0
    with pytest.raises(ValueError):
        sf.sw128_stages(torch.zeros(WIDTH, 96))


def test_pack_is_cached_and_rebuilt_after_an_inplace_edit(field):
    net = TSiren(DEPTH, WIDTH, STYLE)
    net.load_state_dict(field["tm"].state_dict())
    first = net.pack("serving")
    assert net.pack("serving") is first and net.pack("highest") is not first
    with torch.no_grad():
        net.pts_linears[1].weight.mul_(2.0)
    second = net.pack("serving")
    assert second is not first
    want = net.pts_linears[1].weight.detach().to(torch.bfloat16).view(torch.int16)
    assert torch.equal(_unswizzle(second["wring"][0]).view(torch.int16), want)
    assert torch.equal(second["wst"][0], net.pts_linears[1].weight.detach().t().to(torch.bfloat16))


# ------------------------------------------------- the highest kernel's TF32 pack


def _rna_tf32_reference(w: np.ndarray) -> np.ndarray:
    """Round f32 values to 11 significant bits, ties away from zero, in f64
    arithmetic (independent of the bit trick in `sf.rna_tf32`)."""
    m, e = np.frexp(w.astype(np.float64))  # w = m * 2**e, 0.5 <= |m| < 1
    return (np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5) * 2.0 ** (e - 11)).astype(np.float32)


def _tf32_unswizzle(stages: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[K/16 + K/32, out, 32] stages -> the (hi, lo) [out, K] weights of the
    small-product stages and the hi [out, K] of the big-product ones, by the
    byte layout the highest kernel reads: place p of row n of a stage at
    16-byte chunk (p // 4) ^ (n % 8), element p % 4. In small stage s, place p
    < 16 holds the hi part of input 16s + 8 * (p // 8) + TF32_PERM[p % 8] and
    place 16 + p its lo part; in big stage t, place p the hi part of input
    32t + 8 * (p // 8) + TF32_PERM[p % 8]."""
    n_out = stages.shape[1]
    k_in = stages.shape[0] * 32 // 3
    inv = np.argsort(sf.TF32_PERM)  # place of each input within its 8-block

    def read(first: int, per: int, offset: int) -> torch.Tensor:
        n, k = np.meshgrid(np.arange(n_out), np.arange(k_in), indexing="ij")
        p = 8 * (k % per // 8) + inv[k % 8] + offset
        flat = (first + k // per) * n_out * 32 + n * 32 + ((p // 4) ^ (n % 8)) * 4 + p % 4
        return stages.reshape(-1)[torch.from_numpy(flat)]

    return read(0, 16, 0), read(0, 16, 16), read(k_in // 16, 32, 0)


def test_highest_pack_tf32_stages_unswizzle_bit_for_bit(field):
    """The stages hold rna(W) (in both passes' stages) and rna(W - rna(W)) bit
    for bit; every part has
    its low 13 mantissa bits zero (what the card drops when it reads TF32);
    hi + lo is W to 2^-21 relative."""
    net = field["tm"]
    pack = net.pack("highest")
    weights = [net.pts_linears[i].weight.detach() for i in range(1, DEPTH)]
    weights.append(net.views_linears.weight.detach()[:, :WIDTH])
    for stages, w in zip([*pack["wring"], pack["wvring"]], weights):
        hi, lo, big_hi = _tf32_unswizzle(stages)
        want_hi = _rna_tf32_reference(w.numpy())
        want_lo = _rna_tf32_reference(w.numpy() - want_hi)
        assert np.array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
        assert np.array_equal(big_hi.numpy().view(np.uint32), want_hi.view(np.uint32))
        assert np.array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
        for part in (stages, hi, lo):
            assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
        assert float(((hi.double() + lo.double() - w.double()).abs() - 2.0**-21 * w.double().abs()).max()) <= 0
        assert float(lo.abs().max()) > 0  # the lo parts carry the remainder


def test_highest_pack_stage_sizes_and_alignment(field):
    """One stage = one bulk copy of W rows x 128 bytes (16 hi + 16 lo, or 32
    hi, f32), contiguous, 16-byte aligned and a whole number of 1024-byte
    swizzle atoms; W/16 + W/32 stages per layer; widths off the 32-input
    stage are refused."""
    pack = field["tm"].pack("highest")
    ring, vring = pack["wring"], pack["wvring"]
    per_layer = WIDTH // 16 + WIDTH // 32
    assert sf.tf32_layer_stages(WIDTH) == per_layer
    assert ring.shape == (DEPTH - 1, per_layer, WIDTH, 32) and vring.shape == (per_layer, WIDTH, 32)
    for t in (ring, vring):
        stage_bytes = t.stride(-3) * t.element_size()
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert stage_bytes == WIDTH * 128 and stage_bytes % 1024 == 0 and t.data_ptr() % 16 == 0
    with pytest.raises(ValueError):
        sf.tf32_stages(torch.zeros(WIDTH, 24))


def test_rna_tf32_rounds_ties_away_from_zero():
    """Halfway cases go away from zero, as cvt.rna does; others to nearest."""
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32 spacing at 1
    x = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23, 1 + 3 * 2.0**-11, 0.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, 1 + 2 * ulp, 0.0], np.float32)
    got = sf.rna_tf32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _rna_tf32_reference(x))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32_reference(pts, dirs, pack, gamma, beta, split: bool):
    """`siren_field_reference` in `highest` with every 256x256 product taken as
    the kernel takes it: split (hi.hi + lo.hi + hi.lo of `sf.tf32_split`
    parts, summed exactly) or, for the control, single-pass TF32 (hi.hi)."""
    def mm(a, w):
        (a_hi, a_lo), (w_hi, w_lo) = sf.tf32_split(a), sf.tf32_split(w)
        if not split:
            return (a_hi.double() @ w_hi.double()).float()
        return ((a_hi.double() + a_lo.double()) @ w_hi.double() + a_hi.double() @ w_lo.double()).float()

    depth = pack["bst"].shape[0]
    h = torch.sin(gamma[:, 0:1] * (pts @ pack["w0t"] + pack["bst"][0]) + beta[:, 0:1])
    for i in range(1, depth):
        h = torch.sin(gamma[:, i : i + 1] * (mm(h, pack["wst"][i - 1]) + pack["bst"][i]) + beta[:, i : i + 1])
    sdf = h @ pack["wsig"][:, None] + pack["bheads"][3]
    zv = mm(h, pack["wvht"]) + dirs @ pack["wvdt"] + pack["bv"]
    feat = torch.sin(gamma[:, depth : depth + 1] * zv + beta[:, depth : depth + 1])
    rgb = feat @ pack["wrgb"].t() + pack["bheads"][:3]
    return feat, torch.cat([rgb, sdf], dim=-1), h


def test_3xtf32_field_stays_within_half_the_highest_tolerance(one_thread):
    """At the kernel's width and the stage-2 depth (W=256, D=8; N=8,192 points
    in the [-1, 1] box, styles 0.3 N(0, 1)), the 3xTF32 field agrees with
    the plain f32 field within half of KERNEL_TOLERANCE["highest"] on every
    output; the control, single-pass TF32, falls outside the tolerance."""
    rng = np.random.RandomState(0)
    n, depth, width = 8192, 8, 256
    torch.manual_seed(0)
    net = TSiren(depth, width, width)
    pts = torch.from_numpy(rng.uniform(-1, 1, (1, n, 3)).astype(np.float32))
    dirs = rng.randn(1, n, 3).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    styles = torch.from_numpy((0.3 * rng.randn(1, depth + 1, width)).astype(np.float32))
    with torch.no_grad():
        gamma, beta = net.film_vectors(styles)
        pack = net.pack("highest")
        want = sf.siren_field_reference(pts, dirs, pack, gamma, beta, precision="highest", return_raw_h=True)
        got = _tf32_reference(pts, dirs, pack, gamma, beta, split=True)
        single = _tf32_reference(pts, dirs, pack, gamma, beta, split=False)
    names = ("feat", "rgb_sdf", "raw_h")
    kinds = ("hidden", "head", "hidden")
    for g, w, kind, name in zip(got, want, kinds, names):
        mx, mean, _ = sf.kernel_errors(g, w, kind, "highest")
        print(f"3xTF32 {name}: max {mx:.3g} mean {mean:.3g}")
        tol_max, tol_mean = sf.KERNEL_TOLERANCE["highest"][kind]
        assert mx <= tol_max / 2 and mean <= tol_mean / 2, (kind, mx, mean)
    single_errors = [sf.kernel_errors(g, w, kind, "highest") for g, w, kind in zip(single, want, kinds)]
    print("single TF32:", ", ".join(f"{n} max {mx:.3g} mean {mean:.3g}" for n, (mx, mean, _) in zip(names, single_errors)))
    assert not all(ok for _, _, ok in single_errors)
