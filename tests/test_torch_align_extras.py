"""The align ablation blocks of the PyTorch port (`e3dge_torch/models/
align.py`: ResidualEncoder, FeatureAligner with feature_l2_norm and
correlation_volume, DemodulatedConv2d, ConvResBlock, FuseSftBlock,
ResidualConvBlock, AlignInpainterFusionBlock) against the JAX package's
(`e3dge_tpu/models/align.py:138-409`) on the same seeded weights (seeded
values in the shapes of the JAX variables, carried across by
`utils/weights.align_state_dict_from_jax`, the port's own rules, and loaded
with strict=True), with each mapping's round trip.

Tolerances: each block's outputs 1e-4 of their scale (the conv-stack
tolerance of test_torch_models.py), BatchNorm running statistics 1e-5
(test_torch_training.py), the correlation volume's entries 1e-5 relative
(one product of 4 terms). JAX runs eagerly (flax `apply`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_encoder_variants import INVERSE, seeded_from_shapes
from test_torch_models import conv_atol

from e3dge_torch.models import align as ta
from e3dge_torch.utils import weights as tw
from e3dge_tpu.models import align as ja
from e3dge_tpu.utils import torch_ckpt

RNG = np.random.RandomState(3)
X = RNG.randn(2, 8, 8, 8).astype(np.float32)
X2 = RNG.randn(2, 8, 8, 8).astype(np.float32)
MASK = RNG.uniform(0, 1, (2, 1, 8, 8)).astype(np.float32)
RES = RNG.randn(2, 3, 32, 32).astype(np.float32)
CTX = {"residual": RNG.randn(2, 3, 16, 16).astype(np.float32), "depth": RNG.randn(2, 1, 16, 16).astype(np.float32),
       "ref": RNG.randn(2, 8, 16, 16).astype(np.float32), "thumb": RNG.randn(2, 3, 16, 16).astype(np.float32)}

# (JAX block, its call's arguments and keywords, the port's block, its call's
# keywords): the blocks at small widths, every optional branch on
CASES = {
    "ResidualEncoder": (lambda: ja.ResidualEncoder(cond_channels=8, cond_res=8), (RES,), {},
                        lambda: ta.ResidualEncoder(cond_channels=8, cond_res=8), {}),
    "ResidualEncoder, no norm": (lambda: ja.ResidualEncoder(cond_channels=8, cond_res=8, norm="none"), (RES,), {},
                                 lambda: ta.ResidualEncoder(cond_channels=8, cond_res=8, norm="none"), {}),
    "FeatureAligner": (lambda: ja.FeatureAligner(), (CTX["residual"], CTX["depth"], CTX["ref"], CTX["thumb"]), {},
                       lambda: ta.FeatureAligner(ref_feats_dim=8), {}),
    "DemodulatedConv2d": (lambda: ja.DemodulatedConv2d(6, 3, padding=1), (X,), {},
                          lambda: ta.DemodulatedConv2d(8, 6, 3, padding=1), {}),
    "DemodulatedConv2d, bias, stride 2": (lambda: ja.DemodulatedConv2d(6, 3, stride=2, padding=1, use_bias=True),
                                          (X,), {}, lambda: ta.DemodulatedConv2d(8, 6, 3, 2, 1, bias=True), {}),
    "ConvResBlock": (lambda: ja.ConvResBlock(8), (X,), {}, lambda: ta.ConvResBlock(8, 8), {}),
    "ConvResBlock, 8 -> 32": (lambda: ja.ConvResBlock(32), (X,), {}, lambda: ta.ConvResBlock(8, 32), {}),
    "FuseSftBlock": (lambda: ja.FuseSftBlock(out_ch=8), (X, X2), {"w": 0.5}, lambda: ta.FuseSftBlock(16, 8),
                     {"w": 0.5}),
    "ResidualConvBlock": (lambda: ja.ResidualConvBlock(8), (X,), {}, lambda: ta.ResidualConvBlock(8, 8), {}),
    "ResidualConvBlock, 8 -> 12": (lambda: ja.ResidualConvBlock(12), (X,), {}, lambda: ta.ResidualConvBlock(8, 12),
                                   {}),
    "AlignInpainterFusionBlock": (lambda: ja.AlignInpainterFusionBlock(), (X, X2, MASK), {},
                                  lambda: ta.AlignInpainterFusionBlock(8), {}),
    "AlignInpainterFusionBlock, no reshape": (lambda: ja.AlignInpainterFusionBlock(), (X, X2, MASK),
                                              {"reshape": False}, lambda: ta.AlignInpainterFusionBlock(8),
                                              {"reshape": False}),
}
WITH_BN = ("ResidualEncoder", "FeatureAligner")


def _block(name: str) -> str:
    return name.split(",")[0]


@pytest.fixture(scope="module")
def blocks():
    """{case: (JAX block, seeded variables, port block)}."""
    torch.set_num_threads(1)
    out = {}
    for i, (name, (jmake, args, kw, tmake, _)) in enumerate(CASES.items()):
        jm = jmake()
        shapes = jax.eval_shape(lambda *a, m=jm, k=kw: m.init(jax.random.key(0), *a, **k),
                                *(jnp.asarray(a) for a in args))
        vs = seeded_from_shapes(shapes, seed=100 + i)
        tm = tmake()
        tm.load_state_dict(tw.align_state_dict_from_jax(_block(name), vs), strict=True)
        out[name] = (jm, vs, tm)
    return out


def _outputs(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", list(CASES))
def test_each_block_matches_jax(blocks, name):
    jm, vs, tm = blocks[name]
    _, args, kw, _, t_kw = CASES[name]
    want = _outputs(jm.apply(vs, *(jnp.asarray(a) for a in args), **kw))
    with torch.no_grad():
        got = _outputs(tm.eval()(*(torch.from_numpy(a) for a in args), **t_kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=conv_atol(w), err_msg=name)
        assert float(g.abs().max()) > 1e-3


@pytest.mark.parametrize("name", WITH_BN)
def test_the_batchnorm_blocks_match_jax_in_train_mode(blocks, name):
    """Train mode: BatchNorm on the batch's statistics (rank-synced in a
    data-parallel step, as E0's) and the running statistics it leaves."""
    jm, vs, tm = blocks[name]
    _, args, kw, _, t_kw = CASES[name]
    want, new = jm.apply(vs, *(jnp.asarray(a) for a in args), train=True, mutable=["batch_stats"], **kw)
    sd0 = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        with torch.no_grad():
            got = tm.train()(*(torch.from_numpy(a) for a in args), **t_kw)
        for g, w in zip(_outputs(got), _outputs(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=conv_atol(w), err_msg=name)
        sd = tm.state_dict()
        stats = torch_ckpt.flatten_tree({"batch_stats": new["batch_stats"]})
        for path, w in stats.items():
            key, _ = tw.ALIGN_RULES[name](path.split("/", 1)[1])
            np.testing.assert_allclose(sd[key].numpy(), np.asarray(w), atol=1e-5, err_msg=key)
            assert not torch.equal(sd[key], sd0[key])
    finally:
        tm.load_state_dict(sd0)
        tm.eval()


@pytest.mark.parametrize("name", list(CASES))
def test_each_weight_mapping_round_trips(blocks, name):
    """The port's state dict after a strict load gives back the JAX leaves
    exactly through the inverse of the port's rules (torch_ckpt has none for
    these blocks), and every state-dict entry is one leaf's."""
    _, vs, tm = blocks[name]
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    want = torch_ckpt.flatten_tree(vs)
    used = set()
    for path, value in want.items():
        key, transform = tw.ALIGN_RULES[_block(name)](path.split("/", 1)[1])
        used.add(key)
        np.testing.assert_array_equal(INVERSE[transform](sd[key]), np.asarray(value), err_msg=path)
    assert used == {k for k in sd if not k.endswith("num_batches_tracked")}


def test_correlation_volume_order_and_l2_norm_match_jax():
    """out[b, q, i, j] = <A[b, :, q's pixel], B[b, :, i, j]> with q over A's
    pixels in column-major order (test_components.py:163-170), as JAX's;
    feature_l2_norm gives unit channel vectors, as JAX's."""
    rng = np.random.RandomState(4)
    fa, fb = rng.randn(1, 4, 3, 3).astype(np.float32), rng.randn(1, 4, 3, 3).astype(np.float32)
    got = ta.correlation_volume(torch.from_numpy(fa), torch.from_numpy(fb)).numpy()
    assert got.shape == (1, 9, 3, 3)
    np.testing.assert_allclose(got, np.asarray(ja.correlation_volume(jnp.asarray(fa), jnp.asarray(fb))), rtol=1e-5,
                               atol=1e-6)
    a_cm = fa[0].transpose(0, 2, 1).reshape(4, 9)  # column-major: q = w * H + h
    for q in range(9):
        np.testing.assert_allclose(got[0, q, 1, 2], a_cm[:, q] @ fb[0, :, 1, 2], rtol=1e-5)
    np.testing.assert_allclose(got[0, 1, 0, 0], fa[0, :, 1, 0] @ fb[0, :, 0, 0], rtol=1e-5)  # q=1: (h=1, w=0)
    n = ta.feature_l2_norm(torch.from_numpy(fa)).numpy()
    np.testing.assert_allclose(n, np.asarray(ja.feature_l2_norm(jnp.asarray(fa))), rtol=1e-5)
    np.testing.assert_allclose((n**2).sum(1), 1.0, rtol=1e-4)


def test_demodulation_holds_each_output_kernel_to_unit_norm(blocks):
    """Demodulation scales every output channel's kernel to unit norm; the
    same convolution without it (the control) differs from JAX's."""
    jm, vs, tm = blocks["DemodulatedConv2d"]
    w = tm.weight[0] * torch.rsqrt((tm.weight**2).sum(dim=(2, 3, 4)) + 1e-8)[0][:, None, None, None]
    np.testing.assert_allclose((w**2).sum(dim=(1, 2, 3)).detach().numpy(), 1.0, rtol=1e-4)
    want = np.asarray(jm.apply(vs, jnp.asarray(X)))
    with torch.no_grad():
        plain = torch.nn.functional.conv2d(torch.from_numpy(X), tm.weight[0], padding=1)
    assert np.abs(plain.numpy() - want).max() > 100 * conv_atol(want)


def test_feature_aligner_refuses_inputs_its_constructor_did_not_name(blocks):
    _, _, tm = blocks["FeatureAligner"]
    with pytest.raises(ValueError, match="exactly the inputs"):
        tm(torch.from_numpy(CTX["residual"]), torch.from_numpy(CTX["depth"]))
