"""The encoder factory of the PyTorch port (`e3dge_torch/models/encoders/
factory.py`, `variants.py`) against the JAX package's, at `tiny_test_config`:
every `set_encoder` name on the same seeded weights (seeded values in the shapes of the JAX
module's variables, `seeded_from_shapes`, carried across by
`utils/weights.encoder_state_dict_from_jax` and loaded with strict=True),
in eval mode and in train mode (BatchNorm on the batch's statistics, and
the running statistics it leaves); e4e's progressive stages; the featmap
refusals; and each weight mapping's round trip.

Tolerances: the W+ codes 1e-4 of their scale (the conv-stack tolerance of
test_torch_models.py), BatchNorm running statistics 1e-5
(test_torch_training.py). JAX runs eagerly (flax `apply`, no compile)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import conv_atol

from e3dge_torch.config import tiny_test_config as t_tiny
from e3dge_torch.models.encoders import factory as tf
from e3dge_torch.models.encoders.variants import e4e_progressive_stage as t_stage
from e3dge_torch.utils import weights as tw
from e3dge_tpu.models.encoders import factory as jf
from e3dge_tpu.models.encoders.variants import e4e_progressive_stage as j_stage
from e3dge_tpu.utils import torch_ckpt
from e3dge_tpu.utils.config import tiny_test_config as j_tiny

# constructor arguments and input sizes at the tiny config: the volume-D
# encoders over 8^2 thumbs, the D-backbone ones over 32^2 at channel
# multiplier 1, FullEncoder with its 64^2 thumb passed
SMALL = {"VolumeRenderDiscriminatorEncoder": dict(init_size=8), "VolumeStyleEncoder": dict(init_size=8),
         "StyleGANEncoder": dict(input_size=32, channel_multiplier=1), "DEncoder": dict(input_size=32,
                                                                                    channel_multiplier=1),
         "FullEncoder": dict(input_size=32, channel_multiplier=1)}
SIZE = {"VolumeRenderDiscriminatorEncoder": 8, "VolumeStyleEncoder": 8, "StyleGANEncoder": 32, "DEncoder": 32,
        "FullEncoder": 32}
# the encoders whose every leaf torch_ckpt.flax_path_to_torch maps, by its top module
CKPT_TOP = {"HybridGradualStyleEncoder_V2": "encoder", "HybridBackboneEncoder": "encoder",
            "BackboneEncoderRenderer": "encoder", "Encoder4Editing": "encoder",
            "Encoder4EditingHybridBaseline": "encoder", "VolumeRenderDiscriminatorEncoder": "volume_discriminator",
            "VolumeStyleEncoder": "volume_discriminator", "StyleGANEncoder": "discriminator"}
# the inverse of each transform of utils/weights.py's rules
INVERSE = {tw._id: lambda a: a, tw._hwio_to_oihw: lambda a: a.transpose(2, 3, 1, 0)}


def _inputs(name):
    rng = np.random.RandomState(7)
    res = SIZE.get(name, t_tiny().encoder.input_res)
    x = rng.randn(2, 3, res, res).astype(np.float32)
    return (x, rng.randn(2, 3, 64, 64).astype(np.float32)) if name == "FullEncoder" else (x,)


def seeded_from_shapes(shapes, seed: int) -> dict:
    """Seeded variables from the shapes of a flax variables tree (no eager
    init: `jax.eval_shape`), at the scales of the modules' own inits: flax
    kernels N(0, 1 / fan_in), the torch-layout equalized-lr and demodulated
    weights N(0, 1) (their runtime scale divides), PReLU slopes 0.25 + 0.05
    N(0, 1), norm scales 1 + 0.05 N(0, 1), biases 0.05 N(0, 1); BatchNorm
    statistics as `seeded_variables` draws them."""
    rng = np.random.RandomState(seed)

    def leaf(path, sds):
        shape = tuple(sds.shape)
        n = rng.randn(*shape).astype(np.float32)
        if path.startswith("batch_stats"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32) if path.endswith("/var") else 0.1 * n
        name = path.rsplit("/", 1)[1]
        if name == "kernel":
            return n / np.sqrt(np.prod(shape[:-1]))
        if name == "alpha":
            return 0.25 + 0.05 * n
        if name == "scale":
            return 1.0 + 0.05 * n
        return n if name == "weight" else 0.05 * n

    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}/{k}") if isinstance(v, dict) else leaf(f"{prefix}/{k}", v).astype(np.float32)
                for k, v in sorted(tree.items())}

    return {k: walk(v, k) for k, v in dict(shapes).items()}


@pytest.fixture(scope="module")
def encoders():
    """{name: (JAX module, seeded variables, port module)}, one per
    `ENCODERS` name (the alias shares its target's weights)."""
    torch.set_num_threads(1)
    out = {}
    for name in jf.ENCODERS:
        jm = jf.set_encoder(name, j_tiny().encoder, **SMALL.get(name, {}))
        args = [jnp.asarray(a) for a in _inputs(name)]
        call = (lambda m, x, t: m(x, t)) if name == "FullEncoder" else (lambda m, x: m(x))
        shapes = jax.eval_shape(lambda *a, m=jm, c=call: m.init(jax.random.key(0), *a, method=c), *args)
        vs = seeded_from_shapes(shapes, seed=list(jf.ENCODERS).index(name))
        tm = tf.set_encoder(name, t_tiny().encoder, **SMALL.get(name, {}))
        tm.load_state_dict(tw.encoder_state_dict_from_jax(name, vs), strict=True)
        out[name] = (jm, vs, tm)
    return out


def _close(got, want, what):
    if want is None:
        assert got is None, what
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=conv_atol(want), err_msg=what)


@pytest.mark.parametrize("name", list(jf.ENCODERS))
def test_every_encoder_matches_jax_in_eval_mode(encoders, name):
    jm, vs, tm = encoders[name]
    args = _inputs(name)
    j_thumb, j_dec = jm.apply(vs, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        t_thumb, t_dec = tm.eval()(*(torch.from_numpy(a) for a in args))
    _close(t_thumb, j_thumb, f"{name} thumb")
    _close(t_dec, j_dec, f"{name} decoder")
    for got in (t_thumb, t_dec):
        assert got is None or float(got.abs().max()) > 1e-3  # live codes, not a zero head


@pytest.mark.parametrize("name", ["HybridGradualStyleEncoder_V2", "HybridBackboneEncoder", "BackboneEncoderRenderer",
                                  "Encoder4Editing"])
def test_the_ir_encoders_match_jax_in_train_mode(encoders, name):
    """BatchNorm on the batch's statistics, and the running statistics it
    leaves (flax's momentum 0.9 and biased variance), as JAX's train step."""
    jm, vs, tm = encoders[name]
    (x,) = _inputs(name)
    (j_thumb, j_dec), new = jm.apply(vs, jnp.asarray(x), train=True, mutable=["batch_stats"])
    sd0 = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        with torch.no_grad():
            t_thumb, t_dec = tm.train()(torch.from_numpy(x))
        _close(t_thumb, j_thumb, f"{name} thumb, train mode")
        _close(t_dec, j_dec, f"{name} decoder, train mode")
        sd = tm.state_dict()
        moved = 0
        for path, want in torch_ckpt.flatten_tree({"batch_stats": new["batch_stats"]}).items():
            key, _ = tw.ENCODER_RULES[name](path.split("/", 1)[1])
            np.testing.assert_allclose(sd[key].numpy(), np.asarray(want), atol=1e-5, err_msg=key)
            moved += not torch.equal(sd[key], sd0[key])
        assert moved == len(torch_ckpt.flatten_tree(new["batch_stats"]))
    finally:
        tm.load_state_dict(sd0)
        tm.eval()


@pytest.mark.parametrize("name", list(jf.ENCODERS))
def test_each_weight_mapping_round_trips(encoders, name):
    """The port's state dict after a strict load gives back JAX's leaves
    exactly: through torch_ckpt.ingest_variables(strict=True) where
    flax_path_to_torch has a rule, else through the inverse of the port's own
    rules (DEncoder's heads, FullEncoder's halves)."""
    _, vs, tm = encoders[name]
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    want = torch_ckpt.flatten_tree(vs)
    if name in CKPT_TOP:
        top = CKPT_TOP[name]
        nested = {coll: {top: tree} for coll, tree in vs.items()}
        back, missing = torch_ckpt.ingest_variables(nested, {top: sd}, strict=True)
        got = {p.replace(f"/{top}/", "/", 1): v for p, v in torch_ckpt.flatten_tree(back).items()}
        assert not missing
    else:
        got = {}
        for path in want:
            key, transform = tw.ENCODER_RULES[name](path.split("/", 1)[1])
            got[path] = INVERSE[transform](sd[key])
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(value), err_msg=path)


def test_e4e_progressive_stages_match_jax(encoders):
    """Stage 0: every row equals the base row; stage 1 (by the schedule at
    step 10 every 10) turns row 1's delta on and leaves row 2 the base; each
    as JAX's at the same per-call stage (test_components.py:102)."""
    jm, vs, tm = encoders["Encoder4Editing"]
    (x,) = _inputs("Encoder4Editing")
    for step in (0, 10):
        stage = t_stage(step, every=10)
        assert stage == int(j_stage(step, every=10))
        j_thumb, j_dec = jm.apply(vs, jnp.asarray(x), stage=jnp.asarray(int(j_stage(step, every=10))))
        with torch.no_grad():
            t_thumb, t_dec = tm.eval()(torch.from_numpy(x), stage=stage)
        _close(t_thumb, j_thumb, f"stage {stage} thumb")
        _close(t_dec, j_dec, f"stage {stage} decoder")
        for codes in (t_thumb, t_dec):
            assert torch.equal(codes[:, 2], codes[:, 0])
            assert torch.equal(codes[:, 1], codes[:, 0]) == (stage == 0)
    assert int(t_stage(torch.tensor(1000), every=10)) == 18


@pytest.mark.parametrize("name", ["HybridBackboneEncoder", "BackboneEncoderRenderer", "Encoder4Editing"])
def test_the_variants_refuse_return_featmap(encoders, name):
    _, _, tm = encoders[name]
    (x,) = _inputs(name)
    with pytest.raises(ValueError, match="no FPN feature maps"):
        tm(torch.from_numpy(x), return_featmap=True)


def test_set_encoder_refuses_an_unknown_name_and_the_volume_encoder_predicts_views(encoders):
    with pytest.raises(KeyError, match="unknown encoder_type"):
        tf.set_encoder("NoSuchEncoder", t_tiny().encoder)
    jm, vs, tm = encoders["VolumeRenderDiscriminatorEncoder"]
    (x,) = _inputs("VolumeRenderDiscriminatorEncoder")
    want = jm.apply(vs, jnp.asarray(x), pred_viewpoints=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pred_viewpoints=True)
    assert got.shape == (2, 2)
    _close(got, want, "viewpoints")
