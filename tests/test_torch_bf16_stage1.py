"""Stage-1 training of the PyTorch port at the JAX stage scripts' dtypes
(`scripts/train_stage1.sh:12-13`: `--sample-field-dtype bfloat16 --dtype
bfloat16 --field-dtype bfloat16`) against the JAX package's bf16 step at
`tiny_test_config`, on test_torch_training.py's seeded variables, perceptual
nets and lambdas (every stage-1 term on):

- the frozen-GAN sample at `sample_field_dtype="bfloat16"` (the serving
  field, the kernel's plain version on the CPU) against JAX's bf16 sample:
  images within the bf16 pipeline's mean relative error 0.05
  (tests/test_precision.py:94), the SDF targets from the f32 field
  (`highest`), at JAX's drawn points within the field tolerance 3e-3;
- the step on JAX's bf16 batch: every loss term within a relative error of
  0.05 of JAX's bf16 step's, and the port's E0 gradient no farther from
  JAX's bf16 gradient (relative L2) than JAX's bf16 gradient is from JAX's
  f32 gradient;
- the port's bf16 step against its own f32 step from the same stream: the
  loss within 0.15 relative and every updated parameter finite
  (tests/test_precision.py:159);
- a control, the eikonal double backward cut, fails those gates.

One compiled JAX step per precision, torch on one thread (the fixture of
test_torch_training.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import (FIELD_ATOL, LAMBDAS, _capture, _jax_draws, _np, _port, _t, _torch_batch,
                                 one_torch_thread, perceptual, setup)  # noqa: F401 (fixtures)

from e3dge_torch import config as tc
from e3dge_torch.models import volume_renderer as vr
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.training import steps as ts
from e3dge_torch.utils.weights import jax_path_to_torch
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.training.steps import STAGE1_TRAINABLE, create_train_state, make_stage1_step
from e3dge_tpu.utils import config as jc
from e3dge_tpu.utils.torch_ckpt import flatten_tree

TERM_RTOL, BF16_VS_F32_RTOL = 0.05, 0.15
BF16 = dict(sample_field_dtype="bfloat16", field_dtype="bfloat16")


def bf16_config(cfg, with_):
    """A config at the stage scripts' three dtypes."""
    return dataclasses.replace(with_(cfg, renderer=BF16), dtype="bfloat16").validate()


def rel_l2(got: dict, want: dict) -> float:
    """Relative L2 of all leaves together."""
    diff = np.sqrt(sum(np.square(np.float64(got[k]) - np.float64(w)).sum() for k, w in want.items()))
    return float(diff / np.sqrt(sum(np.square(np.float64(w)).sum() for w in want.values())))


def _jax_step(jmodel, vs, ml, jfns):
    """JAX's stage-1 step (one jit) with captured gradients under the port's
    parameter names, its metrics, and its batch (steps.py:280-289)."""
    tx = _capture()
    state = create_train_state(vs, STAGE1_TRAINABLE, tx)
    step = jax.jit(make_stage1_step(jmodel, LAMBDAS, tx, lpips_fn=jfns[0], id_fn=jfns[1]), static_argnums=(3,))
    rng = jax.random.key(7)
    new_state, metrics = step(state, JLM(jnp.asarray(ml[0]), jnp.asarray(ml[1])), rng, 2)
    k_data, k_noise = jax.random.split(rng)
    batch = jax.jit(lambda v: jmodel.apply(v, k_data, 2, 1.0, method=JE3DGE.synthetic_sample,
                                           rngs={"noise": k_noise}))(vs)
    grads = {}
    for path, w in flatten_tree(jax.tree.map(np.asarray, {"params": new_state.opt_state})).items():
        top, (key, transform) = jax_path_to_torch(path)
        grads[f"{top}.{key}"] = transform(w)
    return {k: float(v) for k, v in metrics.items()}, grads, batch


def _port_loss(vs, batch, ml, fns) -> tuple[dict, dict]:
    """The port's bf16 `stage1_loss` on a JAX batch: its metrics and E0's
    gradients."""
    tm = _port(bf16_config(tc.tiny_test_config(), tc._with), vs)
    params = ts.split_params(tm, ts.STAGE1_TRAINABLE)
    loss, metrics, _ = ts.stage1_loss(tm, _torch_batch(batch), TLM(_t(ml[0]), _t(ml[1])), LAMBDAS, *fns)
    loss.backward()
    return {k: float(v.detach()) for k, v in metrics.items()}, {k: _np(p.grad) for k, p in params.items()}


@pytest.fixture(scope="module")
def bf16_steps(setup, perceptual):
    cfg, jmodel, vs, ml = setup
    fns, jfns, _, _ = perceptual
    jmodel16 = JE3DGE(bf16_config(cfg, jc._with))
    _, g32, _ = _jax_step(jmodel, vs, ml, jfns)
    m16, g16, batch16 = _jax_step(jmodel16, vs, ml, jfns)
    return dict(vs=vs, ml=ml, fns=fns, jax=(m16, g16), jax_f32_grads=g32, batch=batch16)


def _gates(jax16, port) -> tuple[float, str, float]:
    """(the worst loss term's relative error, its name, the port's gradient
    gap to JAX's bf16 gradient)."""
    (m16, g16), (pm, pg) = jax16, port
    errs = {k: abs(pm[k] - w) / abs(w) for k, w in m16.items() if w != 0}
    worst = max(errs, key=errs.get)
    return errs[worst], worst, rel_l2(pg, g16)


def test_bf16_sample_tracks_jax(setup):
    """`synthetic_sample` at sample_field_dtype bfloat16 from JAX's draws: its
    images within TERM_RTOL mean relative error of JAX's bf16 sample, the
    SDF targets from the f32 field (`highest`) at the field tolerance."""
    cfg, _, vs, _ = setup
    jmodel16 = JE3DGE(bf16_config(cfg, jc._with))
    key = jax.random.key(2)
    want = jax.jit(lambda v: jmodel16.apply(v, key, 2, 1.0, True, method=JE3DGE.synthetic_sample,
                                            rngs={"noise": jax.random.key(3)}))(vs)
    tm = _port(bf16_config(tc.tiny_test_config(), tc._with), vs)
    got = tm.synthetic_sample(2, 1.0, True, draws=_jax_draws(cfg, key, 2))
    for k in ("images", "thumb_images"):
        w = np.asarray(want[k])
        err = np.abs(_np(got[k]) - w).mean() / np.abs(w).max()
        assert got[k].dtype == torch.float32 and err < TERM_RTOL, f"{k}: mean relative error {err:.4f}"
    # the uniform targets sit at JAX's drawn points: JAX's f32 query; the
    # near-surface ones at the bf16 render's surface, so the port's own f32
    # query at its points
    np.testing.assert_allclose(_np(got["uniform_sdf"]), np.asarray(want["uniform_sdf"]), atol=FIELD_ATOL)
    with torch.no_grad():
        f32 = tm.generator.renderer.query_sdf(got["near_pts"], got["latent_gt"])
    assert got["near_sdf"].dtype == got["uniform_sdf"].dtype == torch.float32
    assert torch.equal(got["near_sdf"], f32)


def test_bf16_stage1_step_tracks_jax(bf16_steps):
    """Every loss term of the port's bf16 step within TERM_RTOL of JAX's bf16
    step's, and the port's E0 gradient no farther from JAX's bf16 gradient
    than JAX's bf16 gradient is from its f32 one."""
    b = bf16_steps
    port = _port_loss(b["vs"], b["batch"], b["ml"], b["fns"])
    assert set(port[0]) == set(b["jax"][0]) and set(port[1]) == set(b["jax"][1])
    term, name, gap = _gates(b["jax"], port)
    bf16_vs_f32 = rel_l2(b["jax"][1], b["jax_f32_grads"])
    print(f"bf16 stage 1 vs JAX's bf16 step: worst term {name} {term:.3e}; E0 gradient {gap:.3e} (JAX bf16 vs JAX "
          f"f32 {bf16_vs_f32:.3e})")
    assert term < TERM_RTOL, f"{name}: relative error {term:.3e}"
    assert gap <= bf16_vs_f32, f"E0 gradient vs JAX's bf16: {gap:.3e}; JAX bf16 vs f32: {bf16_vs_f32:.3e}"


def test_eikonal_cut_control_fails_the_gates(bf16_steps, monkeypatch):
    """A planted fault, phase 7's control on the card: the predicted eikonal
    term taken without its graph (E0 loses the double backward's gradient),
    fails the JAX gates above. Faults at bf16's rounding scale do not: the
    gradient gate is as fine as JAX's own bf16-vs-f32 gap (0.41 here;
    BatchNorm statistics in bf16 read 0.22, the SDF queries in bf16 0.21)."""
    b = bf16_steps
    eikonal = ts.eikonal_term
    monkeypatch.setattr(ts, "eikonal_term", lambda r, p, s, create_graph=True: eikonal(r, p, s, create_graph=False))
    term, name, gap = _gates(b["jax"], _port_loss(b["vs"], b["batch"], b["ml"], b["fns"]))
    bf16_vs_f32 = rel_l2(b["jax"][1], b["jax_f32_grads"])
    print(f"control (eikonal double backward cut): worst term {name} {term:.3e}; E0 gradient {gap:.3e} (limit "
          f"{bf16_vs_f32:.3e})")
    assert term >= TERM_RTOL or gap > bf16_vs_f32


def test_bf16_stage1_step_tracks_the_ports_f32_step(setup):
    """`make_stage1_step` at the three bf16 dtypes against the same step in
    f32 on one stream (the perceptual nets off): the loss within
    BF16_VS_F32_RTOL, every updated E0 parameter finite and moved, the
    differentiable field evaluations on the twin in the expected
    precisions."""
    cfg, _, vs, ml = setup
    lambdas = {k: v for k, v in LAMBDAS.items() if k not in ("lpips_lambda", "id_lambda")}
    # the twin's evaluations per step: the inversion's render in the field
    # precision, four SDF queries (uniform, surface, two eikonal terms) f32
    twins = {"f32": {("field", "highest"): 5}, "bf16": {("field", "serving"): 1, ("field", "highest"): 4}}
    out = {}
    for name, c in (("f32", tc.tiny_test_config()), ("bf16", bf16_config(tc.tiny_test_config(), tc._with))):
        tm = _port(c, vs)
        state = ts.create_train_state(tm, ts.STAGE1_TRAINABLE, 1e-3)
        before = {k: p.detach().clone() for k, p in state.params.items()}
        vr.reset_twin_counts()
        m = ts.make_stage1_step(tm, lambdas, state)(TLM(_t(ml[0]), _t(ml[1])), 2, torch.Generator().manual_seed(5))
        assert {k: n for k, n in vr.twin_counts.items() if n} == twins[name]
        assert all(bool(torch.isfinite(p).all()) for p in state.params.values())
        assert any(not torch.equal(p, before[k]) for k, p in state.params.items())
        out[name] = float(m["loss"])
    rel = abs(out["bf16"] - out["f32"]) / abs(out["f32"])
    print(f"the port's bf16 stage-1 step vs its f32 step: loss {out['bf16']:.6f} vs {out['f32']:.6f} ({rel:.3e})")
    assert np.isfinite(out["bf16"]) and rel < BF16_VS_F32_RTOL
