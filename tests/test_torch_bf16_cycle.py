"""The stage-2 cycle step of the PyTorch port at the JAX stage scripts'
dtypes (`scripts/train_stage2.2.sh:12-13`: bf16 samples, bf16 conv stacks,
bf16 differentiated field) against the JAX package's bf16 cycle step at
`tiny_full_config`, B=2, with test_torch_cycle.py's seeded variables, full-res
D and every switch on. In the port the query render launches the serving
kernel (its plain version here) and keeps a bf16 `raw_h`, on which the
twin's texture head runs in bf16 under autograd; JAX re-renders the whole
bf16 field.

Gates, as test_torch_bf16_stage1.py's: every loss term within 0.05 relative
of JAX's bf16 step's; the port's trained-leaf gradient no farther from JAX's
bf16 gradient (relative L2) than JAX's bf16 gradient is from JAX's f32
gradient (test_torch_cycle.py's compiled f32 step), and the adaptive D
weight, a ratio of two gradient norms, held as the whole gradient is
(test_torch_cycle.py's convention); the port's bf16 step
against its own f32 step within 0.15 on the loss, every updated parameter
finite; a control (the SFT modulations detached) fails the JAX gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16_stage1 import BF16_VS_F32_RTOL, TERM_RTOL, bf16_config, rel_l2
from test_torch_cycle import (B, D_LAMBDAS, DISC_WEIGHT_MAX, LAMBDAS, _compiled, _jax_grads, _port, _port_d,
                              cycle, setup)  # noqa: F401 (fixtures)
from test_torch_training import _capture, _np, _t, _torch_batch, one_torch_thread  # noqa: F401 (autouse)

from e3dge_torch import config as tc
from e3dge_torch.models import volume_renderer as vr
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.ops import siren_field as sf
from e3dge_torch.training import steps as ts
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE
from e3dge_tpu.models.e3dge import LatentMeans as JLM
from e3dge_tpu.training import steps as js
from e3dge_tpu.utils import config as jc


@pytest.fixture(scope="module")
def bf16_cycle(setup, cycle):
    """JAX's bf16 cycle step (one jit) with captured gradients and its batch;
    JAX's f32 gradients from test_torch_cycle.py's fixture."""
    cfg, _, vs, (ml_r, ml_d), jd, d_params = setup
    jmodel16 = JE3DGE(bf16_config(cfg, jc._with))
    tx = _capture()
    state = js.create_train_state(vs, js.STAGE22_TRAINABLE, tx, ema=True)
    _, d_apply = js.make_full_d_step(jd, D_LAMBDAS, tx)
    fn = js.make_cycle_step(jmodel16, LAMBDAS, tx, use_ref_view_weight=True, d_apply=d_apply, adaptive_d_loss=True,
                            disc_weight_max=DISC_WEIGHT_MAX)
    rng, jml = jax.random.key(7), JLM(jnp.asarray(ml_r), jnp.asarray(ml_d))
    new_state, metrics = _compiled(fn, state, jml, rng, B, d_params, static_argnums=(3,))(state, jml, rng, d_params)
    k_data, k_noise = jax.random.split(rng)
    jbatch = _compiled(lambda v: jmodel16.apply(v, k_data, B, 1.0, True, method=JE3DGE.synthetic_sample,
                                                rngs={"noise": k_noise}), vs)(vs)
    return dict(vs=vs, ml=(ml_r, ml_d), d_params=d_params, batch=jbatch,
                jax=({k: float(v) for k, v in metrics.items()}, _jax_grads({"new_state": new_state})),
                jax_f32_grads=_jax_grads(cycle), jax_f32_d_weight=float(cycle["metrics"]["d_weight"]))


def _port_cycle(b, detach_sft: bool = False) -> tuple[dict, dict, dict]:
    """The port's bf16 `cycle_loss` on JAX's bf16 batch: metrics, trainable
    gradients and the query render; detach_sft (the control, phase 8's on
    the card) detaches the SFT modulations before the re-render."""
    tm = _port(bf16_config(tc.tiny_full_config(), tc._with), b["vs"])
    params = ts.split_params(tm, ts.STAGE22_TRAINABLE)
    probe = [p for k, p in params.items() if k.startswith("local.")]
    if detach_sft:
        render_cached = tm.generator.render_cached
        tm.generator.render_cached = lambda s, cached, cond, **kw: render_cached(
            s, cached, tuple(t.detach() for t in cond), **kw)
    loss, metrics, que = ts.cycle_loss(tm, _torch_batch(b["batch"]), TLM(*map(_t, b["ml"])), LAMBDAS,
                                       use_ref_view_weight=True, d_fn=_port_d(b["d_params"]).requires_grad_(False),
                                       adaptive_params=probe, disc_weight_max=DISC_WEIGHT_MAX)
    loss.backward()
    grads = {k: np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad) for k, p in params.items()}
    return {k: float(v.detach()) for k, v in metrics.items()}, grads, que


def _gates(b, port) -> dict:
    """The gates' readings: the worst term's relative error and its name;
    the trained-leaf gradient's gap to JAX's bf16 gradient and JAX's own
    bf16-vs-f32 gap (its limit); the adaptive D weight's relative gap to
    JAX's bf16 weight, held as the whole gradient is (test_torch_cycle.py's
    convention: a ratio of two gradient norms), and, for the record, JAX's
    own bf16-vs-f32 gap of the weight."""
    (m16, g16), (pm, pg, _) = b["jax"], port
    errs = {k: abs(pm[k] - w) / abs(w) for k, w in m16.items() if w != 0 and k != "d_weight"}
    worst = max(errs, key=errs.get)
    w16, w32 = m16["d_weight"], b["jax_f32_d_weight"]
    return {"term": errs[worst], "name": worst, "grad": rel_l2(pg, g16), "grad_lim": rel_l2(g16, b["jax_f32_grads"]),
            "weight": abs(pm["d_weight"] - w16) / w16, "weight_jax": abs(w16 - w32) / w32}


def _inside(r: dict) -> bool:
    return r["term"] < TERM_RTOL and r["grad"] <= r["grad_lim"] and r["weight"] <= r["grad_lim"]


def _text(r: dict) -> str:
    return (f"worst term {r['name']} {r['term']:.3e} [< {TERM_RTOL:g}]; trained-leaf gradient {r['grad']:.3e} and "
            f"adaptive D weight {r['weight']:.3e} [JAX bf16 vs f32 gradient {r['grad_lim']:.3e}; its weight "
            f"{r['weight_jax']:.3e}]")


def test_bf16_cycle_step_tracks_jax(bf16_cycle):
    """Every loss term within TERM_RTOL of JAX's bf16 step's, and the trained
    leaves' gradient (and, relative, the adaptive D weight) no farther from
    JAX's bf16 one than JAX's bf16 gradient is from its f32 one; the query
    render hands the texture twin a bf16 raw_h that carries no gradient."""
    port = _port_cycle(bf16_cycle)
    assert set(port[0]) == set(bf16_cycle["jax"][0]) and set(port[1]) == set(bf16_cycle["jax"][1])
    que = port[2]["que_info"]
    assert que["raw_h"].dtype == torch.bfloat16 and not que["raw_h"].requires_grad
    r = _gates(bf16_cycle, port)
    print(f"bf16 cycle vs JAX's bf16 step: {_text(r)}")
    assert _inside(r), _text(r)


def test_bf16_cycle_sft_detached_control_fails_the_gates(bf16_cycle):
    """A planted fault, phase 8's control on the card: the SFT modulations
    detached before the re-render (the trained leaves lose their gradient
    through the texture head), fails the JAX gates above."""
    r = _gates(bf16_cycle, _port_cycle(bf16_cycle, detach_sft=True))
    print(f"control (SFT detached): {_text(r)}")
    assert not _inside(r)


def test_bf16_cycle_step_tracks_the_ports_f32_step(setup):
    """`make_cycle_step` at the three bf16 dtypes against the same step in f32
    on one stream (the full-res D's term with the adaptive weight): the loss
    within BF16_VS_F32_RTOL, every updated parameter finite and moved; the
    bf16 sample and query renders launch `siren_field_full` in serving (its
    plain version on the CPU: no launch counted) and the re-render is the
    twin's texture head, once, in raw_h's precision."""
    _, _, vs, ml, _, d_params = setup
    out = {}
    for name, c in (("f32", tc.tiny_full_config()), ("bf16", bf16_config(tc.tiny_full_config(), tc._with))):
        tm = _port(c, vs)
        state = ts.create_train_state(tm, ts.STAGE22_TRAINABLE, 1e-4, ema=True)
        before = {k: p.detach().clone() for k, p in state.params.items()}
        step = ts.make_cycle_step(tm, LAMBDAS, state, d_fn=_port_d(d_params).requires_grad_(False),
                                  adaptive_d_loss=True, use_ref_view_weight=True)
        sf.reset_launch_counts()
        vr.reset_twin_counts()
        m = step(TLM(*map(_t, ml)), B, torch.Generator().manual_seed(5))
        assert sf.launch_counts == {"siren_field_full": 0, "siren_field_tex": 0}
        # the conditioned re-render: the twin's texture head on the query's raw_h
        precision = "serving" if name == "bf16" else "highest"
        assert {k: n for k, n in vr.twin_counts.items() if n} == {("texture", precision): 1}
        assert all(bool(torch.isfinite(p).all()) for p in state.params.values())
        assert any(not torch.equal(p, before[k]) for k, p in state.params.items())
        out[name] = float(m["loss"])
    rel = abs(out["bf16"] - out["f32"]) / abs(out["f32"])
    print(f"the port's bf16 cycle step vs its f32 step: loss {out['bf16']:.6f} vs {out['f32']:.6f} ({rel:.3e})")
    assert np.isfinite(out["bf16"]) and rel < BF16_VS_F32_RTOL
