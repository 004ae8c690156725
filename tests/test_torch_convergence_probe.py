"""The port's stage-2 convergence probe (`python -m
e3dge_torch.tools.convergence_probe`) against `scripts/convergence_probe.py`,
loaded in-process from its file, at `tiny_full_config` on the CPU.

The JAX script's `build(variant)` gives the variables (its `model.init` is
served by the session's jitted init of the same call, conftest's
`tiny_full_setup`: the same config, keys and inputs, ~95 s cheaper than the
eager one) and its jitted step; the port's `build` takes them through
`load_jax_variables`. Its programs are compiled once per file, with the XLA
options of test_torch_cycle.py.

- (i) `held_out_metrics` of each variant equals JAX's `make_eval` on the same
  variables and JAX's held-out batch (`fold_in(key(999), 7)`) within 1e-4
  relative, the cycle test's METRIC_RTOL.
- (ii) The base variant's curve over 3 iterations, the port fed JAX's batches
  (each redrawn from the step's key as test_torch_cycle.py:130-134 does),
  against JAX's compiled step. Through iteration 1 each metric is within
  METRIC_RTOL. After that, each metric of each eval is within CURVE_FACTOR x
  the port's own move when every batch's images are scaled by 1 + 1e-7
  N(0, 1) (the measure of `test_cycle_gradient_gap_is_rounding`). The factor
  is chip_smoke.py's RESUME_FACTOR, its run-against-run gates' factor over a
  spread. Why a spread and not METRIC_RTOL: Adam's first step moves each
  parameter by lr times the sign of its gradient, so a gradient element at
  rounding level moves its parameter by +-lr whichever way it rounds. After
  one step, 438 elements of the aligner's conv weights sit 2 lr from JAX's,
  and 14 from the port's own step on the batch's pairs reordered. The
  perturbation spread read 4.2e-5 and the gap 2.2e-4, at iteration 3, on
  l2_local_full. Control: Adam's lr 10% off falls outside the limit.
- (iii) At iteration 0, on the port's own seeded build, l2_local_full equals
  l2_global_full for all three variants within IDENTITY_RTOL (the modulations
  are an exact no-op), and not with the texture head's last layer seeded.
- (iv) The CLI writes JAX's JSON keys and verdict lines, and refuses an --out
  inside docs/, where the JAX record lives.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_training import METRIC_RTOL, _torch_batch, one_torch_thread  # noqa: F401 (autouse)

from e3dge_torch import config as tc
from e3dge_torch.models.e3dge import LatentMeans as TLM
from e3dge_torch.tools import convergence_probe as cp
from e3dge_torch.training.train_utils import make_noise
from e3dge_torch.utils.weights import load_jax_variables
from e3dge_tpu.models.e3dge import E3DGE as JE3DGE

REPO = Path(__file__).resolve().parents[1]
B, ITERS = 4, 3
CURVE_FACTOR = 10.0
CONTROL_LR_SCALE = 1.1
IDENTITY_RTOL = 1e-6
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_convergence_probe", REPO / "scripts" / "convergence_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_side(tiny_full_setup):
    """The JAX script's build of each variant, its compiled base step, its
    compiled `make_eval` per variant, its held-out batch and the base curve
    over ITERS iterations (eval at every one) with the batches its step drew."""
    variables = tiny_full_setup[2]
    jp = _jax_script()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE3DGE, "init", lambda self, *args, **kw: variables)
        built = {v: jp.build(v) for v in cp.VARIANTS}
    _, jmodel, jvars, jml, state, step = built["base"]
    sample = jax.jit(lambda vs, k_data, k_noise: jmodel.apply(vs, k_data, B, 1.0, True,
                                                                method=JE3DGE.synthetic_sample,
                                                                rngs={"noise": k_noise}))
    k_eval = jax.random.fold_in(jax.random.key(999), 7)
    sample = sample.lower(jvars, k_eval, k_eval).compile(FAST_COMPILE)
    params_all = {**state.frozen, **state.params}
    evals = {}
    for v, (_, model, _, ml, _, _) in built.items():
        fn = jp.make_eval(model, ml, v)
        evals[v] = fn.lower(params_all, state.extra).compile(FAST_COMPILE)
    metrics = {v: {k: float(x) for k, x in fn(params_all, state.extra).items()} for v, fn in evals.items()}

    step = step.lower(state, jml, jax.random.key(3), B).compile(FAST_COMPILE)
    curve, batches, key = [{**metrics["base"], "iter": 0}], [], jax.random.key(3)
    for i in range(1, ITERS + 1):
        key, k = jax.random.split(key)
        batches.append(sample(jvars, *jax.random.split(k)))
        state, _ = step(state, jml, k)
        m = evals["base"]({**state.frozen, **state.params}, state.extra)
        curve.append({**{n: float(x) for n, x in m.items()}, "iter": i})
    return dict(variables=jvars, metrics=metrics, curve=curve, batches=batches,
                held_out=sample(jvars, k_eval, k_eval))


def _port(variant, variables):
    model, _, state = cp.build(variant, tc.tiny_full_config(), "cpu")
    load_jax_variables(model, variables)
    c = model.cfg
    ml = TLM(torch.zeros(1, c.renderer.depth + 1, c.renderer.style_dim),
             torch.zeros(1, c.decoder.n_latent, c.decoder.style_dim))
    return model, ml, state


def _torch_pairs(jbatch) -> dict:
    """JAX's batch for the port, with decoder noise maps (JAX's init zeroes
    every NoiseInjection weight, so any maps give JAX's images)."""
    d = tc.tiny_full_config().decoder
    return {**_torch_batch(jbatch), "noise": make_noise(d.size, d.in_res, B)}


def _rel(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in cp.METRICS)


@pytest.mark.parametrize("variant", cp.VARIANTS)
def test_held_out_metrics_match_jax(jax_side, variant):
    model, ml, _ = _port(variant, jax_side["variables"])
    got = cp.held_out_metrics(model, ml, variant, _torch_pairs(jax_side["held_out"]))
    want = jax_side["metrics"][variant]
    print(f"{variant}: port {got}, JAX {want}")
    for k in cp.METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)


def _port_curve(jax_side, perturb: bool = False, lr_scale: float = 1.0) -> list[dict]:
    """The port's base curve on JAX's batches: `perturb` scales every batch's
    images by 1 + 1e-7 N(0, 1), `lr_scale` Adam's learning rate."""
    model, ml, state = _port("base", jax_side["variables"])
    for group in state.optimizer.param_groups:
        group["lr"] *= lr_scale
    batches = [_torch_pairs(b) for b in jax_side["batches"]]
    if perturb:
        gen = torch.Generator().manual_seed(1)
        for b in batches:
            b["images"] = b["images"] * (1 + 1e-7 * torch.randn(b["images"].shape, generator=gen))
    run = cp.run_variant("base", model, ml, state, ITERS, 1, B, draw_batch=lambda i: batches[i - 1],
                         eval_batch=_torch_pairs(jax_side["held_out"]))
    return run["curve"]


def test_base_curve_tracks_jax_within_its_rounding_spread(jax_side):
    got, want = _port_curve(jax_side), jax_side["curve"]
    assert [r["iter"] for r in got] == [r["iter"] for r in want] == list(range(ITERS + 1))
    spread = max(_rel(a, b) for a, b in zip(_port_curve(jax_side, perturb=True), got))
    limit = max(CURVE_FACTOR * spread, METRIC_RTOL)
    gaps = [_rel(g, w) for g, w in zip(got, want)]
    control = max(_rel(g, w) for g, w in zip(_port_curve(jax_side, lr_scale=CONTROL_LR_SCALE), want))
    print(f"base curve vs JAX: worst relative gap per eval {['%.3e' % g for g in gaps]}; the port's own spread "
          f"under a 1e-7 image perturbation {spread:.3e}; limit {limit:.3e}; control (lr x {CONTROL_LR_SCALE}) "
          f"{control:.3e}")
    assert gaps[0] < METRIC_RTOL and gaps[1] < METRIC_RTOL  # before Adam's second step: the metric's tolerance
    assert max(gaps) < limit, f"gap {max(gaps):.3e} against the limit {limit:.3e}"
    assert control > limit, f"the control ({control:.3e}) passes the limit {limit:.3e}"
    assert want[-1]["l2_local_full"] < want[0]["l2_local_full"]  # the curve moves: JAX's E1 learns in 3 steps
    assert got[-1]["l2_local_full"] < got[0]["l2_local_full"]


def test_iteration_zero_is_the_global_render_for_every_variant():
    cfg = tc.tiny_full_config()
    for variant in cp.VARIANTS:
        model, ml, _ = cp.build(variant, cfg, "cpu", seed=0)
        batch = cp.held_out_batch(model, seed=0)
        m = cp.held_out_metrics(model, ml, variant, batch)
        np.testing.assert_allclose(m["l2_local_full"], m["l2_global_full"], rtol=IDENTITY_RTOL, err_msg=variant)
        np.testing.assert_allclose(m["l2_local"], m["l2_global"], rtol=IDENTITY_RTOL, err_msg=variant)
        head = model.local.local_feat_to_tex_modulations_linear.fc_1
        with torch.no_grad():
            head.weight.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(2))
            head.bias.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(3))
        seeded = cp.held_out_metrics(model, ml, variant, batch)
        assert abs(seeded["l2_local_full"] - seeded["l2_global_full"]) > 1e3 * IDENTITY_RTOL * m["l2_global_full"]


def test_cli_writes_the_jax_record_layout_and_verdicts(tmp_path, capsys):
    out = tmp_path / "probe.json"
    assert cp.main(["--tiny", "--device", "cpu", "--iters", "2", "--eval-every", "1", "--batch", "2",
                    "--variants", "refweight,texture", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    record = json.loads(out.read_text())
    jax_record = json.loads((REPO / "docs" / "train_runs" / "r5_convergence_probe.json").read_text())
    assert set(jax_record) <= set(record) and record["iters"] == 2
    for v in ("refweight", "texture"):
        rows = record["curves"][v]
        assert [r["iter"] for r in rows] == [0, 1, 2]
        assert all(set(jax_record["curves"]["base"][0]) <= set(r) for r in rows)
        assert f"[{v}] full " in text and "(improved=" in text and "(beats_baseline=" in text
    assert [g["iter"] for g in record["gap"]] == [0, 1, 2] and record["gap"][0]["l2_local_full"] == 0.0
    assert record["launches"]["texture"] == {"per_iter": 0.0, "per_eval": 0.0}  # the CPU launches no kernel
    assert cp.DOCS not in Path(cp.parse_args([]).out).resolve().parents
    with pytest.raises(SystemExit, match="docs/"):
        cp.main(["--tiny", "--device", "cpu", "--out", str(REPO / "docs" / "train_runs" / "r5_convergence_probe.json")])

