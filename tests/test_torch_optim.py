"""The port's optimizers against the JAX package's optax chains on fixed
gradient sequences (no model), and the pose curriculum at its edges.

Adam against `optax.adam` for 3 steps; Ranger against
`e3dge_tpu.training.steps.make_optimizer(lr, "ranger")` for 13 steps, which
cross RAdam's N_sma threshold (step 6) and two lookahead syncs (steps 6 and
12). Parameters agree within 1e-7 of their scale after every step: the updates
are f32 arithmetic on the same values, in another order in places."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e3dge_torch.training import steps as ts
from e3dge_tpu.training import steps as js

SHAPES = {"conv": (4, 3, 3, 3), "linear": (6, 5), "bias": (6,)}


def _run(name: str, n_steps: int, lr: float):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * rng.uniform(0.1, 3)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(n_steps)]
    tx = optax.adam(lr, b1=0.9, b2=0.999) if name == "adam" else js.make_optimizer(lr, "ranger")
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ts.make_optimizer(tparams.values(), lr, name)
    for i, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in SHAPES:
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(tparams[k].detach().numpy(), want, rtol=0,
                                       atol=1e-7 * float(np.abs(want).max()), err_msg=f"step {i + 1} {k}")
    return params, tparams


def test_adam_matches_optax():
    start, end = _run("adam", 3, 1e-3)
    assert all(float((end[k].detach() - torch.from_numpy(start[k])).abs().max()) > 1e-4 for k in SHAPES)


def test_ranger_matches_the_jax_chain_across_threshold_and_syncs():
    _run("ranger", 13, 1e-2)


def test_ranger_scalars_cross_the_threshold_at_step_six():
    """The f32 N_sma passes 5 between steps 5 and 6 (4.9607 then 5.9747 in
    f32): momentum SGD before, rectified after."""
    assert [ts.Ranger._scalars(t, 0.95, 0.999, 5.0)[1] for t in range(1, 9)] == [False] * 5 + [True] * 3


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        ts.make_optimizer([torch.nn.Parameter(torch.zeros(1))], 1e-3, "sgd")


@pytest.mark.parametrize("fixed_tail", [False, True])
def test_pose_curriculum_matches_jax_at_the_edges(fixed_tail):
    """The reference's off-by-one kept: past the last edge the schedule stays
    at lambdas[-2] unless fixed_tail (steps.py:44-70)."""
    want = js.pose_curriculum(fixed_tail=fixed_tail)
    got = ts.pose_curriculum(fixed_tail=fixed_tail)
    for step in (0, 1, 9999, 10000, 10001, 13999, 14000, 17999, 18000, 21999, 22000, 25999, 26000, 26001, 10**6):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6, err_msg=str(step))
    assert got(10**6) == (1.0 if fixed_tail else 0.75)
    assert jax.devices()[0].platform == "cpu"
