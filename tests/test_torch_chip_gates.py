"""chip_smoke.py's run gate on hand-made runs: `run_gap` takes a logged
metric's gap relative to its largest magnitude over the reference run, so a
score that crosses zero is not read at its last digits, and the final-state
gap as the worst group's relative L2 gap; `spread_limits` sets the limits
from the largest gap among the pairs of one-rank runs, and every gate that
holds ranks to one rank (11a, `dp_scaling.py`, `sp_scaling.py`) takes them
from three such runs (`rank_limits`)."""

import json
import os

import pytest
import torch

import chip_smoke as cs


def _run(root, name, records):
    work = os.path.join(root, name)
    os.makedirs(work)
    with open(os.path.join(work, "metrics.jsonl"), "w") as f:
        for step, rec in enumerate(records, 1):
            f.write(json.dumps({"step": step, "time": 0.0, **rec}) + "\n")
    return work


def _groups(work):
    return {"E": [torch.tensor([3.0, 4.0], dtype=torch.float64) * (1.01 if work.endswith("got") else 1.0)]}


@pytest.mark.parametrize("score", [2.75e-4, -5e-5])
def test_run_gap_reads_a_zero_crossing_metric_against_its_magnitude(tmp_path, score):
    # a D score 5.5e-3 at step 2 crosses zero; a 1e-6 change at step 3 is a
    # 1e-6 / 5.5e-3 gap, not 1e-6 / |score|
    want = _run(tmp_path, "want", [{"loss": 3.0, "vd": -2.7e-3}, {"loss": 6.8, "vd": 5.5e-3},
                                   {"loss": 9.2, "vd": score}])
    got = _run(tmp_path, "got", [{"loss": 3.0, "vd": -2.7e-3}, {"loss": 6.8, "vd": 5.5e-3},
                                 {"loss": 9.2 * (1 + 1e-5), "vd": score + 1e-6}])
    metrics, state, where = cs.run_gap(got, want, 1, _groups)
    assert metrics == pytest.approx(1e-6 / 5.5e-3, rel=1e-6)
    assert "vd@3" in where and "E" in where
    assert state == pytest.approx(0.01, rel=1e-9)


def test_run_gap_still_reads_a_wrong_metric(tmp_path):
    # a metric off by 2x (a reduction that sums where it should average) is
    # an O(1) gap from any first step; a skipped metric is not read
    want = _run(tmp_path, "want", [{"loss": 3.0, "psnr": 7.1}, {"loss": 6.8, "psnr": 2.7}])
    doubled = _run(tmp_path, "doubled", [{"loss": 6.0, "psnr": 7.1}, {"loss": 13.6, "psnr": 2.7}])
    psnr = _run(tmp_path, "psnr", [{"loss": 3.0, "psnr": 1.0}, {"loss": 6.8, "psnr": 2.7}])
    for first_step in (1, 2):
        assert cs.run_gap(doubled, want, first_step, _groups)[0] == pytest.approx(1.0)
    assert cs.run_gap(psnr, want, 1, _groups, skip=("psnr",))[0] == 0.0
    assert cs.run_gap(psnr, want, 1, _groups)[0] == pytest.approx(6.1 / 7.1)


def test_spread_limits_take_the_largest_pair(tmp_path):
    # three one-rank runs whose first pair (a, b) is far closer than the
    # others: the limits are RESUME_FACTOR x the largest pair's gaps
    works = [_run(tmp_path, n, [{"loss": 9.0}, {"loss": v}]) for n, v in (("a", 6.0), ("b", 6.00001), ("c", 6.0009))]
    lim_loss, lim_state = cs.spread_limits(works, "runs", groups=_groups)
    assert lim_loss == pytest.approx(cs.RESUME_FACTOR * 0.0009 / 9.0)
    assert lim_state == cs.RESUME_FLOOR


def _three_runs(root):
    # the first pair is far closer than the others, as a single draw can be
    return [_run(root, n, [{"loss": 9.0, "psnr": 20.0}, {"loss": v, "psnr": p}])
            for n, v, p in (("a", 6.0, 20.0), ("b", 6.00001, 20.0), ("c", 6.0009, 25.0))]


@pytest.mark.parametrize("gate", ["11a", "dp_scaling", "sp_scaling"])
def test_rank_gates_take_their_limits_from_three_runs(tmp_path, monkeypatch, gate):
    """Phase 11a, dp_scaling.py and sp_scaling.py set their limits from the
    pairs of SPREAD_RUNS one-rank runs (the largest gap, psnr not read, as
    11b and 12 do), not from one pair; fewer runs raise."""
    import dp_scaling
    import sp_scaling

    limits = {"11a": cs.st1_rank_limits, "dp_scaling": dp_scaling.equality_limits,
              "sp_scaling": sp_scaling.equality_limits}[gate]
    for name in ("_st1_groups", "_groups"):  # the runs' final state: no checkpoints here
        monkeypatch.setattr(cs, name, _groups)
    works = _three_runs(tmp_path)
    assert cs.SPREAD_RUNS == len(works)
    lim_loss, lim_state = limits(works)
    assert lim_loss == pytest.approx(cs.RESUME_FACTOR * 0.0009 / 9.0)
    assert lim_state == cs.RESUME_FLOOR
    with pytest.raises(ValueError, match="spread needs"):
        limits(works[:2])


def test_leaf_limits_add_the_field_kernels_own_gap():
    """13c's reduced step: a leaf whose card-vs-CPU gap is past ST1_TOL_LEAF
    only by what the plain field in place of the kernel moves it on the card
    passes; a leaf off by O(1) (the SFT-detached control) still fails; and
    without a measured field gap (phase 8) every limit stays ST1_TOL_LEAF."""
    one = {"depth_bn": torch.tensor([1.0, 0.0]), "head": torch.tensor([0.0, 2.0])}
    cpu = {k: v.clone() for k, v in one.items()}
    card = {"depth_bn": torch.tensor([1.035, 0.0]), "head": torch.tensor([0.0, 2.01])}
    plain = {"depth_bn": torch.tensor([1.005, 0.0]), "head": torch.tensor([0.0, 2.01])}
    detached = {"depth_bn": torch.tensor([1.035, 0.0]), "head": torch.tensor([0.0, 0.0])}

    gaps = cs.leaf_gaps(card, cpu)
    assert gaps["depth_bn"] == pytest.approx(0.035, rel=1e-5) and gaps["depth_bn"] > cs.ST1_TOL_LEAF
    fixed = cs.leaf_limits(None, cpu)
    assert fixed == {k: cs.ST1_TOL_LEAF for k in cpu}
    assert cs.worst_leaf(gaps, fixed)[0] == "depth_bn"

    limits = cs.leaf_limits(cs.leaf_gaps(card, plain), cpu)
    assert limits["depth_bn"] == pytest.approx(cs.ST1_TOL_LEAF + cs.LEAF_FIELD_FACTOR * 0.03 / 1.005, rel=1e-5)
    assert limits["head"] == pytest.approx(cs.ST1_TOL_LEAF)
    name, gap, lim = cs.worst_leaf(gaps, limits)
    assert gap < lim
    name, gap, lim = cs.worst_leaf(cs.leaf_gaps(detached, cpu), limits)
    assert (name, gap) == ("head", pytest.approx(1.0)) and gap >= lim
