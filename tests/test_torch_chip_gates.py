"""chip_smoke.py's run gate on hand-made runs: `run_gap` takes a logged
metric's gap relative to its largest magnitude over the reference run, so a
score that crosses zero is not read at its last digits, and the final-state
gap as the worst group's relative L2 gap; `spread_limits` sets the limits
from the largest gap among the pairs of one-rank runs."""

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
