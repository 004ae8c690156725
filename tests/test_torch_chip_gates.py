"""chip_smoke.py's run gate on hand-made runs: `run_gap` takes a logged
metric's gap relative to its largest magnitude over the reference run, so a
score that crosses zero is not read at its last digits, and the final-state
gap as the worst group's relative L2 gap; `spread_limits` sets the limits
from the largest gap among the pairs of one-rank runs, and every gate that
holds ranks to one rank (11a, `dp_scaling.py`, `sp_scaling.py`) takes them
from three such runs (`rank_limits`); phase 10b's runs, shared as the
one-rank reference of 11b and 12, keep those limits; a CPU reference in a
child process (`CpuReferences`) gives the in-process numbers; the per-phase
wall table; and phase 14's gap helpers."""

import json
import os

import numpy as np
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


def test_a_cpu_reference_in_a_child_process_equals_the_in_process_run():
    """The card-vs-CPU gates take their CPU reference from a child process
    (`CpuReferences`, `chip_smoke.py --cpu-reference`) that runs beside the
    card's work: at the same ST1_CPU_THREADS threads it gives the numbers of
    the same job run in this process, bit for bit, and a failing job fails
    the phase with the child's output."""
    from e3dge_torch.config import tiny_full_config

    cfg = tiny_full_config()
    refs = cs.CpuReferences("test")
    first = refs.add("f32_image2image_cpu", cfg, None)
    second = refs.add("f32_image2image_cpu", cfg, "raw_density_gain")
    refs.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(cs.ST1_CPU_THREADS)
    try:
        want = [cs.f32_image2image_cpu(cfg, w) for w in (None, "raw_density_gain")]
    finally:
        torch.set_num_threads(threads)
    got = [refs.result(first), refs.result(second)]
    assert got[0].shape == want[0].shape and torch.isfinite(got[0]).all()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(want[0], want[1])  # the second job's weights reached the child

    bad = cs.CpuReferences("test_failing")
    job = bad.add("f32_image2image_cpu", cfg, "no_such_weights")
    bad.start()
    with pytest.raises(AssertionError, match="no_such_weights"):
        bad.result(job)


def test_the_shared_one_rank_reference_keeps_rank_limits(tmp_path, monkeypatch):
    """Phase 10b's uninterrupted runs serve as the one-rank reference of
    phases 11b and 12 (`one_rank_reference`, as `rank_reference` builds it
    without phase 10): the limits are `rank_limits` over all SPREAD_RUNS
    runs (psnr not read), not over one pair, the flags gain the reference's
    depth, and fewer runs raise."""
    monkeypatch.setattr(cs, "_groups", _groups)
    works = _three_runs(tmp_path)
    ref = cs.one_rank_reference(works, ["--stage", "2.2"])
    assert ref["work"] == works[0]
    assert ref["argv"] == ["--stage", "2.2", "--iters", str(cs.RANK_REF_ITERS)]
    assert (ref["lim_loss"], ref["lim_state"]) == cs.rank_limits(works, "runs")
    assert ref["lim_loss"] == pytest.approx(cs.RESUME_FACTOR * 0.0009 / 9.0)
    with pytest.raises(ValueError, match="spread needs"):
        cs.one_rank_reference(works[:2], [])


def test_the_wall_table_splits_out_the_cpu_references_and_the_ranks(monkeypatch):
    """The per-phase wall table printed before the last line: each phase's
    seconds, a phase opened again (5 after 6) adding to its row, and the
    seconds of its CPU references and rank processes and of the waits on
    them in their own columns."""
    clock = iter([0.0, 10.0, 30.0, 31.0])
    monkeypatch.setattr(cs.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(cs, "WALL", {})
    monkeypatch.setattr(cs, "_CURRENT", {"phase": None, "t0": 0.0})
    cs.phase("5")
    cs.wall_add("cpu_reference_s", 25.0)
    cs.phase("6")
    cs.wall_add("ranks_s", 12.5)
    cs.wall_add("ranks_wait_s", 2.0)
    cs.phase("5")
    table = cs.wall_table()
    assert table["wall_s"]["5"]["s"] == pytest.approx(11.0)
    assert table["wall_s"]["5"]["cpu_reference_s"] == 25.0
    assert table["wall_s"]["6"] == {"s": 20.0, "cpu_reference_s": 0.0, "cpu_wait_s": 0.0, "ranks_s": 12.5,
                                    "ranks_wait_s": 2.0}
    assert table["total_s"] == pytest.approx(31.0)


def test_the_long_tail_gates_read_gaps_by_magnitude_and_skip_ambiguous_rays():
    """Phase 14: `mag_gap` is a gap over the reference's largest magnitude
    (run_gap's rule); `secant_gap` compares z only on rays both runs hit
    with no coarse sample within LT_AMBIGUOUS of the level, and counts the
    rays whose hit differs with no such sample (which fail the gate)."""
    assert cs.mag_gap(np.array([1.0, -4.0]), np.array([1.0, -4.001])) == pytest.approx(0.001 / 4.001)
    assert cs.mag_gap(2.0, 2.0) == 0.0
    want = {"z": torch.tensor([1.0, 1.1, 0.9, 1.2]), "hit": torch.tensor([True, True, False, True]),
            "near_level": torch.tensor([0.5, 0.5, 0.5, 1e-6])}
    got = {"z": torch.tensor([1.0005, 1.1, 0.95, 0.3]), "hit": torch.tensor([True, True, False, False]),
           "near_level": want["near_level"].clone()}
    gap, differ, compared = cs.secant_gap(got, want)
    assert (differ, compared) == (0, 2)  # ray 3 differs, but a sample sat at the level
    assert gap == pytest.approx(0.0005 / 1.1, rel=1e-4)
    got["hit"][1] = False
    assert cs.secant_gap(got, want)[1] == 1


def test_run_gap_reads_each_runs_checkpoint_once_while_it_is_unchanged(tmp_path):
    """`cached_groups`: the gates compare one reference run with several
    (each load is ~1 GB), so a run's groups are read once, and again when
    its checkpoint changes (a resumed run rewrites it in place)."""
    reads = []

    def groups(work):
        reads.append(os.path.basename(work))
        return {"E": [torch.tensor([float(len(reads))], dtype=torch.float64)]}

    ref = _run(tmp_path, "ref", [{"loss": 1.0}])
    others = [_run(tmp_path, n, [{"loss": 1.0}]) for n in ("a", "b", "c")]
    os.makedirs(os.path.join(ref, "models_final"))
    ck = os.path.join(ref, "models_final", "variables.pt")
    open(ck, "w").close()
    for work in others:
        cs.run_gap(work, ref, 1, groups)
    assert reads.count("ref") == 1 and len(reads) == 4
    os.utime(ck, ns=(1, 1))  # the checkpoint rewritten
    cs.run_gap(others[0], ref, 1, groups)
    assert reads.count("ref") == 2
