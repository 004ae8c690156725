"""The stage-1 cell `st1_b4` on the CPU at `tiny_test_config` (the trainer's
stage-1 `--tiny`): the port's stage-1 step against the frozen reference
(`reference/training/stage1.py`) within the cell's limits; each planted
fault fails at least one compared number; the manifest's checks hold with
`ffhq_stage1` and `st1_b4`; the readers of `train.sample_ms` and
`train.shape_ms` against values computed by hand, and a traced run reports
every metric of the cell; the driver's comparison is `drivers/train.py`'s E
side; and what the new files import."""

import json
import sys

import pytest
import torch

from port_bench import faults, faults_stage1, manifest, run
from port_bench.drivers import train as train_driver
from port_bench.drivers import train_st1
from port_bench.tests import test_bench_manifest as checks
from port_bench.tests.test_bench_isolation import top_level
from port_bench.tests.test_bench_program_spans import op, span, synthetic
from port_bench.tests.tiny import tiny_cell

SEED = 3 * 2**31 + 7


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def tiny_st1() -> dict:
    from e3dge_torch import config as C

    cell = tiny_cell("st1_b4")
    cell["config"]["e3dge"] = json.loads(json.dumps(C.tiny_test_config().to_dict()))
    return cell


def test_the_port_is_within_the_cells_limits():
    cell = tiny_st1()
    result = run.run_cell(cell, SEED, 0.5, False, "cpu")
    assert result["attempted"] >= 1 and list(result)[-1] == "compared"
    assert set(result["compared"]) == set(cell["workload"]["limits"])
    assert {"e_loss_gap", "e_term_gap"} <= set(result["notes"]["readings"])
    assert result["correct"] is True, result["compared"]


@pytest.mark.parametrize("fault", sorted(faults_stage1.STAGE1))
def test_each_planted_fault_fails_a_number(fault, monkeypatch):
    cell = tiny_st1()
    faults_stage1.STAGE1[fault](monkeypatch.setattr)
    assert faults.PLANTED[-1] == faults_stage1.STAGE1[fault].__name__
    result = run.run_cell(cell, SEED, 0.5, False, "cpu")
    over = [n for n, c in result["compared"].items() if c["value"] > c["limit"]]
    assert result["correct"] is False and over, result["compared"]
    if fault == "eikonal_cut":
        # the losses are the same; the gradients of E0 are not
        assert "e_grad_gap" in over
    if fault == "lr_doubled":
        # the first gradients are the same; only the change after three steps shows it
        assert over == ["e_change_gap"]


def test_the_faults_are_registered_with_the_harness():
    for name in ("eikonal_cut", "half_batch_stage1", "lr_doubled"):
        assert name in faults.BY_NAME
    assert faults_stage1.STAGE1["state_unchanged"] is faults.state_unchanged


def test_manifest_checks_hold_with_the_stage1_configuration_and_cell():
    man = manifest.manifest()
    assert "ffhq_stage1" in [c["name"] for c in man["configs"]]
    assert "st1_b4" in [w["name"] for w in man["workloads"]]
    checks.check_keys_and_names(man)
    checks.check_per_layer(man, manifest.ROOT)
    checks.check_cell("st1_b4", manifest.ROOT)
    checks.check_config(next(c for c in man["configs"] if c["name"] == "ffhq_stage1"), manifest.ROOT)
    cell = manifest.cell("st1_b4")
    assert {m["name"] for m in cell["end_to_end"]} == {"setup_s", "train_imgs_per_s"}
    assert {m["name"] for m in cell["per_layer"]} == {
        "train.device_idle_share", "train.peak_gib", "train.e_step_ms", "train.field_roofline", "train.mfu",
        "train.e_backward_ms", "train.e_optimizer_ms", "train.host_wait_ms", "train.sample_ms", "train.shape_ms"}
    # the loss and its terms are reported, not judged: TF32 convolutions move them as much as bf16 does
    assert set(cell["workload"]["limits"]) == {"e_grad_gap", "e_change_gap"}
    assert all(isinstance(v, float) for v in cell["workload"]["limits"].values())


# one stage-1 step: the sample (with its G0 render and G1 decoder), the
# inversion's render, the shape terms, the backward and the optimizer
ST1_SPANS = [
    span("e.step", 100, 5000), span("e.sample", 200, 1500), span("g0.render", 300, 700),
    span("g1.decoder", 800, 1200), span("g0.render", 1600, 2000), span("g0.shape", 2200, 2800),
    span("e.backward", 3000, 4500), span("e.optimizer", 4600, 4900),
]
ST1_OPS = [
    op(250, 280, 250), op(400, 600, 400), op(610, 650, None), op(900, 1300, 900), op(1400, 1450, 1400),
    op(1700, 1900, 1700), op(2300, 2400, 2300), op(2500, 2550, None), op(3100, 3900, 3100), op(4700, 4750, 4700),
]
ST1_CASES = {
    # the sample's own 30 + 50, G0's 200 and the unlinked 40 after it, G1's 400
    "train.sample_ms": (30 + 200 + 40 + 400 + 50) / 1000,
    # the shape terms' 100 and the unlinked 50 after them
    "train.shape_ms": (100 + 50) / 1000,
}


@pytest.mark.parametrize("metric", sorted(ST1_CASES))
def test_reader_reads_the_hand_computed_value(metric):
    ctx = type("Ctx", (), {"trace": synthetic(ST1_SPANS, ST1_OPS, 1)})
    assert run.reader(metric)(ctx) == pytest.approx(ST1_CASES[metric], rel=1e-12)


@pytest.mark.parametrize("missing", ["no spans recorded", "no span module"])
@pytest.mark.parametrize("metric", sorted(ST1_CASES))
def test_reader_gives_none_without_the_ports_spans(metric, missing, monkeypatch):
    # a stage-1 step of a program without "e.sample" and "g0.shape": the spans the cycle step opens alone
    spans = [s for s in ST1_SPANS if s[2] not in ("e.sample", "g0.shape")]
    if missing == "no span module":
        spans = ST1_SPANS
        monkeypatch.setitem(sys.modules, "e3dge_torch.utils.trace", None)
    assert run.reader(metric)(type("Ctx", (), {"trace": synthetic(spans, ST1_OPS, 1)})) is None


def test_a_traced_run_reports_every_metric_of_the_cell():
    cell = tiny_st1()
    result = run.run_cell(cell, SEED, 0.5, True, "cpu")
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # on the CPU no device operation runs: no field kernel, no peak, no device time in the driver's span
    assert set(got) == {m["name"] for m in cell["per_layer"]} - {"train.field_roofline", "train.peak_gib",
                                                                 "train.e_step_ms"}
    for name in ("train.e_backward_ms", "train.e_optimizer_ms", "train.sample_ms",
                 "train.shape_ms"):
        assert got[name] == 0.0
    assert got["train.host_wait_ms"] > 0 and got["train.mfu"] > 0


def test_the_comparison_is_the_e_side_of_the_train_drivers():
    got = {"e_loss": [1.0, 0.9, 0.8], "d_loss": [1.0] * 3, "e_terms": [{"a": 1.0, "b": 2.0}] * 3,
           "grad": {"e.x": 1.0, "e.y": 2.0, "e.z": 1e-6, "d.w": 1.0},
           "change": {"e.x": 0.1, "e.y": 0.3, "e.z": 0.0, "d.w": 0.2}}
    want = {"e_loss": [1.01, 0.9, 0.79], "d_loss": [1.0] * 3, "e_terms": [{"a": 1.1, "b": 2.0}] * 3,
            "grad": {"e.x": 1.1, "e.y": 2.0, "e.z": 1e-6, "d.w": 1.0},
            "change": {"e.x": 0.12, "e.y": 0.3, "e.z": 0.5, "d.w": 0.2}}

    def e_side(r):
        return {"e_loss": r["e_loss"], "e_terms": r["e_terms"],
                **{k: {n: v for n, v in r[k].items() if not n.startswith("d.")} for k in ("grad", "change")}}

    both = train_driver.compare(got, want)
    assert train_st1.compare(e_side(got), e_side(want)) == {k: v for k, v in both.items() if not k.startswith("d_")}


def test_the_reference_step_runs_with_tf32_off_and_restores_the_flags(monkeypatch):
    from types import SimpleNamespace

    from port_bench.reference.training import stage1

    class Stop(Exception):
        pass

    seen = []

    def loss(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        raise Stop

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(stage1, "decoder_noise", lambda *args: None)
    monkeypatch.setattr(stage1, "stage1_loss", loss)
    step = stage1.make_stage1_step(SimpleNamespace(synthetic_sample=lambda *a, **k: {}), {}, SimpleNamespace(step=0))
    with pytest.raises(Stop):
        step(None, 1)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_the_new_files_import_no_jax_and_the_reference_nothing_of_the_port():
    ref = top_level(["port_bench.reference.training.stage1"])
    assert "e3dge_torch" not in ref and not ref & {"jax", "jaxlib", "flax", "e3dge_tpu"}
    harness = top_level(["port_bench.drivers.train_st1", "port_bench.faults_stage1"], "metrics/train.s*.py")
    assert not harness & {"jax", "jaxlib", "flax", "e3dge_tpu", "chip_smoke", "bench", "__graft_entry__"}
