"""The readers of the port's own spans (`program_spans` and the metrics on
it) against values computed by hand on a synthetic trace; and, on the CPU,
a traced run of each driver at `tiny_full_config` reports them all."""

import sys

import pytest
import torch

from port_bench import run
from port_bench.tests.tiny import tiny_cell
from port_bench.tracing import Trace

US = 1000  # ns


def span(name, start, end):
    """A host operator of the trace: the port's spans are among them."""
    return (start * US, end * US, name)


def op(start, end, host):
    return ("kernel", start * US, end * US, None if host is None else host * US)


# two inversions (units 2); the first nests E1's filter in its fusion
SERVE_SPANS = [
    span("inversion", 100, 4100), span("e0.encoder", 200, 600), span("aten::conv2d", 250, 350),
    span("g0.render", 700, 1200), span("e1.fusion", 1300, 3000), span("e1.filter", 1500, 2500),
    span("g0.render", 3100, 3500), span("g1.decoder", 3600, 4000),
    span("inversion", 5000, 6000), span("g0.render", 5100, 5500), span("e1.fusion", 5600, 5900),
]
SERVE_OPS = [
    op(310, 400, 300), op(810, 1100, 800), op(1120, 1190, None),  # E0; G0 and a kernel linked to no call
    op(1400, 1450, 1400), op(1610, 2600, 1600), op(2700, 2720, 2700),  # fusion; its filter; fusion
    op(3200, 3300, 3200), op(3700, 4050, 3700),  # G0; G1 (running on after its span closed)
    op(4500, 4600, 4500), op(5200, 5400, 5200), op(5700, 5750, 5700),  # outside every span; G0; fusion
]
# one iteration: the D producer (with a G0 render), the reals, the D step,
# the cycle step with a render, its backward (autograd's launches) and optimizer
TRAIN_SPANS = [
    span("d.producer", 100, 1000), span("g0.render", 200, 500), span("data.reals", 1100, 1300),
    span("d.step", 1400, 2000), span("e.step", 2100, 5000), span("g0.render", 2200, 2600),
    span("e.backward", 3000, 4500), span("e.optimizer", 4600, 4900),
]
TRAIN_OPS = [
    op(300, 600, 300), op(700, 900, 700), op(1500, 1900, 1500), op(2300, 2500, 2300),
    op(3100, 3900, 3100), op(3900, 4400, 4000), op(4700, 4750, 4700), op(4750, 4790, 4800), op(4950, 4990, None),
]
CASES = {
    # E0's 90 (inside aten::conv2d, which is no span of the port's) / 2
    "serve.encoder_ms": (SERVE_SPANS, SERVE_OPS, 2, 90 / 2 / 1000),
    # the filter's 990 inside E1's fusion / 2
    "serve.e1_filter_ms": (SERVE_SPANS, SERVE_OPS, 2, 990 / 2 / 1000),
    # G1's 350, running on after its span closed / 2
    "serve.decoder_ms": (SERVE_SPANS, SERVE_OPS, 2, 350 / 2 / 1000),
    # (E1's own 50 + 20, request 2's 50) / 2; the filter's 990 is not the fusion's
    "serve.fusion_ms": (SERVE_SPANS, SERVE_OPS, 2, (50 + 20 + 50) / 2 / 1000),
    # the kernel linked to no call runs after G0's, so it is G0's
    "serve.g0_ms": (SERVE_SPANS, SERVE_OPS, 2, (290 + 70 + 100 + 200) / 2 / 1000),
    # request 1: 4000 open, busy 90 + 290 + 70 + 50 + 990 + 20 + 100 + 350 (to 4050);
    # request 2: 1000 open, busy 200 + 50
    "serve.host_wait_ms": (SERVE_SPANS, SERVE_OPS, 2, ((4000 - 1960) + (1000 - 250)) / 2 / 1000),
    "train.e_backward_ms": (TRAIN_SPANS, TRAIN_OPS, 1, (800 + 500) / 1000),
    # the optimizer's 50 + 40, and the kernel linked to no call after them
    "train.e_optimizer_ms": (TRAIN_SPANS, TRAIN_OPS, 1, (50 + 40 + 40) / 1000),
    "train.reals_wait_ms": (TRAIN_SPANS, TRAIN_OPS, 1, 200 / 1000),
    # 900 + 200 + 600 + 2900 open, busy 300 + 200 + 400 + 200 + 1300 + 90 + 40
    "train.host_wait_ms": (TRAIN_SPANS, TRAIN_OPS, 1, (4600 - 2530) / 1000),
}


def synthetic(spans, ops, units):
    return Trace(ops, {}, sorted(spans), (0, 10_000 * US), units)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader_reads_the_hand_computed_value(metric):
    spans, ops, units, want = CASES[metric]
    ctx = type("Ctx", (), {"trace": synthetic(spans, ops, units)})
    assert run.reader(metric)(ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("missing", ["no spans recorded", "no span module"])
@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader_gives_none_without_the_ports_spans(metric, missing, monkeypatch):
    _, ops, units, _ = CASES[metric]
    trace = synthetic([span("aten::conv2d", 250, 350)], ops, units)
    if missing == "no span module":
        trace = synthetic(CASES[metric][0], ops, units)
        monkeypatch.setitem(sys.modules, "e3dge_torch.utils.trace", None)
    assert run.reader(metric)(type("Ctx", (), {"trace": trace})) is None


@pytest.mark.parametrize("cell", ["i2i_b1", "st2_b4"])
def test_a_traced_run_reports_every_span_metric(cell):
    """The spans reach the readers through the harness's own profile: on the
    CPU no device operation runs, so the device ms read 0 and the waits are
    the spans' whole host time."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        result = run.run_cell(tiny_cell(cell), 3 * 2**31 + 7, 0.5, True, "cpu")
    finally:
        torch.set_num_threads(n)
    got = {k: v["value"] for k, v in result["metrics"].items() if k in CASES}
    assert set(got) == {m for m in CASES if m.startswith("serve." if cell.startswith("i2i") else "train.")}
    for name, value in got.items():
        device_ms = ("encoder_ms", "e1_filter_ms", "g0_ms", "fusion_ms", "decoder_ms", "backward_ms", "optimizer_ms")
        assert value == 0.0 if name.endswith(device_ms) else value > 0
