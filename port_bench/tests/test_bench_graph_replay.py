"""The reader of `serve.graph_replay_share` against hand-counted synthetic
traces, and on the CPU a traced run of the serve driver at
`tiny_full_config`, where every call is eager."""

import pytest
import torch

from port_bench import run
from port_bench.tests.test_bench_program_spans import SERVE_OPS, SERVE_SPANS, span, synthetic
from port_bench.tests.tiny import tiny_cell

METRIC = "serve.graph_replay_share"
# one "graph.replay" inside each of the two calls ("inversion") of SERVE_SPANS
REPLAYS = [span("graph.replay", 110, 4090), span("graph.replay", 5010, 5990)]


def _read(trace):
    return run.reader(METRIC)(type("Ctx", (), {"trace": trace}))


@pytest.mark.parametrize("replays, want", [(0, 0.0), (1, 50.0), (2, 100.0)])
def test_the_share_counts_the_calls_that_replayed(replays, want):
    """One replay per call reads 100%, none 0% (every call eager)."""
    assert _read(synthetic(SERVE_SPANS + REPLAYS[:replays], SERVE_OPS, 2)) == pytest.approx(want, rel=1e-12)


def test_the_share_is_none_without_calls():
    assert _read(synthetic([span("aten::conv2d", 250, 350)], SERVE_OPS, 2)) is None


@pytest.mark.parametrize("missing", ["the replay's name", "the span module"])
def test_the_share_is_none_for_a_program_without_graph_replay(missing, monkeypatch):
    """A port whose trace module lacks the replay's name (a program before
    CUDA graphs), or has no span module at all."""
    import sys

    import e3dge_torch.utils.trace as port_trace

    if missing == "the replay's name":
        monkeypatch.delattr(port_trace, "REPLAY")
    else:
        monkeypatch.setitem(sys.modules, "e3dge_torch.utils.trace", None)
    assert _read(synthetic(SERVE_SPANS + REPLAYS, SERVE_OPS, 2)) is None


def test_a_traced_run_on_the_cpu_reads_no_replay():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        result = run.run_cell(tiny_cell("i2i_b1"), 3 * 2**31 + 11, 0.5, True, "cpu")
    finally:
        torch.set_num_threads(n)
    assert result["metrics"][METRIC]["value"] == 0.0
