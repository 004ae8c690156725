"""The four-rank cell `st2_dp4_b16` driven whole: on the CPU at
`tiny_full_config` over four gloo ranks (the harness's look for cards
skipped), a sound run reads `correct` against the frozen one-rank reference
at the global batch, and with the timed path broken underneath in every
rank it reads not correct, once for each fault the cell can have; a peer
that dies ends the run with a non-zero code and no result within its time
limit, and so does a peer that loads JAX. On four cards (`cuda`) a sound
run passes and the control fails. Each run is a process of its own: a run that fails ends its process."""

import json
import subprocess
import sys
import time

import pytest
import torch

from port_bench import faults, manifest
from port_bench.drivers import train_dp

CELL = "st2_dp4_b16"
RUN = """
import json, sys, torch
from port_bench import faults, manifest, run
from port_bench.tests.tiny import tiny_cell
seed, device, trace, control = int(sys.argv[1]), sys.argv[2], bool(int(sys.argv[3])), bool(int(sys.argv[4]))
for name in sys.argv[5:]:
    faults.BY_NAME[name](setattr)
if device == "cpu":
    torch.set_num_threads(8)
    cell = tiny_cell("st2_dp4_b16", reals=16)
else:
    run.set_cache_dirs()
    cell = manifest.cell("st2_dp4_b16")
result = run.run_cell(cell, seed, 0.5 if device == "cpu" else 3.0, trace, device, control=control)
print(json.dumps(result))
"""


def dp_run(seed, *fault_names, device="cpu", trace=False, control=False):
    """(the process, its result or None, its seconds)."""
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", RUN, str(seed), device, str(int(trace)), str(int(control)),
                          *fault_names], cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    lines = out.stdout.strip().splitlines()
    return out, json.loads(lines[-1]) if lines else None, time.monotonic() - t


def test_a_traced_run_reads_correct_and_reports_its_metrics():
    out, result, _ = dp_run(3 * 2**31 + 21, trace=True)
    assert out.returncode == 0 and result is not None, out.stderr[-4000:]
    assert result["correct"] is True, result["compared"]
    assert set(result["compared"]) == set(manifest.cell(CELL)["workload"]["limits"])
    # no device operation runs on the CPU: what reads the port's spans is there
    assert {"train.e_backward_ms", "train.e_optimizer_ms", "train.reals_wait_ms",
            "train.host_wait_ms"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", ["grad_exchange_skipped", "rank_local_stats", "half_batch_training",
                                   "state_unchanged"])
def test_a_fault_in_every_rank_reads_not_correct(fault):
    assert fault in faults.BY_NAME
    out, result, _ = dp_run(3 * 2**31 + 22, fault)
    assert out.returncode == 0 and result is not None, out.stderr[-4000:]
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("fault, said", [
    ("peer_exits", None),
    ("peer_loads_jax", "forbidden modules loaded: rank 1: jax; rank 2: jax; rank 3: jax"),
])
def test_a_peer_that_fails_ends_the_run_without_a_result(fault, said):
    """A peer that dies: rank 0 ends at the collective it left (gloo
    raises) or at its watchdog (NCCL waits), whichever comes first. A peer
    that loads JAX: ranks 1-3 do three quarters of the work, so a forbidden
    module in one of them fails the run though rank 0's own are clean."""
    out, result, seconds = dp_run(3 * 2**31 + 23, fault)
    assert out.returncode != 0 and result is None, out.stderr[-4000:]
    assert seconds < train_dp.RUN_LIMIT_S
    assert said is None or said in out.stderr, out.stderr[-4000:]


@pytest.mark.cuda
@pytest.mark.parametrize("seed, control", [(2**31 + 31, False), (2**31 + 32, True)])
def test_on_four_cards_a_sound_run_passes_and_the_control_fails(seed, control):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    out, result, _ = dp_run(seed, device="cuda", control=control)
    assert out.returncode == 0 and result is not None, out.stderr[-4000:]
    assert result["correct"] is (not control), result["compared"]
