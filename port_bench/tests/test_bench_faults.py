"""A whole run on the CPU at `tiny_full_config` (the harness's look for a card
skipped): the port against the frozen reference reads `correct`, and with the
timed path broken underneath it reads not correct, once for each fault a cell
can have (an answer altered where it is produced, half of the batch left
out, a step that returns its state unchanged, the cycle step's adversarial
term left out). The comparison limits are the cells' own."""

import pytest
import torch

from port_bench import faults, run
from port_bench.tests.tiny import tiny_cell

SEED = 3 * 2**31 + 7


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell, fault", [
    ("i2i_b1", None), ("i2i_b1", faults.alter_answer),
    ("i2i_b8", None), ("i2i_b8", faults.alter_answer), ("i2i_b8", faults.half_batch_serving),
    ("st2_b4", None), ("st2_b4", faults.half_batch_training), ("st2_b4", faults.state_unchanged),
    ("st2_b4", faults.adv_dropped),
], ids=lambda x: x if isinstance(x, str) else getattr(x, "__name__", "clean"))
def test_run_judges_the_timed_path(cell, fault, monkeypatch):
    batch = {"i2i_b1": 1, "i2i_b8": 2, "st2_b4": None}[cell]
    c = tiny_cell(cell, **({"batch": batch} if batch else {}))
    if fault is not None:
        fault(monkeypatch.setattr)
    result = run.run_cell(c, SEED, 0.5, False, "cpu")
    assert result["attempted"] >= 1 and list(result)[-1] == "compared"
    assert set(result["compared"]) == set(c["workload"]["limits"])
    assert result["correct"] is (fault is None), result["compared"]
