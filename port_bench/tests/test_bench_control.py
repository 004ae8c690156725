"""On the card, at each one-card cell's own size: a sound run reads correct,
and the lower-precision control (the port's bf16 path, `--control`) reads
not correct on three seeds."""

import pytest
import torch

from port_bench import manifest, run

CELLS = [w["name"] for w in manifest.manifest()["workloads"] if w["chips"] == 1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.set_cache_dirs()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed, control", [(2**31 + 11, False), (2**31 + 12, True), (2**31 + 13, True),
                                           (2**31 + 14, True)])
def test_control_fails_sound_run_passes(card, name, seed, control):
    result = run.run_cell(manifest.cell(name), seed, 3.0, False, "cuda", control=control)
    assert result["correct"] is (not control), result["compared"]
