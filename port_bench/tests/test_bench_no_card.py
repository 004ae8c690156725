"""Without a card, or without the program beside it, a run exits non-zero and
prints no result."""

import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import manifest


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "i2i_b1", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.PKG, tmp_path / "port_bench", ignore=shutil.ignore_patterns(".work", ".cache"))
    code = ("from port_bench import manifest, run; "
            "run.run_cell(manifest.cell('i2i_b1'), 1, 1.0, False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "e3dge_torch" in out.stderr
