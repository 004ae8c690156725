"""The port's trainer, `python -m e3dge_torch.training.train`, at the JAX
stage scripts' flags (`scripts/train_stage1.sh`, `train_stage2.1.sh`,
`train_stage2.2.sh`: their dtypes `--sample-field-dtype bfloat16 --dtype
bfloat16 --field-dtype bfloat16`, lambdas and switches), in-process on the
CPU at `--tiny`, 2 iterations of B=2: it runs end to end, logs the dtypes
it trains at, and every logged metric and saved variable is finite."""

import json
import math

import pytest
import torch

from e3dge_torch.training import train

BF16 = ["--sample-field-dtype", "bfloat16", "--dtype", "bfloat16", "--field-dtype", "bfloat16"]
STAGE_FLAGS = {
    "1": ["--l2-lambda", "1", "--vgg-lambda", "0.8", "--id-lambda", "0.1", "--latent-gt-lambda", "1",
          "--surf-sdf-lambda", "1", "--surf-normal-lambda", "1", "--uniform-pts-sdf-lambda", "0.2",
          "--eikonal-lambda", "0.1"],
    "2.1": ["--l2-lambda", "1", "--vgg-lambda", "0.8", "--id-lambda", "0.1", "--res-lambda", "1.0",
            "--pose-curriculum"],
    "2.2": ["--l2-lambda", "1", "--vgg-lambda", "1", "--id-lambda", "0.1", "--res-lambda", "1.0", "--fix-ada",
            "--ema", "--pose-curriculum", "--adv-lambda", "0.01", "--r1", "60", "--d-reg-every", "16"],
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stage", sorted(STAGE_FLAGS))
def test_trainer_runs_at_the_stage_scripts_flags(stage, tmp_path, capsys):
    argv = ["--stage", stage, "--tiny", "--iters", "2", "--batch", "2", "--device", "cpu", "--lr", "5e-5",
            "--log-every", "1", "--saveimg-every", "0", "--work-dir", str(tmp_path), *BF16, *STAGE_FLAGS[stage]]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "dtypes: compute=bfloat16 field=bfloat16 frozen-teacher-sampling=bfloat16" in out
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    for r in records:
        bad = [k for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)]
        assert not bad and r["loss"] > 0, (r, bad)
    if stage == "2.2":
        assert records[0]["d_r1"] > 0 and "loss_e_adv" in records[0]
    variables = torch.load(tmp_path / "models_final" / "variables.pt", weights_only=True)
    assert all(bool(torch.isfinite(v).all()) for v in variables.values() if v.is_floating_point())
