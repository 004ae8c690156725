"""Metric logging of the port: the trainable-parameter audit, and metrics to
a JSONL file with wandb when asked and installed; counterpart of
`e3dge_tpu/utils/logger.py` (reference print_parameter, misc_utils.py:225-228,
and the rank-0 wandb logging, train_setup.py:368-383). Under
torch.distributed only rank 0 writes."""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Mapping

import torch


def print_parameter(params: Mapping[str, torch.Tensor]) -> int:
    """The trainable-parameter audit at train start (trainer.py:753-757):
    every tensor of `params` (state-dict names, as `TrainState.params`) with
    its shape, then the count per top-level module and the total. Returns the
    total."""
    total = 0
    per_key: dict[str, int] = {}
    for name, p in params.items():
        n = math.prod(p.shape)
        total += n
        top = name.split(".")[0]
        per_key[top] = per_key.get(top, 0) + n
        print(f"{name} {tuple(p.shape)}")
    for key, n in sorted(per_key.items()):
        print(f"[trainable] {key}: {n:,} params")
    print(f"[trainable] total: {total:,} params")
    return total


def _is_main() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricLogger:
    """Appends {"step", "time", <metric>: float} records to
    work_dir/metrics.jsonl, and to wandb with use_wandb when it imports."""

    def __init__(self, work_dir: str | Path, use_wandb: bool = False, config: dict | None = None):
        self.is_main = _is_main()
        self.path = Path(work_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        if use_wandb and self.is_main:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb
                wandb.init(project="e3dge_torch", config=config or {})

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        if not self.is_main:
            return
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        with self.path.open("a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(record, step=step)
