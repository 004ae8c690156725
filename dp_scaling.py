"""Data-parallel training of the port across the cards of one host, on the
trainer's own path (`python -m torch.distributed.run --standalone
--nproc_per_node N -m e3dge_torch.training.train ...` over nccl), at
stage2_config with chip_smoke.py's phase-10b recipe (TR_FLAGS +
--train-volume-d, seeded weights and perceptual files):

    python3 dp_scaling.py            # needs 4 cards; prints one JSON line last

1. Equality. 2 iterations at a global B=8: one card chip_smoke.SPREAD_RUNS
   times (the card's own spread, on cards 0, 1, 2 at once) and 4 ranks (2
   rows each). Gate, phase 11's: the 4-rank final state against the first
   one-card run within chip_smoke.RESUME_FACTOR x the largest gap among the
   one-card runs' pairs (at least RESUME_FLOOR; `equality_limits`), its
   batch-mean metrics too.
2. Weak scaling. WARMUP + MEASURED iterations at B=4 on one card and at
   B=16 on 4 ranks (4 rows each): ms per measured iteration on rank 0 (host
   clock, the card synchronised at both ends), and over the same window
   rank 0's device busy ms and NCCL kernel ms per iteration (torch.profiler,
   CUDA activity, kernels only). Efficiency = one card's ms / 4 ranks' ms.

TF32 is off in every run, as in chip_smoke.py's training phases. Each run
is a process group of chip_smoke.py's --rank-child (phase 11's) with a time
limit of its own; the one-card runs take no process group (the trainer's
default), and the one-card equality runs share the host. Every figure names the cards (nvidia-smi's name and power limit).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs

RANKS, EQ_BATCH, EQ_ITERS = 4, 8, 2
WS_BATCH_PER_RANK, WARMUP, MEASURED = 4, 2, 4
RUN_TIMEOUT = 900


def start(root: str, name: str, argv: list[str], nproc: int | None, iters: int, profile: bool = False,
          cards: str | None = None) -> dict:
    """A run of the trainer (`chip_smoke.start_ranks`): nproc ranks under
    torchrun, or one process without a process group (nproc None) on
    `cards`, with `profile` rank 0 profiled from iteration WARMUP on
    (`chip_smoke.profile_window`); its work directory under the run's out
    directory."""
    work = os.path.join(root, "dp", name, "work")
    return cs.start_ranks(root, name, {"kind": "train", "argv": [*argv, "--iters", str(iters), "--work-dir", work],
                                       "profile_from": WARMUP if profile else None}, nproc, cards=cards)


def wait(run: dict) -> tuple[str, list[dict]]:
    """(the run's work directory, its ranks' reports) once it exits 0 within
    RUN_TIMEOUT (`chip_smoke.wait_ranks`)."""
    return os.path.join(run["out"], "work"), cs.wait_ranks(run, RUN_TIMEOUT)


def equality_limits(works: list[str]) -> tuple[float, float]:
    """The equality gate's limits (metrics, final state): `chip_smoke.rank_limits`
    over the one-card runs at B=EQ_BATCH."""
    return cs.rank_limits(works, f"one-card runs at B={EQ_BATCH}")


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        print(f"dp_scaling: needs {RANKS} CUDA devices", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    cs.log(f"cards: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from e3dge_torch.ops import siren_field as sf

    sf.build_library()
    # TF32 off for every run, as chip_smoke.py's phase 3 leaves it for
    # phases 8, 10 and 11 (cuDNN's TF32 default rounds a B=2 batch's
    # convolutions otherwise than a B=8 batch's: 2.6e-4 on the first loss)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="e3dge_dp_") as root:
        # phase 10b's flags but --batch
        base = [*cs.TR_FLAGS[:cs.TR_FLAGS.index("--batch")], *cs.TR_FLAGS[cs.TR_FLAGS.index("--batch") + 2:],
                "--train-volume-d", "--saveimg-every", "0", "--ckpt-every", "1000", *cs.perceptual_files(root)]
        eq = ["--batch", str(EQ_BATCH), *base]
        ones = [wait(r)[0] for r in [start(root, f"one_card_b8_{i}", eq, None, EQ_ITERS, cards=str(i))
                                     for i in range(cs.SPREAD_RUNS)]]
        ranks, _ = wait(start(root, f"{RANKS}_ranks_b8", eq, RANKS, EQ_ITERS))
        lim_loss, lim = equality_limits(ones)
        loss, state, at = cs.run_gap(ranks, ones[0], 1, skip=cs.DP_NONLINEAR_METRICS)
        cs.log(f"equality at B={EQ_BATCH}: {RANKS} ranks vs one card: final state {state:.3e} ({at}) [limit "
               f"{lim:.3e}], metrics {loss:.3e} [limit {lim_loss:.3e}]")
        equal = state <= lim and loss <= lim_loss
        for work in (*ones, ranks):
            shutil.rmtree(work)

        iters = WARMUP + MEASURED
        _, (one,) = wait(start(root, "one_card_b4", ["--batch", str(WS_BATCH_PER_RANK), *base], None, iters,
                               profile=True, cards="0"))
        _, many = wait(start(root, f"{RANKS}_ranks_b{RANKS * WS_BATCH_PER_RANK}",
                             ["--batch", str(RANKS * WS_BATCH_PER_RANK), *base], RANKS, iters, profile=True))
        w1, wn = one["window"], many[0]["window"]
        eff = w1["ms_per_iter"] / wn["ms_per_iter"]
        cs.log(f"weak scaling, {MEASURED} iterations after {WARMUP}: one card B={WS_BATCH_PER_RANK} {w1}; "
               f"{RANKS} ranks B={RANKS * WS_BATCH_PER_RANK} (rank 0) {wn}; efficiency {eff:.4f}")
    result = {"cards": smi, "equality": {"batch": EQ_BATCH, "iters": EQ_ITERS, "one_card_runs": cs.SPREAD_RUNS,
                                         "gap_state": state, "gap_where": at, "gap_metrics": loss, "limit_state": lim,
                                         "limit_metrics": lim_loss, "inside": equal},
              "weak_scaling": {"one_card": w1, "ranks": wn, "efficiency": eff, "warmup": WARMUP,
                               "measured": MEASURED},
              "seconds": time.perf_counter() - t_start}
    print(json.dumps(result))
    return 0 if equal and not math.isnan(eff) else 1


if __name__ == "__main__":
    sys.exit(main())
