"""The `sp` (ray) axis across the cards of one host, on the trainer's own
path (`python -m torch.distributed.run --standalone --nproc_per_node 4 -m
e3dge_torch.training.train --stage 2.2 --sp N ...` over nccl), at
stage2_config with dp_scaling.py's recipe (chip_smoke.py's phase-10b flags,
--train-volume-d, seeded weights and perceptual files) at stage 2.2's own
global B=4:

    python3 sp_scaling.py            # needs 4 cards; prints one JSON line last

1. Equality. WARMUP + MEASURED iterations on one card chip_smoke.SPREAD_RUNS
   times (the card's own spread; the runs share the host on cards 0, 1, 2),
   then on a 2x2 (dp 2 x sp 2) and a 1x4 (sp 4) world of 4 cards. Gate,
   phase 11's: each world's final state against the first one-card run
   within chip_smoke.RESUME_FACTOR x the largest gap among the one-card
   runs' pairs (at least RESUME_FLOOR; `equality_limits`), its batch-mean
   metrics too.
2. Strong scaling. Over the MEASURED iterations after WARMUP, each run's
   rank 0: ms per iteration (host clock, the card synchronised at both
   ends), device busy ms, NCCL kernel ms and field kernel ms per iteration
   (torch.profiler, CUDA activity, kernels only;
   `chip_smoke.profile_window`). Speed-up = one card's ms / the 4 cards' ms
   at the same B=4.
3. Where the time goes. Rank 0's busy ms without NCCL, b = Q + P / sp,
   where P is the per-sample part (work on the rays: the field, the lookups,
   SFT fusion, integration, the texture head), which the split divides,
   and Q the part each sp rank runs whole (the 2D layers and losses, the D
   producers and D steps). From one card (sp 1) and 1x4 (sp 4) at the same
   per-shard batch: P = (b_1 - b_1x4) * 4 / 3, Q = b_1 - P; the 2x2 world's
   busy is then predicted as (Q + P / 2) / 2 (half the rows) beside the
   measured one.

TF32 is off in every run, as in chip_smoke.py's training phases. Each run
is a process group of chip_smoke.py's --rank-child (phase 11's) with a time
limit of its own; the one-card runs take no process group. Every figure
names the cards (nvidia-smi's name and power limit).
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs
import dp_scaling as ds

RANKS, BATCH = 4, 4
WARMUP, MEASURED = ds.WARMUP, ds.MEASURED
MESHES = ((2, 2), (1, 4))


def equality_limits(works: list[str]) -> tuple[float, float]:
    """The equality gate's limits (metrics, final state): `chip_smoke.rank_limits`
    over the one-card runs at B=BATCH."""
    return cs.rank_limits(works, f"one-card runs at B={BATCH}")


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        print(f"sp_scaling: needs {RANKS} CUDA devices", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    cs.log(f"cards: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from e3dge_torch.ops import siren_field as sf

    sf.build_library()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    iters = WARMUP + MEASURED
    result = {"cards": smi, "batch": BATCH, "warmup": WARMUP, "measured": MEASURED, "meshes": {}}
    with tempfile.TemporaryDirectory(prefix="e3dge_sp_") as root:
        # phase 10b's flags but --batch
        i = cs.TR_FLAGS.index("--batch")
        argv = ["--batch", str(BATCH), *cs.TR_FLAGS[:i], *cs.TR_FLAGS[i + 2:], "--train-volume-d",
                "--saveimg-every", "0", "--ckpt-every", "1000", *cs.perceptual_files(root)]
        runs = [ds.wait(r) for r in [ds.start(root, f"one_card_{i}", argv, None, iters, profile=i == 0, cards=str(i))
                                     for i in range(cs.SPREAD_RUNS)]]
        ones = [work for work, _ in runs]
        one_a, one = ones[0], runs[0][1][0]["window"]
        lim_loss, lim = equality_limits(ones)
        cs.log(f"one card B={BATCH}: limits {lim:.3e} and {lim_loss:.3e}; {one}")
        result["one_card"] = {"window": one, "runs": cs.SPREAD_RUNS, "limit_state": lim, "limit_metrics": lim_loss}
        for work in ones[1:]:
            shutil.rmtree(work)
        equal = True
        for dp, sp in MESHES:
            name = f"{dp}x{sp}"
            work, reports = ds.wait(ds.start(root, name, [*argv, "--sp", str(sp)], RANKS, iters, profile=True))
            loss, state, at = cs.run_gap(work, one_a, 1, skip=cs.DP_NONLINEAR_METRICS)
            inside = state <= lim and loss <= lim_loss
            equal &= inside
            w = reports[0]["window"]
            speedup = one["ms_per_iter"] / w["ms_per_iter"]
            cs.log(f"{name} vs one card: final state {state:.3e} ({at}) [limit {lim:.3e}], metrics {loss:.3e} [limit "
                   f"{lim_loss:.3e}]: {'inside' if inside else 'OUTSIDE'}; rank 0 {w}; speed-up {speedup:.4f}; "
                   f"peak GiB per rank {[round(r['peak_gib'], 2) for r in reports]}")
            result["meshes"][name] = {"gap_state": state, "gap_where": at, "gap_metrics": loss, "inside": inside,
                                      "window": w, "speedup": speedup,
                                      "peak_gib": [r["peak_gib"] for r in reports],
                                      "launches_per_iter": cs.per_iteration(reports, iters)}
            shutil.rmtree(work)
    b1 = one["busy_ms_per_iter"] - one["nccl_ms_per_iter"]
    w4, w22 = (result["meshes"][m]["window"] for m in ("1x4", "2x2"))
    b4, b22 = (w["busy_ms_per_iter"] - w["nccl_ms_per_iter"] for w in (w4, w22))
    per_sample = (b1 - b4) * 4 / 3
    whole = b1 - per_sample
    result["split"] = {"busy_one_card": b1, "busy_1x4": b4, "busy_2x2": b22, "per_sample_ms": per_sample,
                       "whole_ms": whole, "busy_2x2_predicted": (whole + per_sample / 2) / 2}
    cs.log(f"busy without NCCL per iteration, rank 0: one card {b1:.2f}, 1x4 {b4:.2f}, 2x2 {b22:.2f} ms; per-sample "
           f"part {per_sample:.2f} ms, whole part {whole:.2f} ms; 2x2 predicted "
           f"{result['split']['busy_2x2_predicted']:.2f} ms")
    result["seconds"] = time.perf_counter() - t_start
    print(json.dumps(result))
    return 0 if equal and not math.isnan(per_sample) else 1


if __name__ == "__main__":
    sys.exit(main())
