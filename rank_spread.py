"""The card's own spread beside rank runs, on one card: chip_smoke.py's
phase-10b stage-2.2 recipe (stage2_config, B=4, TF32 off, --train-volume-d)
at --iters iterations,

- on one rank ONES times, in this process (the pairs give the spread);
- twice on each of the 1x2, 2x2 and 2x1 (dp x sp) worlds over gloo, each a
  torchrun group of `chip_smoke.py --rank-child` (phase 11's);
- once with each world's control (sp gradient sum off; gradient averaging
  off at sp 1).

For every run it prints `chip_smoke.run_gap` against each one-rank run: the
batch-mean metric gap (psnr skipped, as the rank gates do) and the final
state's gap, with the metric and the group that give them. The ratio of a
rank run's gaps to the one-rank pairs' gaps says how far the rank gates
(RESUME_FACTOR x the largest pair's gap, `chip_smoke.spread_limits`) stand
from a rank run at that depth (chip_smoke.RANK_REF_ITERS).

    python3 rank_spread.py --iters 2      # one card; prints one JSON line last
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs

ONES = cs.SPREAD_RUNS
WORLDS = (("1x2", 1, 2, "sp_grad_sum_off"), ("2x2", 2, 2, "sp_grad_sum_off"), ("2x1", 2, 1, "grad_average_off"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=cs.RANK_REF_ITERS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rank_spread: no CUDA device", file=sys.stderr)
        return 1
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.training import train

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}")
    sf.build_library()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="rank_spread_") as root:
        argv = [*cs.TR_FLAGS, "--train-volume-d", "--saveimg-every", "0", *cs.perceptual_files(root),
                "--iters", str(args.iters)]
        works = {}
        for i in range(ONES):
            works[f"one_{i}"] = os.path.join(root, f"one_{i}")
            if train.main([*argv, "--work-dir", works[f"one_{i}"]]) != 0:
                raise AssertionError(f"one-rank run {i} failed")
        gc.collect()
        torch.cuda.empty_cache()  # the rank runs share the card with this process
        runs = [(f"{w}_{k}", dp, sp, ctl if k == "control" else None)
                for w, dp, sp, ctl in WORLDS for k in ("a", "b", "control")]
        # two groups at a time: two 1x2 groups (4 processes at ~14 GiB) fit
        for pair in itertools.batched(runs, 2):
            started = []
            for name, dp, sp, ctl in pair:
                works[name] = os.path.join(root, "dp", f"w_{name}")
                spec = {"kind": "train", "argv": [*argv, "--dist-backend", "gloo", "--sp", str(sp), "--work-dir",
                                                  works[name]], **({"control": ctl} if ctl else {})}
                started.append(cs.start_ranks(root, name, spec, nproc=dp * sp))
            for run in started:
                cs.wait_ranks(run)
        ones = [n for n in works if n.startswith("one_")]
        gaps = {}
        for name in works:
            for one in ones:
                if name != one and not (name.startswith("one_") and name < one):
                    loss, state, where = cs.run_gap(works[name], works[one], 1, skip=cs.DP_NONLINEAR_METRICS)
                    gaps[f"{name} vs {one}"] = {"metrics": loss, "state": state, "where": where}
                    cs.log(f"  {name} vs {one}: metrics {loss:.3e}, final state {state:.3e} ({where})")
    pairs = [g for n, g in gaps.items() if n.startswith("one_")]
    ranks = [g for n, g in gaps.items() if not n.startswith("one_") and "control" not in n]
    summary = {k: {"spread_min": min(g[k] for g in pairs), "spread_max": max(g[k] for g in pairs),
                   "rank_runs_max": max(g[k] for g in ranks)} for k in ("metrics", "state")}
    for k, v in summary.items():
        cs.log(f"iterations {args.iters}, {k}: one-rank pairs {v['spread_min']:.3e}-{v['spread_max']:.3e}, rank runs "
               f"at most {v['rank_runs_max']:.3e} ({v['rank_runs_max'] / v['spread_min']:.2f}x the smallest pair, "
               f"{v['rank_runs_max'] / v['spread_max']:.2f}x the largest: chip_smoke.spread_limits' spread)")
    print(json.dumps({"iters": args.iters, "card": smi, "summary": summary, "gaps": gaps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
