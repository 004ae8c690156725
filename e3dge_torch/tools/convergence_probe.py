"""Stage-2 convergence probe; counterpart of `scripts/convergence_probe.py`.

Trains the stage-2.2 cycle step (`training/steps.py::cycle_loss`, Adam at
3e-4 on the local branch, the aligner and the fusion block; l2 and residual
terms only, no D, no LPIPS/ID) against a frozen seeded GAN "world" and asks
whether E1 LEARNS: on a held-out batch of identity-paired frozen-GAN views,
drawn once from a generator stream disjoint from the training draws, the
E1-conditioned render at the partner's camera must come to beat the global
baseline, the same latents decoded without E1.

Held-out metrics (`held_out_metrics`, the JAX script's names; train=False,
one set of decoder noise maps for every render of the batch):
  l2_local_full  - the E1-conditioned full-resolution render vs the partner image
  l2_global_full - `latent2image` of the predicted latents at the partner's camera
  l2_local / l2_global - the same pair at thumb resolution
At iteration 0 the E1 modulation heads are zero (as JAX initialises them), so
l2_local_full == l2_global_full; the verdicts are `improved` (l2_local_full
below its iteration-0 value) and `beats_baseline` (below l2_global_full).

Variants, on the same seed:
  base      - no ref-view weighting
  refweight - use_ref_view_weight, exact occlusion re-integration
  texture   - use_ref_view_weight, occlusion_mode="texture"

The model is `stage2_config` at full width (`tiny_full_config` with --tiny)
on seeded weights (`utils/weights.py::init_weights`), f32, on --device (the
card unless the caller asks for the CPU; there the convolutions take torch's
default cuDNN TF32, as `train.main`'s do). The field kernel is built for width
256 only: a --tiny run on the card raises at its width check.

    python -m e3dge_torch.tools.convergence_probe --iters 300 --eval-every 50 --out runs/probe/probe.json
    python -m e3dge_torch.tools.convergence_probe --tiny --device cpu --out runs/probe_tiny/probe.json

Writes {"iters", "curves": {variant: [row per eval]}} as the JAX script does;
each row also holds `ms_per_iter` (the iterations since the previous eval)
and `eval_ms`, each curve's launches of the field kernel per iteration and per
eval under "launches", and "gap" the |texture - refweight| l2_local_full per
eval where both ran.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable

import torch

from e3dge_torch.training.steps import swap_tree

VARIANTS = ("base", "refweight", "texture")
LR = 3e-4
LAMBDAS = dict(l2_lambda=1.0, res_lambda=1.0)
EVAL_BATCH = 4  # the JAX script's make_eval(bs=4), whatever --batch
# generator streams under --seed: the training draws (JAX's key(3)) and the
# held-out batch (JAX's fold_in(key(999), 7)), disjoint
TRAIN_STREAM, EVAL_STREAM = (3,), (999, 7)
METRICS = ("l2_local", "l2_global", "l2_local_full", "l2_global_full")
# the JAX record, which a run of the port never overwrites
DOCS = Path(__file__).resolve().parents[2] / "docs"


def zero_modulation_heads(model) -> None:
    """E1's zero inits as JAX makes them (`models/align.py:53-61`,
    `pifu/local_net.py:228-232`), which `init_weights` overwrites: each
    `ResnetBlockFC`'s fc_1 and biases, and every parameter of the texture
    (and geometry) modulation heads, so the modulations are an exact no-op."""
    from e3dge_torch.models.align import ResnetBlockFC

    with torch.no_grad():
        for mod in model.local.modules():
            if isinstance(mod, ResnetBlockFC):
                for p in (mod.fc_0.bias, mod.fc_1.weight, mod.fc_1.bias):
                    p.zero_()
        for name in ("local_feat_to_tex_modulations_linear", "local_feat_to_geo_modulations_linear"):
            for p in getattr(model.local, name).parameters() if hasattr(model.local, name) else ():
                p.zero_()


def build(variant: str, cfg, device=None, seed: int = 0):
    """(model, mean latents, train state): E3DGE(cfg) on `device` with seeded
    weights from `seed`, E1's modulation heads zero, both mean latents zero;
    `occlusion_mode="texture"` for the texture variant; Adam at LR on
    STAGE22_TRAINABLE (`convergence_probe.py:52-87`)."""
    from e3dge_torch.config import _with
    from e3dge_torch.models.e3dge import E3DGE, LatentMeans
    from e3dge_torch.training import steps
    from e3dge_torch.utils.weights import init_weights

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if variant == "texture":
        cfg = _with(cfg, renderer=dict(occlusion_mode="texture")).validate()
    model = E3DGE(cfg, device=device)
    init_weights(model, seed)
    zero_modulation_heads(model)
    c, dev = cfg, model.device
    ml = LatentMeans(torch.zeros(1, c.renderer.depth + 1, c.renderer.style_dim, device=dev),
                     torch.zeros(1, c.decoder.n_latent, c.decoder.style_dim, device=dev))
    return model, ml, steps.create_train_state(model, steps.STAGE22_TRAINABLE, LR)


def draw_pairs(model, batch_size: int, generator: torch.Generator) -> dict:
    """An identity-paired frozen-GAN batch at pose scale 1 with its decoder
    noise maps under "noise" (the sample and every render of it take the same
    maps, as JAX's step takes one noise rng)."""
    from e3dge_torch.training import steps

    noise = steps.decoder_noise(model, batch_size, generator)
    batch = model.synthetic_sample(batch_size, 1.0, pair_same_id=True, generator=generator, noise=noise)
    return {**batch, "noise": noise}


def held_out_batch(model, seed: int = 0) -> dict:
    """The held-out batch: EVAL_BATCH paired views from the EVAL_STREAM
    generator. The generator is frozen, so one draw serves every eval."""
    from e3dge_torch.training.train import stream_generator

    return draw_pairs(model, EVAL_BATCH, stream_generator(model.device, seed, *EVAL_STREAM))


@torch.no_grad()
def held_out_metrics(model, ml, variant: str, batch: dict) -> dict[str, float]:
    """`make_eval` (`convergence_probe.py:90-133`): the ref views encoded in
    eval mode, each rendered at its partner's camera through E1 and, as the
    global baseline, decoded from its predicted latents alone; the four mean
    squared errors against the partner's images."""
    noise = batch["noise"]
    ref_info = model.encode_ref_images(batch["images"], ml, batch["cam_settings"], train=False)
    que_cam = swap_tree(batch["cam_settings"])
    que_out = model.que_render_given_ref(ref_info, que_cam, use_ref_view_weight=variant != "base", noise=noise)
    glob_full = model.latent2image(ref_info["pred_latents"], que_cam, noise=noise)["gen_imgs"]
    gt_thumb, gt_full = swap_tree(batch["thumb_images"]), swap_tree(batch["images"])

    def l2(a, b):
        return float(torch.mean((a - b) ** 2))

    return {"l2_local": l2(que_out["res_render_out"]["gen_thumb_imgs"], gt_thumb),
            "l2_global": l2(que_out["que_info"]["gen_thumb_imgs"], gt_thumb),
            "l2_local_full": l2(que_out["res_render_out"]["gen_imgs"], gt_full),
            "l2_global_full": l2(glob_full, gt_full)}


def train_step(model, ml, state, variant: str, batch: dict) -> dict[str, torch.Tensor]:
    """One cycle step on `batch`: `cycle_loss` at LAMBDAS, its backward,
    `optimizer_step`; the detached metrics."""
    from e3dge_torch.training import steps

    loss, metrics, _ = steps.cycle_loss(model, batch, ml, LAMBDAS, use_ref_view_weight=variant != "base",
                                        noise=batch["noise"])
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    steps.optimizer_step(state)
    return {k: v.detach() for k, v in metrics.items()}


def _launches() -> int:
    from e3dge_torch.ops import siren_field as sf

    return sum(sf.launch_counts.values())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_variant(variant: str, model, ml, state, iters: int, eval_every: int, batch_size: int, seed: int = 0,
                draw_batch: Callable[[int], dict] | None = None, eval_batch: dict | None = None,
                log=print) -> dict:
    """`run_variant` (`convergence_probe.py:136-164`): held-out metrics at
    iteration 0, every `eval_every` iterations and at the end, around cycle
    steps on batches of `batch_size` from the TRAIN_STREAM generator, or
    `draw_batch(i)` for iteration i (1-based). Returns {"curve": a row per
    eval (JAX's keys, `ms_per_iter` over the iterations since the previous
    eval, `eval_ms`), "launches": the field kernel's launches per iteration
    and per eval}."""
    from e3dge_torch.training.train import stream_generator

    dev = model.device
    if draw_batch is None:
        gen = stream_generator(dev, seed, *TRAIN_STREAM)

        def draw_batch(i):
            return draw_pairs(model, batch_size, gen)

    eval_batch = eval_batch if eval_batch is not None else held_out_batch(model, seed)
    curve, counts = [], {"iter": 0, "eval": 0}

    def record(i: int, ms_per_iter: float | None) -> None:
        _sync(dev)
        n0, t0 = _launches(), time.perf_counter()
        row = held_out_metrics(model, ml, variant, eval_batch)
        _sync(dev)
        counts["eval"] += _launches() - n0
        row.update(iter=i, ms_per_iter=ms_per_iter, eval_ms=(time.perf_counter() - t0) * 1e3)
        curve.append(row)
        ms = "" if ms_per_iter is None else f" ({ms_per_iter:.1f} ms/iter, eval {row['eval_ms']:.1f} ms)"
        log(f"[{variant}] iter {i}: full_local {row['l2_local_full']:.5f} full_global {row['l2_global_full']:.5f} "
            f"thumb {row['l2_local']:.5f}/{row['l2_global']:.5f}{ms}")

    t_start = time.perf_counter()
    record(0, None)
    metrics, last, t0, n0 = None, 0, time.perf_counter(), _launches()
    for i in range(1, iters + 1):
        metrics = train_step(model, ml, state, variant, draw_batch(i))
        if i % eval_every == 0 or i == iters:
            _sync(dev)
            counts["iter"] += _launches() - n0
            record(i, (time.perf_counter() - t0) * 1e3 / (i - last))
            last, t0, n0 = i, time.perf_counter(), _launches()
    loss_text = "" if metrics is None else f" (final train loss {float(metrics['loss']):.5f})"
    log(f"[{variant}] {iters} iters in {time.perf_counter() - t_start:.0f}s{loss_text}")
    return {"curve": curve,
            "launches": {"per_iter": counts["iter"] / max(iters, 1), "per_eval": counts["eval"] / len(curve)}}


def verdicts(curve: list[dict]) -> dict[str, bool]:
    """The JAX script's verdicts on the full-res path."""
    first, last = curve[0], curve[-1]
    return {"improved": last["l2_local_full"] < first["l2_local_full"],
            "beats_baseline": last["l2_local_full"] < last["l2_global_full"]}


def occlusion_gap(curves: dict[str, list[dict]]) -> list[dict] | None:
    """|texture - refweight| on l2_local_full at each eval both ran, or None."""
    if "texture" not in curves or "refweight" not in curves:
        return None
    return [{"iter": t["iter"], "l2_local_full": abs(t["l2_local_full"] - r["l2_local_full"])}
            for t, r in zip(curves["texture"], curves["refweight"])]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m e3dge_torch.tools.convergence_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--tiny", action="store_true", help="tiny_full_config (the default: stage2_config at full width)")
    ap.add_argument("--device", default=None, help="default: the card (cuda); cpu to run on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/convergence_probe/probe.json",
                    help="the JSON record; never inside the repository's docs/, which holds the JAX record")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from e3dge_torch import config as C
    from e3dge_torch.utils.device import resolve_device

    args = parse_args(argv)
    out = Path(args.out).resolve()
    if out == DOCS or DOCS in out.parents:
        raise SystemExit(f"--out {args.out}: docs/ holds the JAX package's record; write the port's elsewhere")
    variants = args.variants.split(",")
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}; one of {VARIANTS}")
    device = resolve_device(args.device)
    cfg = C.tiny_full_config() if args.tiny else C.stage2_config()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"config {'tiny_full_config' if args.tiny else 'stage2_config'}, batch {args.batch}, device {where}",
          flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    results, runs = {}, {}
    for v in variants:
        t0 = time.perf_counter()
        model, ml, state = build(v, cfg, device, args.seed)
        print(f"[{v}] built in {time.perf_counter() - t0:.1f} s", flush=True)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        runs[v] = run_variant(v, model, ml, state, args.iters, args.eval_every, args.batch, args.seed,
                              log=lambda s: print(s, flush=True))
        if device.type == "cuda":
            runs[v]["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        results[v] = runs[v]["curve"]
        del model, ml, state
        # the record so far, rewritten after each variant
        record = {"iters": args.iters, "curves": results, "gap": occlusion_gap(results),
                  "launches": {v: r["launches"] for v, r in runs.items()},
                  "peak_gib": {v: r.get("peak_gib") for v, r in runs.items()},
                  "config": "tiny_full_config" if args.tiny else "stage2_config", "batch": args.batch,
                  "seed": args.seed, "device": where}
        out.write_text(json.dumps(record, indent=1))
    print(f"wrote {out}")

    for v, curve in results.items():
        first, last = curve[0], curve[-1]
        verdict = verdicts(curve)
        print(f"[{v}] full {first['l2_local_full']:.5f} -> {last['l2_local_full']:.5f} "
              f"(improved={verdict['improved']}); vs global {last['l2_global_full']:.5f} "
              f"(beats_baseline={verdict['beats_baseline']})")
    for row in record["gap"] or ():
        print(f"iter {row['iter']}: |texture - refweight| l2_local_full {row['l2_local_full']:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
