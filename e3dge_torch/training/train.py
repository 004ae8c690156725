"""The port's trainer: stage 1 (E0 on frozen-GAN samples with 3D shape
supervision), stage 2.1 (cycle training of the E1 branch: netLocal + ADA) and
stage 2.2 (+ the SFT fusion block, with the full-resolution D's adversarial
term interleaved); the counterpart of `scripts/train.py` (reference
scripts/train/ffhq/stage{1,2.1,2.2}.sh) without its data, logging and resume
services.

    python -m e3dge_torch.training.train --iters 1000 --batch 4 --work-dir runs/stage1
    python -m e3dge_torch.training.train --stage 2.1 --ckpt runs/stage1 --work-dir runs/stage21
    python -m e3dge_torch.training.train --stage 2.2 --ckpt runs/stage21 --adv-lambda 0.01 \\
        --discriminator-lambda 0.01 --fix-ada --ema --pose-curriculum --work-dir runs/stage22
    python -m e3dge_torch.training.train --tiny --iters 2 --batch 2 --device cpu --work-dir runs/st1_tiny

The model is `stage1_config` / `stage2_config` (or `tiny_test_config` /
`tiny_full_config` with --tiny) on seeded weights (`init_weights`); the
perceptual nets and the full-res D are seeded too, as the JAX trainer's are
without checkpoints, and the D's reals are frozen-GAN samples (the JAX
trainer without --data). `--ckpt <dir>` loads the `<module>.pt` state dicts
an earlier run saved there, each entry where its shape matches
(`train_utils.warm_start_merge`), so stage 1 -> 2.1 -> 2.2 chain. Each
iteration takes, with --adv-lambda in stage 2.2, a full-res D step on a fresh
reconstruction every --d-interval iterations (lazy R1 every --d-reg-every
D steps), with --train-volume-d a volume-D step, then the E step. Saved in
<work-dir>: encoder.pt (stage 1), or encoder.pt, local.pt, grid_align.pt and
fuse_sft_block.pt (stage 2); ema.pt (--ema), discriminator.pt (the full-res
D), volume_discriminator.pt (--train-volume-d). The device defaults to the
card and raises without one. Not here: resuming the optimizer state,
validation and panels, logging services, sharding, real-image datasets.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

# --flag -> the step's lambda name
LAMBDA_FLAGS = {
    "l2_lambda": "l2_lambda",
    "vgg_lambda": "lpips_lambda",
    "id_lambda": "id_lambda",
    "latent_gt_lambda": "latent_gt_lambda",
    "surf_sdf_lambda": "shape_surface_lambda",
    "surf_normal_lambda": "shape_normal_lambda",
    "uniform_pts_sdf_lambda": "shape_uniform_lambda",
    "eikonal_lambda": "eikonal_lambda",
    "res_lambda": "res_lambda",
    "hit_prob_consistency_lambda": "hit_prob_consistency_lambda",
    "depth_lambda": "depth_lambda",
}
# stage-2 loss weights (reference stage2.{1,2}.sh via scripts/train.py:51-59,
# 245); stage 1's are steps.STAGE1_LAMBDAS
STAGE2_LAMBDAS = {
    "2.1": dict(l2_lambda=1.0, lpips_lambda=0.8, id_lambda=0.1, res_lambda=1.0),
    "2.2": dict(l2_lambda=1.0, lpips_lambda=1.0, id_lambda=0.1, res_lambda=1.0),
}
STAGE2_MODULES = ("encoder", "local", "grid_align", "fuse_sft_block")
# mapping samples averaged for the mean latents, as the JAX trainer
# (scripts/train.py:231, and again on resume at :424)
MEAN_LATENT_SAMPLES = 1000
CKPT_MODULES = (*STAGE2_MODULES, "volume_discriminator")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="1", choices=["1", "2.1", "2.2"])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-5, help="the reference stage scripts' 5e-5")
    ap.add_argument("--optimizer", default="adam", choices=["adam", "ranger"])
    ap.add_argument("--tiny", action="store_true", help="tiny_test_config / tiny_full_config")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--ckpt", default=None, help="a work dir of an earlier run: warm-start its <module>.pt files")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"], help="conv-stack compute dtype")
    ap.add_argument("--field-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="precision of the trained field (bfloat16: the twin in bf16 with fast_sin)")
    ap.add_argument("--sample-field-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="field precision of the frozen-GAN samples (bfloat16: the kernel's serving precision)")
    ap.add_argument("--remat-field", action="store_true",
                    help="recompute the differentiable field in the backward instead of storing it")
    ap.add_argument("--pose-curriculum", action="store_true", help="the progressive pose-range schedule")
    # stage 2 (reference stage2.2.sh; scripts/train.py:99-147)
    ap.add_argument("--adv-lambda", type=float, default=0.0, help="stage 2.2: the full-res D's adversarial term")
    ap.add_argument("--adaptive-d-loss", action="store_true", help="VQGAN adaptive adversarial weight")
    ap.add_argument("--discriminator-lambda", type=float, default=None, help="the D's loss weight (default adv)")
    ap.add_argument("--r1", type=float, default=60.0)
    ap.add_argument("--d-interval", type=int, default=1, help="a D step every N iterations")
    ap.add_argument("--d-reg-every", type=int, default=16)
    ap.add_argument("--fix-ada", action="store_true", help="stage 2.2: freeze the ADA aligner")
    ap.add_argument("--ema", action="store_true", help="keep an EMA of the trainable parameters")
    ap.add_argument("--use-ref-view-weight", action="store_true",
                    help="occlusion-weight the 3D-projected features (cycle_runner.py:133-161)")
    ap.add_argument("--occlusion-dtype", default="bfloat16", choices=["float32", "bfloat16"],
                    help="field precision of the occlusion re-integration (with --use-ref-view-weight)")
    ap.add_argument("--occlusion-mode", default="exact", choices=["exact", "texture"])
    ap.add_argument("--train-volume-d", action="store_true", help="interleave the volume-D step")
    ap.add_argument("--view-lambda", type=float, default=1.0, help="the volume D's viewpoint regression weight")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--work-dir", default="runs/stage1")
    for flag in LAMBDA_FLAGS:
        ap.add_argument(f"--{flag.replace('_', '-')}", type=float, default=None)
    return ap.parse_args(argv)


def make_config(args):
    from e3dge_torch import config as C

    stage1 = args.stage == "1"
    if args.tiny:
        cfg = C.tiny_test_config() if stage1 else C.tiny_full_config()
    else:
        cfg = C.stage1_config() if stage1 else C.stage2_config()
    renderer = dict(sample_field_dtype=args.sample_field_dtype, field_dtype=args.field_dtype,
                    remat_field=args.remat_field, occlusion_mode=args.occlusion_mode)
    if args.use_ref_view_weight and args.occlusion_dtype != "float32":
        renderer["occlusion_field_dtype"] = args.occlusion_dtype
    cfg = C._with(cfg, renderer=renderer)
    return C._with(cfg, dtype=args.dtype).validate() if args.dtype else cfg.validate()


def warm_start(module, path: Path) -> None:
    """Merge the state dict saved at path into module where the shapes match."""
    from e3dge_torch.training.train_utils import warm_start_merge

    merged, loaded, skipped = warm_start_merge(module.state_dict(),
                                               torch.load(path, weights_only=True, map_location="cpu"))
    module.load_state_dict(merged)
    print(f"warm-started from {path}: {loaded} entries loaded, {skipped} shape-mismatched kept fresh", flush=True)


def load_ckpt(model, ckpt: str) -> None:
    """Each `<module>.pt` in ckpt that the model has a module for."""
    for name in CKPT_MODULES:
        path = Path(ckpt) / f"{name}.pt"
        if path.exists() and hasattr(model, name):
            warm_start(getattr(model, name), path)


def main(argv=None) -> int:
    args = parse_args(argv)
    from e3dge_torch.models.discriminator import Discriminator
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.training import steps
    from e3dge_torch.training.perceptual import make_perceptual_fns
    from e3dge_torch.utils.weights import init_weights

    stage1 = args.stage == "1"
    cfg = make_config(args)
    model = E3DGE(cfg, device=args.device)
    init_weights(model, args.seed)
    if args.ckpt:
        load_ckpt(model, args.ckpt)
    gen = torch.Generator(model.device).manual_seed(args.seed)
    mean_latents = model.mean_latent(MEAN_LATENT_SAMPLES, gen)
    lambdas = dict(steps.STAGE1_LAMBDAS if stage1 else STAGE2_LAMBDAS[args.stage])
    for flag, name in LAMBDA_FLAGS.items():
        if getattr(args, flag) is not None:
            lambdas[name] = getattr(args, flag)
    if not stage1:
        lambdas.update(adv_lambda=args.adv_lambda)
    lpips_fn, id_fn = make_perceptual_fns(model.device, seed=args.seed)
    trainable = {"1": steps.STAGE1_TRAINABLE, "2.1": steps.STAGE21_TRAINABLE,
                 "2.2": steps.stage22_trainable(args.fix_ada)}[args.stage]
    state = steps.create_train_state(model, trainable, args.lr, args.optimizer, ema=args.ema)
    schedule = steps.pose_curriculum() if args.pose_curriculum else (lambda step: 1.0)
    bs = args.batch

    d_state = d_step = vd_step = None
    d_res = min(cfg.decoder.size, 256)
    if args.stage == "2.2" and args.adv_lambda > 0:
        d = Discriminator(d_res).to(model.device)
        init_weights(d, args.seed + 3)
        if args.ckpt and (Path(args.ckpt) / "discriminator.pt").exists():
            warm_start(d, Path(args.ckpt) / "discriminator.pt")
        d_state = steps.create_d_state(d, args.lr * args.d_reg_every / (args.d_reg_every + 1))
        d_lambda = args.discriminator_lambda if args.discriminator_lambda is not None else args.adv_lambda
        d_step = steps.make_full_d_step(dict(discriminator_lambda=d_lambda, r1=args.r1), d_state, args.d_reg_every)
    if args.train_volume_d:
        vd_opt = steps.make_optimizer(list(model.volume_discriminator.parameters()), args.lr)
        vd_step = steps.make_volume_d_step(
            model, dict(discriminator_lambda=1.0, viewpoint_lambda=args.view_lambda, r1=args.r1), vd_opt)

    if stage1:
        step = steps.make_stage1_step(model, lambdas, state, lpips_fn, id_fn, schedule)
    else:
        step = steps.make_cycle_step(model, lambdas, state, lpips_fn, id_fn, schedule, args.use_ref_view_weight,
                                     d_fn=None if d_state is None else d_state.d, adaptive_d_loss=args.adaptive_d_loss)
    print(f"stage {args.stage}: {'tiny' if args.tiny else 'full width'} on {model.device}, batch {bs}, "
          f"{args.optimizer} lr {args.lr}, trainable {trainable}, lambdas { {k: v for k, v in lambdas.items() if v} }",
          flush=True)

    t0 = time.perf_counter()
    d_metrics, vd_metrics = {}, {}
    for it in range(args.iters):
        if d_step is not None and it % args.d_interval == 0:
            fakes, reals = steps.full_d_batch(model, mean_latents, bs, d_res, gen)
            d_metrics = d_step(reals, fakes)
        if vd_step is not None and it % args.d_interval == 0:
            vd_metrics = vd_step(*steps.volume_d_batch(model, mean_latents, bs, gen))
        metrics = step(mean_latents, bs, gen)
        if (it + 1) % args.log_every == 0:
            m = {k: round(float(v), 5) for k, v in metrics.items()}
            m.update({f"d_{k}": round(float(v), 5) for k, v in d_metrics.items()})
            m.update({f"vd_{k}": round(float(v), 5) for k, v in vd_metrics.items()})
            print(f"iter {it + 1}: loss={m['loss']:.5f} ({(it + 1) / (time.perf_counter() - t0):.3f} it/s) {m}",
                  flush=True)
    out = Path(args.work_dir)
    out.mkdir(parents=True, exist_ok=True)
    names = ("encoder",) if stage1 else STAGE2_MODULES
    files = {f"{n}.pt": getattr(model, n).state_dict() for n in names}
    if state.ema is not None:
        files["ema.pt"] = state.ema
    if d_state is not None:
        files["discriminator.pt"] = d_state.d.state_dict()
    if vd_step is not None:
        files["volume_discriminator.pt"] = model.volume_discriminator.state_dict()
    for name, sd in files.items():
        torch.save(sd, out / name)
    print(f"saved {', '.join(files)} to {out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
