"""The port's stage-1 trainer: E0 on frozen-GAN samples with 3D shape
supervision (the stage-1 subset of `scripts/train.py`; reference
scripts/train/ffhq/stage1.sh).

    python -m e3dge_torch.training.train --iters 1000 --batch 4 --work-dir runs/stage1
    python -m e3dge_torch.training.train --tiny --iters 2 --batch 2 --device cpu --work-dir runs/st1_tiny

The model is `stage1_config` (or `tiny_test_config` with --tiny) on seeded
weights (`init_weights`); the perceptual nets are seeded too, as the JAX
trainer's are without checkpoints. Each iteration takes one `make_stage1_step`
step; the trained E0 state dict is saved as <work-dir>/encoder.pt. The device
defaults to the card and raises without one. Stages 2.1/2.2, discriminator
steps, resuming and logging services are not part of this trainer.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

# --flag -> the step's lambda name (stage-1 defaults: steps.STAGE1_LAMBDAS)
LAMBDA_FLAGS = {
    "l2_lambda": "l2_lambda",
    "vgg_lambda": "lpips_lambda",
    "id_lambda": "id_lambda",
    "latent_gt_lambda": "latent_gt_lambda",
    "surf_sdf_lambda": "shape_surface_lambda",
    "surf_normal_lambda": "shape_normal_lambda",
    "uniform_pts_sdf_lambda": "shape_uniform_lambda",
    "eikonal_lambda": "eikonal_lambda",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-5, help="the reference stage scripts' 5e-5")
    ap.add_argument("--optimizer", default="adam", choices=["adam", "ranger"])
    ap.add_argument("--tiny", action="store_true", help="tiny_test_config instead of stage1_config")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--sample-field-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="field precision of the frozen-GAN samples (bfloat16: the kernel's serving precision)")
    ap.add_argument("--remat-field", action="store_true",
                    help="recompute the differentiable field in the backward instead of storing it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--work-dir", default="runs/stage1")
    for flag in LAMBDA_FLAGS:
        ap.add_argument(f"--{flag.replace('_', '-')}", type=float, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from e3dge_torch import config as C
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.training import steps
    from e3dge_torch.training.perceptual import make_perceptual_fns
    from e3dge_torch.utils.weights import init_weights

    cfg = C.tiny_test_config() if args.tiny else C.stage1_config()
    cfg = C._with(cfg, renderer=dict(sample_field_dtype=args.sample_field_dtype, remat_field=args.remat_field))
    model = E3DGE(cfg, device=args.device)
    init_weights(model, args.seed)
    gen = torch.Generator(model.device).manual_seed(args.seed)
    mean_latents = model.mean_latent(10000, gen)
    lambdas = dict(steps.STAGE1_LAMBDAS)
    for flag, name in LAMBDA_FLAGS.items():
        if getattr(args, flag) is not None:
            lambdas[name] = getattr(args, flag)
    lpips_fn, id_fn = make_perceptual_fns(model.device, seed=args.seed)
    state = steps.create_train_state(model, steps.STAGE1_TRAINABLE, args.lr, args.optimizer)
    step = steps.make_stage1_step(model, lambdas, state, lpips_fn, id_fn)
    print(f"stage 1: {'tiny' if args.tiny else 'stage1_config'} on {model.device}, batch {args.batch}, "
          f"{args.optimizer} lr {args.lr}, lambdas {lambdas}", flush=True)

    t0 = time.perf_counter()
    for it in range(args.iters):
        metrics = step(mean_latents, args.batch, gen)
        if (it + 1) % args.log_every == 0:
            m = {k: round(float(v), 5) for k, v in metrics.items()}
            print(f"iter {it + 1}: loss={m['loss']:.5f} ({(it + 1) / (time.perf_counter() - t0):.3f} it/s) {m}",
                  flush=True)
    out = Path(args.work_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(model.encoder.state_dict(), out / "encoder.pt")
    print(f"saved the E0 state dict to {out / 'encoder.pt'}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
