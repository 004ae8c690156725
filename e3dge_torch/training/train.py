"""The port's trainer: stage 1 (E0 on frozen-GAN samples with 3D shape
supervision), stage 2.1 (cycle training of the E1 branch: netLocal + ADA) and
stage 2.2 (+ the SFT fusion block, with the full-resolution D's adversarial
term interleaved); the counterpart of `scripts/train.py` (reference
train_ae.py, scripts/train/ffhq/stage{1,2.1,2.2}.sh), with its services.

    python -m e3dge_torch.training.train --iters 1000 --batch 4 --work-dir runs/stage1
    python -m e3dge_torch.training.train --stage 2.1 --ckpt runs/stage1/models_final --work-dir runs/stage21
    python -m e3dge_torch.training.train --stage 2.2 --ckpt runs/stage21/models_final --adv-lambda 0.01 \\
        --fix-ada --ema --pose-curriculum --data ffhq/ --val-data celebahq_test/ --work-dir runs/stage22
    python -m e3dge_torch.training.train --stage 2.2 ... --resume runs/stage22/models_latest
    python -m e3dge_torch.training.train --tiny --iters 2 --batch 2 --device cpu --work-dir runs/st1_tiny
    python -m torch.distributed.run --standalone --nproc_per_node 4 -m e3dge_torch.training.train --batch 16 ...
    python -m torch.distributed.run --standalone --nproc_per_node 4 -m e3dge_torch.training.train --stage 2.2 \
        --batch 4 --sp 2 ...

The model is `stage1_config` / `stage2_config` (or `tiny_test_config` /
`tiny_full_config` with --tiny) on seeded weights (`init_weights`); the
perceptual nets are seeded unless --lpips-ckpt / --arcface-ckpt fill them
(a warning says they are not the reference objective otherwise). Each
iteration takes, with --adv-lambda in stage 2.2, a full-res D step every
--d-interval iterations (lazy R1 every --d-reg-every D steps) against the
--data folder's images (frozen-GAN samples without it), with
--train-volume-d a volume-D step, then the E step. Every iteration draws from
its own generators, seeded from (--seed, iteration, stream), so a resumed run
replays the uninterrupted one; the training panels draw from a disjoint range.

Services: metrics.jsonl in <work-dir> every --log-every iterations (wandb
with --wandb); panels under <work-dir>/train/images every --saveimg-every;
`Runner.validation` of --val-data every --val-every (at most 8 images,
scores.json); checkpoints <work-dir>/models_latest every --ckpt-every and
models_final at the end (`Runner.save_checkpoint`: variables.pt, state.pt
with the step, optimizer and EMA, d_state.pt with both Ds), the previous one
rotated to models_<name>_old. --resume <dir> restores all of it; --ckpt <dir>
warm-starts the variables only, where their shapes match, from a
models_<name> directory or from the `<module>.pt` files of the earlier layout
(`utils.checkpoint.warm_start_checkpoint`), so stage 1 -> 2.1 -> 2.2 chain.
--debug-nans turns on torch's anomaly mode. The device defaults to the card
and raises without one.

Under torchrun (RANK, WORLD_SIZE, LOCAL_RANK set) the run is data-parallel
over the ranks (`parallel.mesh`), each on card LOCAL_RANK mod the visible
cards, over --dist-backend (nccl on cards, gloo on the CPU or for ranks that
share a card): --batch stays the global batch and each rank takes its rows,
so n ranks compute what one process computes on that batch. The model and
both Ds start from rank 0's; only rank 0 prints, logs, writes panels,
validates and saves, while the others wait; --resume loads on every rank.
With --sp N (stages 2.1 and 2.2; WORLD_SIZE = dp x N) the ranks form JAX's
dp x sp mesh: the batch is split over dp, and each cycle step splits the
rays of its G0 renders over the N ranks of a dp shard (`parallel.mesh`);
the D producers and D steps run whole on each of them. Stage 1 refuses it.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from e3dge_torch.parallel import mesh

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
# mapping samples averaged for the mean latents, as the JAX trainer
# (scripts/train.py:231, and again on resume at :424)
MEAN_LATENT_SAMPLES = 1000
# generator streams: each iteration's D producer, volume-D producer and E step
# (the JAX trainer's per-iteration key split, :471-476); the panels' iteration
# numbers are offset into a range no training iteration reaches (:458); the
# mean latents' own key (JAX's key(2), :231)
D_STREAM, VD_STREAM, E_STREAM = 0, 1, 2
PANEL_OFFSET = 2**31
MEAN_LATENT_KEY = 2


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="1", choices=["1", "2.1", "2.2"])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-5, help="the reference stage scripts' 5e-5")
    ap.add_argument("--optimizer", default="adam", choices=["adam", "ranger"])
    ap.add_argument("--tiny", action="store_true", help="tiny_test_config / tiny_full_config")
    ap.add_argument("--device", default=None, help="default: the CUDA card (under torchrun, LOCAL_RANK's)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' backend under torchrun (default: nccl on cards, gloo on the CPU)")
    ap.add_argument("--sp", type=int, default=1,
                    help="stages 2.x under torchrun: the ray (sp) axis of the dp x sp mesh, dividing WORLD_SIZE")
    ap.add_argument("--ckpt", default=None,
                    help="warm-start the variables from an earlier run's models_<name> directory (or the <module>.pt "
                         "files of the earlier layout) where their shapes match; the optimizer starts fresh")
    ap.add_argument("--resume", default=None,
                    help="a models_<name> directory: continue its run with its variables, step, optimizer, EMA and "
                         "both D states")
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
    ap.add_argument("--work-dir", default="runs/train")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--val-every", type=int, default=2000, help="reference --val_interval")
    ap.add_argument("--saveimg-every", type=int, default=100, help="training panels (reference --saveimg_interval; 0: none)")
    ap.add_argument("--val-data", default=None, help="an image folder validated during training")
    ap.add_argument("--data", default=None, help="a real-image folder: the full-res D's reals in stage 2.2")
    ap.add_argument("--lpips-ckpt", default=None, help="LPIPS alex .pth")
    ap.add_argument("--arcface-ckpt", default=None, help="model_ir_se50.pth")
    ap.add_argument("--wandb", action="store_true", help="log to wandb too (reference --wandb)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="torch anomaly mode (the reference's set_detect_anomaly, train_ae.py:16-20): a backward "
                         "that produces a non-finite value raises")
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


def stream_generator(device, *keys: int) -> torch.Generator:
    """A generator on device seeded from the key tuple (numpy's SeedSequence)."""
    seed = int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device).manual_seed(seed)


def save_train_panel(runner, it: int, batch_size: int, seed: int) -> Path:
    """The training panel of iteration `it` (reference trainer.py:229-240):
    a fresh frozen-GAN batch from the panel stream, inverted by
    `runner.image2image`; one row per item of GT | thumb | residual | aligned
    residual | reconstruction, at most 256^2, as
    work_dir/train/images/iter_<it>.png."""
    from e3dge_torch.ops import adaptive_avg_pool
    from e3dge_torch.utils.image_io import save_panel

    model = runner.model
    batch = model.synthetic_sample(batch_size, 1.0, generator=stream_generator(model.device, seed, PANEL_OFFSET + it))
    out = runner.image2image(batch["images"])
    rec = out["res_render_out"] if "res_render_out" in out else out
    res = min(batch["images"].shape[-1], 256)
    rows = {"gt": adaptive_avg_pool(batch["images"], res), "thumb": rec["gen_thumb_imgs"]}
    if "ref_info" in out:
        rows["residual"] = out["ref_info"]["orig_res_gt"]
    if "aligned_res" in out:
        rows["aligned_res"] = out["aligned_res"]
    rows["rec"] = adaptive_avg_pool(rec["gen_imgs"], res)
    path = runner.work_dir / "train" / "images" / f"iter_{it:07d}.png"
    save_panel(path, {k: v.float().cpu().numpy() for k, v in rows.items()})
    return path


def main(argv=None) -> int:
    args = parse_args(argv)
    with torch.autograd.detect_anomaly() if args.debug_nans else contextlib.nullcontext():
        return train(args)


def train(args: argparse.Namespace) -> int:
    """The run `main` parses, on this process's ranks (none under no
    launcher): `run` between joining the process group and leaving it, on
    an exception too."""
    if args.sp > 1 and args.stage == "1":
        raise SystemExit(f"--sp {args.sp}: stage 1 takes no ray split (JAX's stage-1 step has no constrain_fn)")
    world = mesh.init_distributed(args.dist_backend, device=args.device, sp=args.sp)
    try:
        return run(args, world)
    finally:
        mesh.shutdown(world)


def run(args: argparse.Namespace, world: mesh.World) -> int:
    """Set-up, resume, the iterations and services on `world`'s rank."""
    from e3dge_torch.models.discriminator import Discriminator
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.runner import Runner
    from e3dge_torch.training import steps
    from e3dge_torch.training.data import ImageFolderDataset
    from e3dge_torch.training.perceptual import make_perceptual_fns
    from e3dge_torch.utils.checkpoint import warm_start_checkpoint
    from e3dge_torch.utils.logger import MetricLogger, print_parameter
    from e3dge_torch.utils.weights import init_weights

    main_rank = world.is_main
    say = print if main_rank else (lambda *a, **k: None)
    stage1 = args.stage == "1"
    cfg = make_config(args)
    model = E3DGE(cfg, device=world.device)
    dev = model.device
    init_weights(model, args.seed)
    if args.ckpt:
        warm_start_checkpoint(model, args.ckpt)
    mesh.replicate(model, world)
    lambdas = dict(steps.STAGE1_LAMBDAS if stage1 else STAGE2_LAMBDAS[args.stage])
    for flag, name in LAMBDA_FLAGS.items():
        if getattr(args, flag) is not None:
            lambdas[name] = getattr(args, flag)
    if not stage1:
        lambdas.update(adv_lambda=args.adv_lambda)
    lpips_fn = id_fn = None
    if lambdas.get("lpips_lambda", 0) > 0 or lambdas.get("id_lambda", 0) > 0:
        if not (args.lpips_ckpt or args.arcface_ckpt):
            say("WARNING: LPIPS/ID lambdas active without --lpips-ckpt/--arcface-ckpt; using RANDOM-INIT "
                  "perceptual nets (smooth surrogates, NOT the reference objective)", flush=True)
        lpips_fn, id_fn = make_perceptual_fns(dev, seed=args.seed, lpips_ckpt=args.lpips_ckpt,
                                              arcface_ckpt=args.arcface_ckpt)
        lpips_fn = lpips_fn if lambdas.get("lpips_lambda", 0) > 0 else None
        id_fn = id_fn if lambdas.get("id_lambda", 0) > 0 else None
    trainable = {"1": steps.STAGE1_TRAINABLE, "2.1": steps.STAGE21_TRAINABLE,
                 "2.2": steps.stage22_trainable(args.fix_ada)}[args.stage]
    state = steps.create_train_state(model, trainable, args.lr, args.optimizer, ema=args.ema)
    if main_rank:
        print_parameter(state.params)  # the trainable audit (reference trainer.py:753-757)
    say(f"lambdas: { {k: v for k, v in lambdas.items() if v} }")
    say(f"dtypes: compute={cfg.dtype} field={cfg.renderer.field_dtype} "
          f"frozen-teacher-sampling={cfg.renderer.sample_field_dtype}", flush=True)
    schedule = steps.pose_curriculum() if args.pose_curriculum else (lambda step: 1.0)
    bs = args.batch

    d_state = d_step = vd_state = vd_step = real_iter = None
    d_res = min(cfg.decoder.size, 256)
    if args.stage == "2.2" and args.adv_lambda > 0:
        d = Discriminator(d_res).to(dev)
        init_weights(d, args.seed + 3)
        mesh.replicate(d, world)
        d_state = steps.create_d_state(d, args.lr * args.d_reg_every / (args.d_reg_every + 1))
        d_lambda = args.discriminator_lambda if args.discriminator_lambda is not None else args.adv_lambda
        d_step = steps.make_full_d_step(dict(discriminator_lambda=d_lambda, r1=args.r1), d_state, args.d_reg_every,
                                        world)
        if args.data:
            # the thumb is not used here; at most d_res, so --tiny's 32^2 D can read a folder (JAX's 64 cannot)
            ds = ImageFolderDataset(args.data, size=d_res, thumb_size=min(64, d_res),
                                    rng=np.random.RandomState(args.seed))
            real_iter = ds.iter_batches(bs, args.seed, world)
        else:
            say("WARNING: --adv-lambda set without --data; using frozen-GAN samples as D reals "
                  "(smoke mode: the reference trains the D against FFHQ)", flush=True)
    if args.train_volume_d:
        vd_state = steps.create_volume_d_state(model, args.lr)
        vd_step = steps.make_volume_d_step(
            model, dict(discriminator_lambda=1.0, viewpoint_lambda=args.view_lambda, r1=args.r1), vd_state.optimizer,
            world)

    if stage1:
        step = steps.make_stage1_step(model, lambdas, state, lpips_fn, id_fn, schedule, world)
    else:
        step = steps.make_cycle_step(model, lambdas, state, lpips_fn, id_fn, schedule, args.use_ref_view_weight,
                                     d_fn=None if d_state is None else d_state.d, adaptive_d_loss=args.adaptive_d_loss,
                                     world=world)

    def mean_latents():
        ml = model.mean_latent(MEAN_LATENT_SAMPLES, stream_generator(dev, args.seed, MEAN_LATENT_KEY))
        mesh.broadcast_(list(ml), world)
        return ml

    def d_bundle():
        """Both D states ride the checkpoint as one bundle (scripts/train.py:403-407)."""
        return None if d_state is None and vd_state is None else {"full": d_state, "volume": vd_state}

    runner = Runner(model, mean_latents(), dev, work_dir=args.work_dir)
    start_it = 0
    if args.resume:
        restored, _ = runner.load_checkpoint(args.resume, state_template=state, d_template=d_bundle())
        if restored is None:
            raise SystemExit(f"--resume {args.resume}: no training state in checkpoint "
                             "(use --ckpt for a variables-only warm start)")
        start_it = state.step
        runner.mean_latents = mean_latents()
        say(f"resumed from {args.resume} at iter {start_it}", flush=True)
    ml = runner.mean_latents
    ranks = f" ({world.size} ranks, {bs // world.size} rows each)" if world.size > 1 else ""
    if world.sp > 1:
        h = cfg.renderer.out_im_res
        ranks = (f" ({world.size} ranks: dp {world.dp} x sp {world.sp}, {bs // world.dp} rows and {h // world.sp} "
                 f"of {h} ray rows each)")
    say(f"stage {args.stage}: {'tiny' if args.tiny else 'full width'} on {dev}, batch {bs}{ranks}, {args.optimizer} "
        f"lr {args.lr}, trainable {trainable}", flush=True)

    logger = MetricLogger(args.work_dir, use_wandb=args.wandb, config={"stage": args.stage, "cfg": cfg.to_dict()})
    t0 = time.perf_counter()
    d_metrics, vd_metrics = {}, {}
    for it in range(start_it, args.iters):
        gen_d, gen_vd, gen_e = (stream_generator(dev, args.seed, it, s) for s in (D_STREAM, VD_STREAM, E_STREAM))
        if d_step is not None and it % args.d_interval == 0:
            fakes, reals = steps.full_d_batch(model, ml, bs, d_res, gen_d, world)
            if real_iter is not None:
                reals = torch.from_numpy(next(real_iter)["image"]).to(dev)
            d_metrics = d_step(reals, fakes)
        if vd_step is not None and it % args.d_interval == 0:
            vd_metrics = vd_step(*steps.volume_d_batch(model, ml, bs, gen_vd, world))
            vd_state.step += 1
        metrics = step(ml, bs, gen_e)
        n = it + 1
        if main_rank and n % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m.update({f"d_{k}": float(v) for k, v in d_metrics.items()})
            m.update({f"vd_{k}": float(v) for k, v in vd_metrics.items()})
            rate = (n - start_it) / (time.perf_counter() - t0)
            extras = f" pose_scale={schedule(it):.2f}" if args.pose_curriculum else ""
            print(f"iter {n}: loss={m['loss']:.5f} ({rate:.3f} it/s){extras} "
                  f"{ {k: round(v, 5) for k, v in m.items()} }", flush=True)
            logger.log(n, m)
        panel = args.saveimg_every and n % args.saveimg_every == 0
        val = args.val_data and n % args.val_every == 0
        save = n % args.ckpt_every == 0
        if main_rank:
            if panel:
                save_train_panel(runner, n, bs, args.seed)
            if val:
                print(f"iter {n} validation: {runner.validation(args.val_data, batch_size=bs, max_images=8)}",
                      flush=True)
            if save:
                runner.save_checkpoint(state=state, name="latest", d_state=d_bundle())
        if panel or val or save:
            mesh.barrier(world)  # the other ranks wait for rank 0's services
    if main_rank:
        path = runner.save_checkpoint(state=state, name="final", d_state=d_bundle())
        print(f"done: saved {path}", flush=True)
    mesh.barrier(world)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
