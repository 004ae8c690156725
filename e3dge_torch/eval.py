"""The port's evaluation entry point, the counterpart of `scripts/eval.py`
(reference test_ae.py and scripts/test/*.sh):

    python -m e3dge_torch.eval --data imgs/ --mode metrics --out runs/eval
    python -m e3dge_torch.eval --data imgs/ --mode project --project-steps 300 --pti --out runs/proj
    python -m e3dge_torch.eval --data imgs/ --mode metrics --projection-root runs/proj/projection --pti
    python -m e3dge_torch.eval --data imgs/ --mode video --views 16
    python -m e3dge_torch.eval --data imgs/ --mode edit --smile 1.0 --boundaries boundaries/
    python -m e3dge_torch.eval --data imgs/ --mode mesh --out meshes/
    python -m e3dge_torch.eval --data frames/ --mode hdtf --max-images 250
    python -m e3dge_torch.eval --tiny --device cpu --data imgs/ --mode metrics

Modes: `metrics` (validation scores; with --projection-root, from saved
projection latents), `project` (optimisation inversion, --pti for PTI),
`video` (novel-view trajectories), `edit` (semantic editing), `mesh` (.obj
per image) and `hdtf` (the HDTF novel-view video). The model is
`demo_view_synthesis_config` (`tiny_full_config` with --tiny) on seeded
weights, as the JAX CLI's are without checkpoints, with zero mean latents;
--torch-ckpt / --torch-encoder-ckpt load reference checkpoints and then
average 10,000 mapping samples for the mean latents; --ckpt loads the
`<module>.pt` files of the port's trainer where their shapes match. The
device defaults to the card and raises without one. Not here: the NoW 3D
mode.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

# mapping samples averaged for the mean latents after a reference checkpoint
# (scripts/eval.py:151)
MEAN_LATENT_SAMPLES = 10000
MODES = ("metrics", "video", "edit", "mesh", "hdtf", "project")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--mode", choices=MODES, default="metrics")
    ap.add_argument("--ckpt", default=None, help="a work dir of the port's trainer: warm-load its <module>.pt files")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference StyleSDF .pt (g_ema generator + netLocal; its 'd' entry fills the volume D)")
    ap.add_argument("--torch-encoder-ckpt", default=None,
                    help="reference E3DGE training save_dict .pt (encoder / netLocal / grid_align / Fuse_sft_block)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--smile", type=float, default=1.0)
    ap.add_argument("--boundaries", default=None)
    ap.add_argument("--out", default="runs/eval")
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--lpips-ckpt", default=None, help="LPIPS alex .pth")
    ap.add_argument("--arcface-ckpt", default=None, help="model_ir_se50.pth")
    ap.add_argument("--no-perceptual", action="store_true", help="no LPIPS/ID nets (scores lack those columns)")
    ap.add_argument("--tiny", action="store_true", help="tiny_full_config")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    # optimisation inversion (reference Projectors; defaults options.py:1474-1490)
    ap.add_argument("--project-steps", type=int, default=300, help="first_inv_steps")
    ap.add_argument("--project-lr", type=float, default=5e-3, help="first_inv_lr")
    ap.add_argument("--wspace", action="store_true", help="optimise W (one row) instead of W+")
    ap.add_argument("--pti", action="store_true", help="PTI generator tuning after projection")
    ap.add_argument("--pti-steps", type=int, default=100, help="max_pti_steps")
    ap.add_argument("--projection-root", default=None,
                    help="with --mode metrics: validate renders from saved projection latents "
                         "(trainer.py:355-379); with --pti also each image's PTI generator")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="conv-stack activation dtype (bfloat16: the serving mode)")
    ap.add_argument("--field-dtype", default=None, choices=["float32", "bfloat16"],
                    help="field precision (bfloat16: the kernel's serving precision); default --dtype")
    ap.add_argument("--debug-nans", action="store_true", help="torch anomaly mode (raises at a non-finite backward)")
    return ap.parse_args(argv)


def make_config(args):
    from e3dge_torch import config as C

    cfg = C.tiny_full_config() if args.tiny else C.demo_view_synthesis_config()
    if args.dtype != "float32":
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    fdt = args.field_dtype or args.dtype
    if fdt != "float32":
        cfg = C._with(cfg, renderer=dict(field_dtype=fdt))
    return cfg.validate()


def load_reference(model, torch_ckpt: str | None, encoder_ckpt: str | None) -> None:
    """The reference checkpoints into the model, each module strictly
    (`utils/checkpoint.py`); a StyleSDF file's 'd' entry is the volume D, the
    pose estimator (train_setup.py:139-141)."""
    from e3dge_torch.utils.checkpoint import load_reference_checkpoint, load_torch_file

    if torch_ckpt:
        raw = load_torch_file(torch_ckpt)
        g_ema = raw["g_ema"] if "g_ema" in raw else raw
        print(f"loaded reference generator {torch_ckpt}: {load_reference_checkpoint(model, g_ema=g_ema)}")
        if isinstance(raw.get("d"), dict):
            model.volume_discriminator.load_state_dict({k.removeprefix("module."): v for k, v in raw["d"].items()})
            print("loaded its 'd' entry into the volume discriminator")
    if encoder_ckpt:
        modules = load_reference_checkpoint(model, e3dge_save_dict=load_torch_file(encoder_ckpt))
        print(f"loaded reference E3DGE save_dict {encoder_ckpt}: {modules}")


def main(argv=None) -> int:
    args = parse_args(argv)
    from e3dge_torch.models.e3dge import E3DGE, LatentMeans
    from e3dge_torch.runner import Runner
    from e3dge_torch.training.data import EvalImageDataset
    from e3dge_torch.training.train import load_ckpt
    from e3dge_torch.utils.image_io import write_video
    from e3dge_torch.utils.mesh import save_obj
    from e3dge_torch.utils.weights import init_weights

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    cfg = make_config(args)
    model = E3DGE(cfg, device=args.device)
    init_weights(model, 0)
    dev = model.device
    ml = LatentMeans(torch.zeros(1, cfg.renderer.depth + 1, cfg.renderer.style_dim, device=dev),
                     torch.zeros(1, cfg.decoder.n_latent, cfg.decoder.style_dim, device=dev))
    lpips_fn = id_fn = None
    if args.mode in ("metrics", "project") and not args.no_perceptual:
        from e3dge_torch.training.perceptual import make_perceptual_fns

        lpips_fn, id_fn = make_perceptual_fns(dev, lpips_ckpt=args.lpips_ckpt, arcface_ckpt=args.arcface_ckpt)
        if not (args.lpips_ckpt and args.arcface_ckpt):
            print("NOTE: LPIPS/ID nets are random-init (pass --lpips-ckpt/--arcface-ckpt "
                  "for reference-comparable numbers)")
    if args.ckpt:
        load_ckpt(model, args.ckpt)
    if args.torch_ckpt or args.torch_encoder_ckpt:
        load_reference(model, args.torch_ckpt, args.torch_encoder_ckpt)
        ml = model.mean_latent(MEAN_LATENT_SAMPLES, torch.Generator(dev).manual_seed(2))
    runner = Runner(model, ml, dev, work_dir=args.out, lpips_fn=lpips_fn, id_fn=id_fn)
    out = Path(args.out)

    def first_batch() -> torch.Tensor:
        batch = next(EvalImageDataset(args.data, size=cfg.pifu.load_size).iter_batches(args.batch))
        return torch.from_numpy(batch["image"]).to(dev)

    if args.mode == "metrics":
        if args.projection_root:
            scores = runner.validation_from_latents(args.data, args.projection_root,
                                                    batch_size=1 if args.pti else args.batch,
                                                    max_images=args.max_images, use_pti=args.pti)
        else:
            scores = runner.validation(args.data, batch_size=args.batch, max_images=args.max_images)
        print(scores)
    elif args.mode == "project":
        results = runner.project_images(args.data, steps=args.project_steps, lr=args.project_lr,
                                        pti_steps=args.pti_steps if args.pti else 0, wspace=args.wspace,
                                        batch_size=args.batch, max_images=args.max_images)
        print(f"projected {len(results)} images -> {runner.work_dir / 'projection'}")
        for r in results:
            print(f"  {r['name']}: final_loss={r['final_loss']:.4f}")
    elif args.mode == "video":
        frames = runner.render_video(first_batch(), n_views=args.views).float().cpu().numpy()
        np.save(out / "video_frames.npy", frames)
        print("wrote", out / "video_frames.npy", frames.shape)
        for i, vid in enumerate(frames):  # one trajectory video per image
            write_video(out / "videos" / f"{i}.mp4", vid)
        print(f"wrote {len(frames)} trajectory videos under", out / "videos")
    elif args.mode == "edit":
        if not args.boundaries:
            raise SystemExit("--boundaries is required for --mode edit")
        runner.load_boundaries(args.boundaries)
        res = runner.edit_and_render(first_batch(), [0, args.smile, 0, 0, 0])
        np.save(out / "edited.npy", res["res_render_out"]["gen_imgs"].float().cpu().numpy())
        print("wrote edited renders to", out / "edited.npy")
    elif args.mode == "hdtf":
        print(runner.render_hdtf(args.data, max_frames=args.max_images or 250, batch_size=args.batch))
    elif args.mode == "mesh":
        ref = runner.encode_ref(first_batch())
        meshes = runner.latent2surface(ref["pred_latents"])
        for i, (verts, faces) in enumerate(meshes):
            save_obj(out / f"mesh_{i}.obj", verts, faces)
        print(f"wrote {len(meshes)} meshes to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
