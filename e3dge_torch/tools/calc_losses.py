"""Metrics between a results folder and a ground-truth folder; counterpart of
`scripts/calc_losses.py` (reference helper_scripts/calc_losses_on_images.py):
images paired by file name (a result without its ground truth is skipped),
resized to --size by Pillow's bilinear filter, scored per image in --mode, and
written as `stat_<mode>.txt` (the mean and std) and `scores_<mode>.json` (each
image's score) under --out (default <data-path>/../inference_metrics).

Modes: lpips and id (the port's LPIPS and ArcFace nets, `training/
perceptual.py`: seeded, filled from --lpips-ckpt / --arcface-ckpt; id scores
1 - the cosine similarity), l2, psnr (max_val 2 on [-1, 1]), ssim, and the
reference's printed conventions ssim_ref (kornia window-5 (1 + SSIM) / 2) and
mae_ref (L1 on [-1, 1]). Every metric runs on --device, the card unless the
caller asks for the CPU.

    python -m e3dge_torch.tools.calc_losses --mode lpips --data-path results/ --gt-path gt/
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

MODES = ("lpips", "l2", "psnr", "ssim", "ssim_ref", "mae_ref", "id")


def load_pairs(data_path: Path, gt_path: Path, size: int) -> tuple[list[str], np.ndarray, np.ndarray]:
    """(names, results, ground truths): [-1, 1] float32 CHW arrays of the
    images of data_path that have a file of the same name in gt_path."""
    from PIL import Image

    def load(p):
        im = Image.open(p).convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.float32).transpose(2, 0, 1) / 127.5 - 1.0

    names, res, gts = [], [], []
    for f in sorted(Path(data_path).iterdir()):
        if f.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        g = Path(gt_path) / f.name
        if not g.exists():
            print(f"skip {f.name}: no ground-truth counterpart")
            continue
        names.append(f.name)
        res.append(load(f))
        gts.append(load(g))
    if not names:
        raise SystemExit(f"no paired images between {data_path} and {gt_path}")
    return names, np.stack(res), np.stack(gts)


def metric_fn(mode: str, device: torch.device, lpips_ckpt: str | None = None, arcface_ckpt: str | None = None):
    """fn(pred, target) -> [B] scores of [B, 3, H, W] tensors in [-1, 1] on device."""
    from e3dge_torch.training import losses

    if mode in ("lpips", "id"):
        from e3dge_torch.training.perceptual import make_perceptual_fns

        lpips_fn, id_fn = make_perceptual_fns(device, lpips_ckpt=lpips_ckpt, arcface_ckpt=arcface_ckpt)
        if mode == "lpips":
            if not lpips_ckpt:
                print("NOTE: the LPIPS net is seeded (pass --lpips-ckpt for reference-comparable numbers)")
            return lambda p, t: lpips_fn(p, t, per_sample=True)
        if not arcface_ckpt:
            print("NOTE: the ArcFace net is seeded (pass --arcface-ckpt for reference-comparable numbers)")
        return lambda p, t: id_fn(p, t, per_sample=True)[0]
    return {
        "l2": lambda p, t: ((p - t) ** 2).mean(dim=(1, 2, 3)),
        "psnr": lambda p, t: torch.stack([losses.psnr(p[i : i + 1], t[i : i + 1], max_val=2.0) for i in range(len(p))]),
        "ssim": lambda p, t: losses.ssim(p, t, max_val=2.0, per_sample=True),
        "ssim_ref": lambda p, t: losses.ssim_ref(p, t, per_sample=True),
        "mae_ref": lambda p, t: losses.mae_ref(p, t, per_sample=True),
    }[mode]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m e3dge_torch.tools.calc_losses", description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="lpips", choices=MODES,
                    help="ssim_ref / mae_ref use the reference's printed conventions (kornia window-5 (1+SSIM)/2 "
                         "and L1 on [-1, 1], builder.py:171-182)")
    ap.add_argument("--data-path", required=True, help="results folder")
    ap.add_argument("--gt-path", required=True, help="ground-truth folder (the same file names)")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--lpips-ckpt", default=None)
    ap.add_argument("--arcface-ckpt", default=None)
    ap.add_argument("--out", default=None, help="default: <data-path>/../inference_metrics")
    ap.add_argument("--device", default=None, help="default: the card (cuda); cpu to run on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from e3dge_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    names, res, gts = load_pairs(Path(args.data_path), Path(args.gt_path), args.size)
    fn = metric_fn(args.mode, device, args.lpips_ckpt, args.arcface_ckpt)
    scores: dict[str, float] = {}
    with torch.no_grad():
        for i in range(0, len(names), args.batch_size):
            p, t = (torch.from_numpy(a[i : i + args.batch_size]).to(device) for a in (res, gts))
            for name, v in zip(names[i : i + args.batch_size], fn(p, t).float().cpu().numpy()):
                scores[name] = float(v)
    vals = np.array(list(scores.values()))
    result_str = f"Average loss is {vals.mean():.4f}+-{vals.std():.4f}"
    print("Finished with", args.data_path)
    print(result_str)
    out = Path(args.out) if args.out else Path(args.data_path).resolve().parent / "inference_metrics"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"stat_{args.mode}.txt").write_text(result_str)
    (out / f"scores_{args.mode}.json").write_text(json.dumps(scores, indent=2))
    print("wrote", out / f"scores_{args.mode}.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
