"""A gallery video of inversion trajectories; counterpart of
`scripts/gallery_video.py` (reference helper_scripts/gallary_video.py): the
eval CLI's `video_frames.npy` ([B, V, 3, H, W] in [-1, 1], `python -m
e3dge_torch.eval --mode video`), optionally with a geometry render's frames
spliced into the right half of each frame (`mix_tex_geo`), tiled into one
grid per view with black padding (`tile`), played forward and, with
--bounce, back, and written by `utils/image_io.write_video` (OpenCV's mp4,
else a Pillow gif). Host code: numpy.

    python -m e3dge_torch.eval --data imgs/ --mode video --out runs/vid
    python -m e3dge_torch.tools.gallery_video --frames runs/vid/video_frames.npy --cols 4 --out gallery.mp4
"""

from __future__ import annotations

import argparse

import numpy as np


def mix_tex_geo(tex: np.ndarray, geo: np.ndarray) -> np.ndarray:
    """tex with the right half of each frame taken from geo (reference
    mix_tex_geo_vid, gallary_video.py:96-107); geo is resized to tex's size
    by nearest sampling first when the two differ."""
    if geo.shape != tex.shape:
        fy, fx = tex.shape[-2] / geo.shape[-2], tex.shape[-1] / geo.shape[-1]
        iy = (np.arange(tex.shape[-2]) / fy).astype(int).clip(0, geo.shape[-2] - 1)
        ix = (np.arange(tex.shape[-1]) / fx).astype(int).clip(0, geo.shape[-1] - 1)
        geo = geo[..., iy[:, None], ix[None, :]]
    w = tex.shape[-1]
    out = tex.copy()
    out[..., w // 2 :] = geo[..., w // 2 :]
    return out


def tile(videos: np.ndarray, cols: int) -> np.ndarray:
    """[B, V, 3, H, W] -> [V, 3, rows * H, cols * W], item b at row b // cols
    and column b % cols, the slots past B black (-1)."""
    b, v, c, h, w = videos.shape
    rows = -(-b // cols)
    grid = np.full((rows * cols, v, c, h, w), -1.0, videos.dtype)
    grid[:b] = videos
    return grid.reshape(rows, cols, v, c, h, w).transpose(2, 3, 0, 4, 1, 5).reshape(v, c, rows * h, cols * w)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m e3dge_torch.tools.gallery_video", description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", required=True, help="texture video_frames.npy [B, V, 3, H, W]")
    ap.add_argument("--geo-frames", default=None, help="geometry video_frames.npy (optional)")
    ap.add_argument("--cols", type=int, default=4)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--bounce", action="store_true", help="play the trajectory forward then back")
    ap.add_argument("--out", default="gallery.mp4")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from e3dge_torch.utils.image_io import write_video

    args = parse_args(argv)
    tex = np.load(args.frames)
    if args.geo_frames:
        tex = mix_tex_geo(tex, np.load(args.geo_frames))
    frames = tile(tex, min(args.cols, tex.shape[0]))
    if args.bounce:
        frames = np.concatenate([frames, frames[::-1]], axis=0)
    out = write_video(args.out, frames, fps=args.fps)
    print(f"wrote {out} ({frames.shape[0]} frames @ {frames.shape[-1]}x{frames.shape[-2]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
