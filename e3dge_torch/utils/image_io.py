"""Image files of the port: image grids, comparison panels and trajectory
videos, through Pillow and OpenCV; counterpart of `e3dge_tpu/utils/image_io.py`
(reference save_image panels, trainer.py:269-283, 502-510).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] CHW float -> HWC uint8."""
    img = np.clip((np.asarray(img) + 1.0) / 2.0, 0.0, 1.0)
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


def save_image_grid(path: str | os.PathLike, images: np.ndarray, nrow: int | None = None) -> None:
    """images: [N, 3, H, W] in [-1, 1] -> one PNG grid with `nrow` images per row."""
    from PIL import Image

    n = len(images)
    nrow = nrow or n
    ncol = -(-n // nrow)
    h, w = images.shape[2], images.shape[3]
    grid = np.zeros((ncol * h, nrow * w, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, nrow)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = to_uint8(img)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(grid).save(path)


def write_video(path: str | os.PathLike, frames: np.ndarray, fps: int = 30) -> Path:
    """frames: [T, 3, H, W] in [-1, 1] (or [T, H, W, 3] uint8) -> .mp4 by
    OpenCV's mp4v codec, else an animated .gif by Pillow. Returns the path
    written (its suffix follows the writer)."""
    frames = np.asarray(frames)
    if frames.ndim == 4 and frames.shape[1] == 3 and frames.dtype != np.uint8:
        frames = np.stack([to_uint8(f) for f in frames])
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import cv2

        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if vw.isOpened():
            for f in frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            vw.release()
            return path
    except ImportError:
        pass
    from PIL import Image

    path = path.with_suffix(".gif")
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=int(1000 / fps), loop=0)
    return path


def save_panel(path: str | os.PathLike, rows: dict[str, np.ndarray], size: int | None = None) -> None:
    """Reference-style comparison panel: one column per key (e.g. GT, thumb rec,
    residual, aligned residual, E1 rec), one row per batch item. All images are
    resized (nearest) to the largest height present unless `size` given."""
    mats = list(rows.values())
    size = size or max(m.shape[-1] for m in mats)

    def up(m):
        f = size // m.shape[-1]
        if f > 1:
            m = np.repeat(np.repeat(m, f, axis=2), f, axis=3)
        return m

    panel = np.concatenate([up(np.asarray(m)) for m in mats], axis=3)  # side by side per item
    save_image_grid(path, panel, nrow=1)
