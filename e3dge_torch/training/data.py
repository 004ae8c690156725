"""Evaluation image folders; counterpart of `e3dge_tpu/training/data.py:25-50,
159-178` (reference `project/data/dataset.py` ImagesDatasetEval, :231):
numeric-name-sorted test images as [-1, 1] float32 CHW batches, read and
resized by Pillow as in the JAX package.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

IMG_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


def _list_images(root: str | Path) -> list[Path]:
    files = [p for p in sorted(Path(root).rglob("*")) if p.suffix.lower() in IMG_EXTS]
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files


def _numeric_sort(paths: Sequence[Path]) -> list[Path]:
    def key(p: Path):
        m = re.findall(r"\d+", p.stem)
        return (int(m[0]) if m else 0, p.stem)

    return sorted(paths, key=key)


def load_image(path: str | Path, size: int) -> np.ndarray:
    """[-1, 1] float32 CHW, RGB, resized with Pillow's Hamming filter."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.HAMMING)
    arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
    return arr.transpose(2, 0, 1)


class EvalImageDataset:
    """CelebA-HQ-style test split: numeric-sorted, returns image + path."""

    def __init__(self, root: str | Path, size: int = 256):
        self.paths = _numeric_sort(_list_images(root))
        self.size = size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> dict:
        return {"image": load_image(self.paths[i], self.size), "img_path": str(self.paths[i])}

    def iter_batches(self, batch_size: int) -> Iterator[dict]:
        for s in range(0, len(self), batch_size):
            items = [self[j] for j in range(s, min(s + batch_size, len(self)))]
            yield {
                "image": np.stack([it["image"] for it in items]),
                "img_path": [it["img_path"] for it in items],
            }
