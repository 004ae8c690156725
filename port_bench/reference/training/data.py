"""Image folders; counterpart of `e3dge_tpu/training/data.py` (reference
`project/data/dataset.py`): the training folder (MultiResolutionDatasetLMS,
:92: random horizontal flips, a 64^2 thumb, optional landmark heatmaps), the
ShapeNet renders with their pose files (MultiResolutionDataset_ShapeNet,
:328) and the numeric-name-sorted test folder (ImagesDatasetEval, :231), as
[-1, 1] float32 CHW batches read and resized by Pillow as in the JAX
package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np


IMG_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


def _list_images(root: str | Path) -> list[Path]:
    files = [p for p in sorted(Path(root).rglob("*")) if p.suffix.lower() in IMG_EXTS]
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files


def load_image(path: str | Path, size: int) -> np.ndarray:
    """[-1, 1] float32 CHW, RGB, resized with Pillow's Hamming filter."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.HAMMING)
    arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
    return arr.transpose(2, 0, 1)


def landmark_heatmaps(lms: np.ndarray, resolution: int, sigma: float = 2.0) -> np.ndarray:
    """[N, 2] pixel-space landmarks -> [N, res, res] gaussian heatmaps (the
    intended maps of the reference's landmark branch, dataset.py:117-123);
    a landmark with a coordinate outside the image gives an all-zero map."""
    ys, xs = np.mgrid[0:resolution, 0:resolution].astype(np.float32)
    maps = np.zeros((len(lms), resolution, resolution), np.float32)
    for i, (x, y) in enumerate(np.asarray(lms, np.float32)):
        if 0 <= x < resolution and 0 <= y < resolution:
            maps[i] = np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (2.0 * sigma**2))
    return maps


class ImageFolderDataset:
    """The training folder: items {"image" [3, size, size], "thumb" [3, thumb,
    thumb] (box-filtered), and with `lms_root` (a folder of `<stem>.npy` [N, 2]
    pixel landmarks) "lms" heatmaps [N, size, size]}, image and heatmaps
    flipped together with probability 1/2. The flips come from `rng` (the JAX
    package draws them from the global numpy state)."""

    def __init__(
        self,
        root: str | Path,
        size: int = 256,
        thumb_size: int = 64,
        lms_root: str | Path | None = None,
        rng: np.random.RandomState | None = None,
    ):
        self.paths = _list_images(root)
        self.size = size
        self.thumb_size = thumb_size
        self.lms_root = Path(lms_root) if lms_root is not None else None
        self.rng = rng if rng is not None else np.random.RandomState(0)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        return self._item(i, self.rng.rand() < 0.5)

    def _item(self, i: int, flip: bool) -> dict[str, np.ndarray]:
        img = load_image(self.paths[i], self.size)
        out: dict[str, np.ndarray] = {}
        if self.lms_root is not None:
            out["lms"] = landmark_heatmaps(np.load(self.lms_root / (self.paths[i].stem + ".npy")), self.size)
        if flip:
            img = img[:, :, ::-1].copy()
            if "lms" in out:
                out["lms"] = out["lms"][:, :, ::-1].copy()
        f = self.size // self.thumb_size
        out.update(image=img, thumb=img.reshape(3, self.thumb_size, f, self.thumb_size, f).mean((2, 4)))
        return out

    def iter_batches(self, batch_size: int, seed: int, world=None) -> Iterator[dict]:
        """Endless full batches; each pass in a new order from RandomState(seed).
        One rank here: `world` is None."""
        order_rng = np.random.RandomState(seed)
        while True:
            order = order_rng.permutation(len(self))
            for s in range(0, len(order) - batch_size + 1, batch_size):
                rows = order[s : s + batch_size]
                flips = self.rng.rand(batch_size) < 0.5
                items = [self._item(int(j), f) for j, f in zip(rows, flips)]
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}

