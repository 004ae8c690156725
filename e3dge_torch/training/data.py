"""Image folders; counterpart of `e3dge_tpu/training/data.py` (reference
`project/data/dataset.py`): the training folder (MultiResolutionDatasetLMS,
:92: random horizontal flips, a 64^2 thumb, optional landmark heatmaps), the
ShapeNet renders with their pose files (MultiResolutionDataset_ShapeNet,
:328) and the numeric-name-sorted test folder (ImagesDatasetEval, :231), as
[-1, 1] float32 CHW batches read and resized by Pillow as in the JAX
package.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from e3dge_torch.parallel import mesh
from e3dge_torch.utils.trace import span

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
        Across `world`'s ranks (`parallel.mesh.World`) batch_size is the global
        batch: each rank reads only its rows of it, flipped as one process
        would flip them (the flips of the whole batch are drawn in order)."""
        order_rng = np.random.RandomState(seed)
        while True:
            order = order_rng.permutation(len(self))
            for s in range(0, len(order) - batch_size + 1, batch_size):
                with span("data.reals"):
                    rows = order[s : s + batch_size]
                    flips = self.rng.rand(batch_size) < 0.5
                    if world is not None:
                        rows, flips = mesh.shard_rows(rows, world), mesh.shard_rows(flips, world)
                    items = [self._item(int(j), f) for j, f in zip(rows, flips)]
                    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
                yield batch


class ShapeNetDataset:
    """ShapeNet renders with a pose file each (`e3dge_tpu/training/data.py:
    114`, reference MultiResolutionDataset_ShapeNet, data/dataset.py:
    328-377): a list file of image paths relative to its directory, each
    image's 4x4 camera-to-world pose at ../pose/<stem>.txt; with zero_pose
    (the reference's behaviour, dataset.py:357-359) the pose's rotation is
    the identity and its translation zero before it is inverted into the
    extrinsics. Host code: numpy arrays, no consumer on the card."""

    def __init__(self, list_file: str | Path, size: int = 256, zero_pose: bool = True):
        list_file = Path(list_file)
        self.root = list_file.parent
        self.img_paths = [self.root / line.strip() for line in list_file.read_text().splitlines() if line.strip()]
        if not self.img_paths:
            raise FileNotFoundError(f"empty ShapeNet list {list_file}")
        self.size, self.zero_pose = size, zero_pose

    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, i: int) -> dict:
        p = self.img_paths[i]
        pose = np.loadtxt(p.parent.parent / "pose" / f"{p.stem}.txt").reshape(4, 4).astype(np.float32)
        if self.zero_pose:
            pose[:3, :3] = np.eye(3)
            pose[:3, 3] = 0.0
        return {"image": load_image(p, self.size), "img_path": str(p), "poses": pose[:3, :4],
                "extrinsics": np.linalg.inv(pose)[:3, :4].astype(np.float32)}

    def iter_batches(self, batch_size: int) -> Iterator[dict]:
        """The list in order, batch_size items a batch (the last one short)."""
        for s in range(0, len(self), batch_size):
            items = [self[j] for j in range(s, min(s + batch_size, len(self)))]
            yield {"image": np.stack([it["image"] for it in items]), "img_path": [it["img_path"] for it in items],
                   "poses": np.stack([it["poses"] for it in items]),
                   "extrinsics": np.stack([it["extrinsics"] for it in items])}


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
