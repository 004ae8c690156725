"""The NoW benchmark's images for the 3D eval; counterpart of
`e3dge_tpu/training/now_data.py` (reference `project/data/now.py:10-160`):
each picture of the NoW validation image-path list is cropped to a square
around its detected face box, scaled by SCALE, and resized to `crop_size`, with the
subject taken from its path. The reference's similarity warp has no rotation
here, so it reduces to Pillow's crop and bilinear resize, as in the JAX
package."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator

import numpy as np

# the crop's side over the face box's mean side (reference now.py)
SCALE = 1.6


class NoWDataset:
    def __init__(self, folder: str | Path, crop_size: int = 224):
        folder = Path(folder)
        lines = (folder / "imagepathsvalidation.txt").read_text().splitlines()
        self.data_lines = [line.strip() for line in lines if line.strip()]
        self.imagefolder = folder / "final_release_version" / "iphone_pictures"
        self.bbxfolder = folder / "final_release_version" / "detected_face"
        self.crop_size = crop_size

    def __len__(self):
        return len(self.data_lines)

    def __getitem__(self, index: int) -> dict:
        """{"image": [3, crop, crop] float32 in [-1, 1], "imagename", "subject"}."""
        from PIL import Image

        rel = self.data_lines[index]
        bbx = np.load(self.bbxfolder / rel.replace(".jpg", ".npy"), allow_pickle=True, encoding="latin1").item()
        left, right, top, bottom = bbx["left"], bbx["right"], bbx["top"], bbx["bottom"]
        img = Image.open(self.imagefolder / rel).convert("RGB")
        old_size = (right - left + bottom - top) / 2.0
        cx = right - (right - left) / 2.0
        cy = bottom - (bottom - top) / 2.0
        size = int(old_size * SCALE)
        box = (cx - size / 2.0, cy - size / 2.0, cx + size / 2.0, cy + size / 2.0)
        crop = img.crop(tuple(int(round(v)) for v in box)).resize((self.crop_size, self.crop_size), Image.BILINEAR)
        arr = np.asarray(crop, dtype=np.float32) / 127.5 - 1.0
        return {
            "image": arr.transpose(2, 0, 1),
            "imagename": Path(rel).stem,
            "subject": rel.split(os.sep)[0] if os.sep in rel else rel.split("/")[0],
        }

    def iter_batches(self, batch_size: int) -> Iterator[dict]:
        for s in range(0, len(self), batch_size):
            items = [self[j] for j in range(s, min(s + batch_size, len(self)))]
            yield {
                "image": np.stack([it["image"] for it in items]),
                "imagename": [it["imagename"] for it in items],
                "subject": [it["subject"] for it in items],
            }
