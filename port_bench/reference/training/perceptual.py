"""Perceptual networks: LPIPS (AlexNet) and the ArcFace identity loss —
counterpart of `e3dge_tpu/training/perceptual.py` (reference
`losses/lpips/lpips.py`, `losses/id_loss.py`, `encoders/model_irse.py`).

Module names are the reference torch keys (`net.slice{i}.{j}`,
`lin{i}.model.1.weight`; `input_layer.*`, `body.*`, `output_layer.*`), the
ones `e3dge_tpu/utils/torch_ckpt.py::ingest_perceptual` maps, so one state dict
loads into both packages. No pretrained weights are in the repository: without
state dicts the nets are seeded, as the JAX package's default is, and are then
smooth image-similarity surrogates whose values are not comparable to the
reference's numbers. The nets are frozen: gradients flow through them to the
images, never into them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.models.encoders.fpn import BatchNorm2d, BottleneckIR, Conv2d, PReLU, get_blocks
from port_bench.reference.ops.grid_sample import adaptive_avg_pool2d

# LPIPS input scaling (lpips networks.py ScalingLayer)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet `.features` split into LPIPS's five slices, each
    ending at a ReLU whose output is a tap; layers keep their torchvision
    indices (convs at 0, 3, 6, 8, 10)."""

    def __init__(self):
        super().__init__()
        convs = {0: (3, 64, 11, 4, 2), 3: (64, 192, 5, 1, 2), 6: (192, 384, 3, 1, 1),
                 8: (384, 256, 3, 1, 1), 10: (256, 256, 3, 1, 1)}
        bounds = ((0, 2), (2, 5), (5, 8), (8, 10), (10, 12))
        for s, (lo, hi) in enumerate(bounds, start=1):
            sl = nn.Sequential()
            for idx in range(lo, hi):
                if idx in convs:
                    cin, cout, k, st, p = convs[idx]
                    layer: nn.Module = Conv2d(cin, cout, k, stride=st, padding=p)
                elif idx in (2, 5):
                    layer = nn.MaxPool2d(3, stride=2)
                else:
                    layer = nn.ReLU()
                sl.add_module(str(idx), layer)
            setattr(self, f"slice{s}", sl)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for s in range(1, 6):
            x = getattr(self, f"slice{s}")(x)
            taps.append(x)
        return taps


class _NetLin(nn.Module):
    """LPIPS NetLinLayer: a 1x1 conv without bias to one channel (index 0 is
    the dropout of the reference, identity here: the nets are never trained)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """LPIPS v0.1 (alex): unit-normalised tap channels, squared difference,
    1x1 linear heads (applied raw), spatial mean, sum over taps."""

    channels: Sequence[int] = (64, 192, 384, 256, 256)

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, c in enumerate(self.channels):
            setattr(self, f"lin{i}", _NetLin(c))
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, pred: torch.Tensor, target: torch.Tensor, per_sample: bool = False) -> torch.Tensor:
        f_pred = self.net((pred - self.shift) / self.scale)
        f_tgt = self.net((target - self.shift) / self.scale)

        def normalize(f):
            # lpips/utils.py normalize_activation: 1e-8 inside the sqrt, 1e-10 on the norm
            return f / (torch.sqrt(torch.sum(f**2, dim=1, keepdim=True) + 1e-8) + 1e-10)

        total = 0.0
        for i, (fp, ft) in enumerate(zip(f_pred, f_tgt)):
            w = getattr(self, f"lin{i}").model[1].weight  # [1, C, 1, 1]
            tap = torch.sum(w * (normalize(fp) - normalize(ft)) ** 2, dim=1)  # [B, H, W]
            total = total + (tap.mean(dim=(1, 2)) if per_sample else tap.mean())
        return total


class _BatchNorm1dEval(nn.BatchNorm1d):
    """BatchNorm1d on its running statistics (model_irse.py output_layer[4])."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class ArcFaceBackbone(nn.Module):
    """IR-SE-50 face embedding (model_irse.py): 112^2 input, 512-d
    l2-normalised output."""

    def __init__(self):
        super().__init__()
        self.input_layer = nn.Sequential(Conv2d(3, 64, 3, padding=1, bias=False), BatchNorm2d(64), PReLU(64))
        self.body = nn.Sequential(*[BottleneckIR(s.in_channel, s.depth, s.stride) for s in get_blocks(50)])
        self.output_layer = nn.Sequential(
            BatchNorm2d(512), nn.Identity(), nn.Flatten(), nn.Linear(512 * 7 * 7, 512), _BatchNorm1dEval(512)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.output_layer(self.body(self.input_layer(x)))
        return h * torch.rsqrt(torch.sum(h**2, dim=-1, keepdim=True) + 1e-10)


class IDLoss(nn.Module):
    """ArcFace cosine-similarity loss with the reference's face crop (rows
    35:223, cols 32:220 of a 256 image) and AdaptiveAvgPool2d to 112^2
    (id_loss.py:20-26)."""

    def __init__(self):
        super().__init__()
        self.facenet = ArcFaceBackbone()

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        if img.shape[-1] >= 224:
            img = img[:, :, 35:223, 32:220]
        return self.facenet(adaptive_avg_pool2d(img, (112, 112)))

    def forward(self, pred: torch.Tensor, target: torch.Tensor, per_sample: bool = False):
        sim = torch.sum(self.embed(pred) * self.embed(target), dim=-1)
        if per_sample:
            return 1.0 - sim, sim
        return torch.mean(1.0 - sim), torch.mean(sim)

