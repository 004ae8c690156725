"""Seeded weights, made by the benchmark on the device from `--seed`.

The rules follow the port's `utils/weights.py::init_weights` (models) and
`training/perceptual.py::seed_perceptual` (the LPIPS and ArcFace nets), keyed
by class name so that they fill the port's modules and the frozen reference's
(`reference/`) alike. The draws are two large calls on one device generator
(a standard normal and a uniform block) sliced into the leaves in module
order: the same seed and module tree give the same weights on both sides.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm, nn.InstanceNorm2d)


def _names(mod: nn.Module) -> set[str]:
    return {c.__name__ for c in type(mod).__mro__}


def _model_plan(model: nn.Module) -> list[tuple]:
    """(tensor, kind, scale, shift) per leaf: kind "n" normal, "u" uniform on
    [-1, 1), "c" the constant `shift`; the leaf becomes scale * draw + shift."""
    plan = []
    for mod in model.modules():
        own = dict(mod.named_parameters(recurse=False))
        names = _names(mod)
        if "SirenLinear" in names:
            fan = mod.weight.shape[1]
            if mod.is_first:
                plan.append((mod.weight, "u", 1.0 / fan, 0.0))
            elif mod.freq_init:
                plan.append((mod.weight, "u", math.sqrt(6.0 / fan) / 25.0, 0.0))
            else:
                plan.append((mod.weight, "n", 0.25 * math.sqrt(2.0 / 1.04) / math.sqrt(fan), 0.0))
            plan.append((mod.bias, "u", math.sqrt(1.0 / fan), 0.0))
        elif "FiLMSiren" in names:
            fan = mod.weight.shape[1]
            plan.append((mod.weight, "u", 1.0 / 3.0 if mod.is_first else math.sqrt(6.0 / fan) / 25.0, 0.0))
            plan.append((mod.bias, "u", math.sqrt(1.0 / fan), 0.0))
        elif isinstance(mod, NORMS):
            plan += _norm_plan(mod)
        elif isinstance(mod, nn.PReLU):
            plan.append((mod.weight, "c", 0.0, 0.25))
        elif names & {"EqualLinear", "EqualConv2d", "ModulatedConv2d"}:
            std = 1.0 / mod.lr_mul if "EqualLinear" in names else 1.0
            plan.append((mod.weight, "n", std, 0.0))
            if own.get("bias") is not None:
                plan.append((mod.bias, "c", 0.0, float(getattr(mod, "bias_init", 0.0))))
        else:
            for name, p in own.items():
                if name == "sigmoid_beta":
                    plan.append((p, "c", 0.0, 0.1))
                elif name == "bias":
                    plan.append((p, "c", 0.0, 0.0))
                else:
                    plan.append((p, "n", 0.02, 0.0))
    return plan


def _norm_plan(mod: nn.Module) -> list[tuple]:
    plan = []
    if mod.weight is not None:
        plan += [(mod.weight, "c", 0.0, 1.0), (mod.bias, "c", 0.0, 0.0)]
    if getattr(mod, "running_mean", None) is not None:
        plan += [(mod.running_mean, "c", 0.0, 0.0), (mod.running_var, "c", 0.0, 1.0)]
    return plan


def _perceptual_plan(net: nn.Module) -> list[tuple]:
    plan = []
    for name, mod in net.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            if name.startswith("lin"):
                plan.append((mod.weight, "c", 0.0, 1.0))
                continue
            plan.append((mod.weight, "n", 1.0 / math.sqrt(math.prod(mod.weight.shape[1:])), 0.0))
            if mod.bias is not None:
                plan.append((mod.bias, "c", 0.0, 0.0))
        elif isinstance(mod, NORMS):
            plan += _norm_plan(mod)
        elif isinstance(mod, nn.PReLU):
            plan.append((mod.weight, "c", 0.0, 0.25))
    return plan


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of `seed` (numpy's SeedSequence)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def _fill(plan: list[tuple], seed: int) -> None:
    device = plan[0][0].device
    gen = torch.Generator(device).manual_seed(seed)
    sizes = {k: sum(t.numel() for t, kind, _, _ in plan if kind == k) for k in ("n", "u")}
    draws = {"n": torch.randn(sizes["n"], generator=gen, device=device),
             "u": torch.rand(sizes["u"], generator=gen, device=device) * 2 - 1}
    at = {"n": 0, "u": 0}
    for t, kind, scale, shift in plan:
        if kind == "c":
            t.fill_(shift)
            continue
        n = t.numel()
        t.copy_(draws[kind][at[kind]:at[kind] + n].view(t.shape) * scale + shift)
        at[kind] += n


def seed_model_(model: nn.Module, seed: int) -> None:
    """Fill a model (E3DGE, a Discriminator) by the model rules."""
    _fill(_model_plan(model), seed)


def seed_perceptual_(net: nn.Module, seed: int) -> None:
    """Fill a perceptual net (LPIPS, ArcFace) by the perceptual rules."""
    _fill(_perceptual_plan(net), seed)
