"""Weights for the port: the JAX package's variables carried across, and seeded
weights for runs without JAX.

`state_dicts_from_jax` is the port's own copy of the naming rules of
`e3dge_tpu/utils/torch_ckpt.py::flax_path_to_torch` for the modules of the
inversion path, inverted: each flax leaf goes to its reference torch key, with
HWIO conv kernels -> OIHW and flax Dense kernels [in, out] -> [out, in]. The
result loads into the port's modules with `load_state_dict(strict=True)`, and
`torch_ckpt.ingest_variables` of it gives back the JAX leaves exactly.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

TOPS = ("encoder", "generator", "local", "grid_align", "fuse_sft_block", "volume_discriminator")

Rule = tuple[str, Callable[[np.ndarray], np.ndarray]]


def _id(w):
    return np.asarray(w)


def _hwio_to_oihw(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def _dense_to_torch(w):  # flax Dense kernel [in, out] -> torch [out, in]
    return np.asarray(w).transpose(1, 0)


def _bias4_to_vec(w):  # [1, C, 1, 1] -> [C]
    return np.asarray(w).reshape(-1)


def _conv(prefix: str) -> dict[str, Rule]:
    return {"conv/kernel": (f"{prefix}.weight", _hwio_to_oihw), "conv/bias": (f"{prefix}.bias", _id)}


def _bn(prefix: str) -> dict[str, Rule]:
    return {
        "bn/scale": (f"{prefix}.weight", _id),
        "bn/bias": (f"{prefix}.bias", _id),
        "bn/mean": (f"{prefix}.running_mean", _id),
        "bn/var": (f"{prefix}.running_var", _id),
    }


def _bottleneck(tp: str, se: bool) -> dict[str, Rule]:
    rules: dict[str, Rule] = {}
    for ours, theirs in (("shortcut_conv", "shortcut_layer.0"), ("conv1", "res_layer.1"), ("conv2", "res_layer.3")):
        rules.update({f"{ours}/{k}": v for k, v in _conv(f"{tp}.{theirs}").items()})
    for ours, theirs in (("shortcut_bn", "shortcut_layer.1"), ("bn1", "res_layer.0"), ("bn2", "res_layer.4")):
        rules.update({f"{ours}/{k}": v for k, v in _bn(f"{tp}.{theirs}").items()})
    rules["prelu/alpha"] = (f"{tp}.res_layer.2.weight", _id)
    if se:
        rules["se/fc1/conv/kernel"] = (f"{tp}.res_layer.5.fc1.weight", _hwio_to_oihw)
        rules["se/fc2/conv/kernel"] = (f"{tp}.res_layer.5.fc2.weight", _hwio_to_oihw)
    return rules


def _encoder_rule(rel: str) -> Rule | None:
    m = re.match(r"body_(\d+)/(.+)", rel)
    if m:
        return _bottleneck(f"body.{m.group(1)}", se=True).get(m.group(2))
    if rel.startswith("input_conv/"):
        return _conv("input_layer.0").get(rel.split("/", 1)[1])
    if rel.startswith("input_bn/"):
        return _bn("input_layer.1").get(rel.split("/", 1)[1])
    if rel == "input_prelu/alpha":
        return ("input_layer.2.weight", _id)
    m = re.match(r"(latlayer\d+)/(.+)", rel)
    if m:
        return _conv(m.group(1)).get(m.group(2))
    m = re.match(r"styles_(pigan|stylegan)_(\d+)/(.+)", rel)
    if m:
        base, sub = f"styles_{m.group(1)}.{m.group(2)}", m.group(3)
        mc = re.match(r"convs_(\d+)/(.+)", sub)
        if mc:  # Sequential(conv, lrelu, conv, ...): conv i at index 2i
            return _conv(f"{base}.convs.{2 * int(mc.group(1))}").get(mc.group(2))
        if sub in ("linear/weight", "linear/bias"):
            return (f"{base}.{sub.replace('/', '.')}", _id)
    return None


def _generator_rule(rel: str) -> Rule | None:
    m = re.match(r"style/style_(\d+)/(weight|bias)", rel)
    if m:
        return (f"style.{m.group(1)}.{m.group(2)}", _id)
    if rel == "renderer/sigmoid_beta":
        return ("renderer.sigmoid_beta", _id)
    m = re.match(r"renderer/network/(pts_linears_(\d+)|views_linears|rgb_linear|sigma_linear)/(.+)", rel)
    if m:
        layer = f"pts_linears.{m.group(2)}" if m.group(2) is not None else m.group(1)
        return (f"renderer.network.{layer}.{m.group(3).replace('/', '.')}", _id)
    m = re.match(r"decoder/style/style_(\d+)/(weight|bias)", rel)
    if m:  # Sequential(PixelNorm, EqualLinear x5): index + 1
        return (f"decoder.style.{int(m.group(1)) + 1}.{m.group(2)}", _id)
    m = re.match(r"decoder/(conv1|convs_(\d+)|to_rgb1|to_rgbs_(\d+))/(.+)", rel)
    if m:
        name = m.group(1)
        if m.group(2) is not None:
            name = f"convs.{m.group(2)}"
        elif m.group(3) is not None:
            name = f"to_rgbs.{m.group(3)}"
        tail, base = m.group(4), f"decoder.{name}"
        if tail == "bias":  # StyledConv: the activation's bias; ToRGB: its own [1, 3, 1, 1]
            return (f"{base}.bias", _id) if "rgb" in name else (f"{base}.activate.bias", _bias4_to_vec)
        if tail in ("conv/weight", "conv/modulation/weight", "conv/modulation/bias", "noise/weight"):
            return (f"{base}.{tail.replace('/', '.')}", _id)
    return None


def _volume_d_rule(rel: str) -> Rule | None:
    table = {
        "convs_0/conv/conv/kernel": ("convs.0.conv.weight", _hwio_to_oihw),
        "convs_0/act_bias": ("convs.0.activation.bias", _id),
        "final_conv/conv/conv/kernel": ("final_conv.conv.weight", _hwio_to_oihw),
        "final_conv/conv/conv/bias": ("final_conv.conv.bias", _id),
    }
    if rel in table:
        return table[rel]
    m = re.match(r"convs_(\d+)/(conv1|conv2|skip)/(.+)", rel)
    if m and int(m.group(1)) > 0:
        base, tail = f"convs.{m.group(1)}.{m.group(2)}", m.group(3)
        sub = {
            "conv/conv/kernel": (f"{base}.conv.conv.weight", _hwio_to_oihw),
            "act_bias": (f"{base}.activation.bias", _id),
        } if m.group(2) != "skip" else {
            "conv/conv/kernel": (f"{base}.conv.weight", _hwio_to_oihw),
            "conv/conv/bias": (f"{base}.conv.bias", _id),
        }
        return sub.get(tail)
    return None


def _convblock_rule(tp: str, sub: str) -> Rule | None:
    m = re.match(r"conv([123])/(.+)", sub)
    if m:
        return _conv(f"{tp}.conv{m.group(1)}").get(m.group(2))
    m = re.match(r"bn([1234])/(scale|bias)", sub)
    if m:
        return (f"{tp}.bn{m.group(1)}.{'weight' if m.group(2) == 'scale' else 'bias'}", _id)
    if sub.startswith("downsample_conv/"):
        return _conv(f"{tp}.downsample.2").get(sub.split("/", 1)[1])
    return None


def _hgfilter_rule(tp: str, sub: str) -> Rule | None:
    if sub.startswith("conv1/"):
        return _conv(f"{tp}.conv1").get(sub.split("/", 1)[1])
    m = re.match(r"(bn1|bn_end\d+)/(scale|bias)", sub)
    if m:
        return (f"{tp}.{m.group(1)}.{'weight' if m.group(2) == 'scale' else 'bias'}", _id)
    m = re.match(r"(conv[234]|top_m_\d+)/(.+)", sub)
    if m:
        return _convblock_rule(f"{tp}.{m.group(1)}", m.group(2))
    m = re.match(r"m(\d+)/(b\d_(?:plus_)?\d+)/(.+)", sub)
    if m:
        return _convblock_rule(f"{tp}.m{m.group(1)}.{m.group(2)}", m.group(3))
    m = re.match(r"(conv_last\d+|l\d+|bl\d+|al\d+)/(.+)", sub)
    if m:
        return _conv(f"{tp}.{m.group(1)}").get(m.group(2))
    return None


def _local_rule(rel: str) -> Rule | None:
    m = re.match(r"(residual_conv|depth_conv)/(.+)", rel)
    if m:
        n = m.group(1)
        return {
            "conv_in/conv/kernel": (f"{n}.0.weight", _hwio_to_oihw),
            "rb_norm1/scale": (f"{n}.1.conv.0.weight", _id),
            "rb_norm1/bias": (f"{n}.1.conv.0.bias", _id),
            "rb_conv1/conv/kernel": (f"{n}.1.conv.2.weight", _hwio_to_oihw),
            "rb_norm2/scale": (f"{n}.1.conv.3.weight", _id),
            "rb_norm2/bias": (f"{n}.1.conv.3.bias", _id),
            "rb_conv2/conv/kernel": (f"{n}.1.conv.5.weight", _hwio_to_oihw),
            "conv_out/conv/kernel": (f"{n}.2.weight", _hwio_to_oihw),
        }.get(m.group(2))
    m = re.match(r"image_filter/(.+)", rel)
    if m:
        return _hgfilter_rule("image_filter", m.group(1))
    m = re.match(r"local_feat_to_tex_modulations/(fc_0|fc_1|shortcut)_(weight|bias)", rel)
    if m:
        return (f"local_feat_to_tex_modulations_linear.{m.group(1)}.{m.group(2)}", _id)
    return None


def _grid_align_rule(rel: str) -> Rule | None:
    if rel.startswith("conv_layer1_conv/"):
        return _conv("conv_layer1.0").get(rel.split("/", 1)[1])
    if rel.startswith("conv_layer1_bn/"):
        return _bn("conv_layer1.1").get(rel.split("/", 1)[1])
    if rel == "conv_layer1_prelu/alpha":
        return ("conv_layer1.2.weight", _id)
    m = re.match(r"(d?conv_layer\d)_(\d)/(.+)", rel)
    if m:
        return _bottleneck(f"{m.group(1)}.{m.group(2)}", se=False).get(m.group(3))
    return None


def _fuse_sft_rule(rel: str) -> Rule | None:
    m = re.match(r"encode_enc/(fc_0|fc_1|shortcut)_(weight|bias)", rel)
    if m:
        return (f"encode_enc.{m.group(1)}.{m.group(2)}", _id)
    m = re.match(r"(scale|shift)_([02])/(kernel|bias)", rel)
    if m:
        key = f"{m.group(1)}.{m.group(2)}.{'weight' if m.group(3) == 'kernel' else 'bias'}"
        return (key, _dense_to_torch if m.group(3) == "kernel" else _id)
    return None


_RULES = {
    "encoder": _encoder_rule,
    "generator": _generator_rule,
    "volume_discriminator": _volume_d_rule,
    "local": _local_rule,
    "grid_align": _grid_align_rule,
    "fuse_sft_block": _fuse_sft_rule,
}


def jax_path_to_torch(path: str) -> tuple[str, Rule] | None:
    """'params/encoder/body_3/conv1/conv/kernel' -> ('encoder', (torch key, transform))."""
    parts = path.split("/")
    top, rel = parts[1], "/".join(parts[2:])
    fn = _RULES.get(top)
    rule = fn(rel) if fn else None
    return None if rule is None else (top, rule)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def state_dicts_from_jax(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's E3DGE `variables` (nested dicts of arrays: 'params',
    'batch_stats') -> one torch state_dict per top module of `TOPS`. Raises on a
    leaf it cannot map. BatchNorm's `num_batches_tracked` is added as 0, and
    the hourglass' shared `downsample.0` norm repeats `bn4`, as in a reference
    state dict."""
    sds: dict[str, dict[str, torch.Tensor]] = {t: {} for t in TOPS}
    unmapped = []
    for path, value in _flatten(variables).items():
        mapped = jax_path_to_torch(path)
        if mapped is None:
            unmapped.append(path)
            continue
        top, (key, transform) = mapped
        sds[top][key] = torch.from_numpy(np.array(transform(np.asarray(value, np.float32)), dtype=np.float32))
    if unmapped:
        raise KeyError(f"{len(unmapped)} JAX leaves without a torch key, e.g. {unmapped[:5]}")
    for sd in sds.values():
        for key in list(sd):
            if key.endswith(".running_mean"):
                sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
            m = re.match(r"(.+)\.bn4\.(weight|bias)$", key)
            if m:
                sd[f"{m.group(1)}.downsample.0.{m.group(2)}"] = sd[key]
    return sds


def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Load the JAX variables into an `E3DGE` port model, strictly per module."""
    for top, sd in state_dicts_from_jax(variables).items():
        getattr(model, top).load_state_dict(sd, strict=True)


_NORMS = (nn.BatchNorm2d, nn.GroupNorm, nn.InstanceNorm2d)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded weights for runs without JAX, modelled on
    `__graft_entry__.fast_init`: norms get scale 1, shift 0, running mean 0 and
    variance 1; PReLU slopes 0.25; `sigmoid_beta` 0.1; the SIREN layers their
    own SIREN inits (with 0.02 * N(0, 1) weights and FiLM gains ~30 the field's
    per-layer gain is ~10 and its output chaotic in the last bits of its input);
    equalized-lr layers (EqualLinear, EqualConv2d, ModulatedConv2d)
    unit-variance weights over their lr multiplier and their own bias init, as
    their runtime scale expects; every other weight 0.02 * N(0, 1) and bias 0.
    Everything is drawn on the CPU from one generator in module order, so the
    weights do not depend on the device."""
    from e3dge_torch.models.layers import EqualConv2d, EqualLinear, ModulatedConv2d
    from e3dge_torch.models.siren import FiLMSiren, SirenLinear

    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        own = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, (FiLMSiren, SirenLinear)):
            mod.reset_parameters(gen)
        elif isinstance(mod, _NORMS):
            if mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            if getattr(mod, "running_mean", None) is not None:
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
        elif isinstance(mod, (EqualLinear, EqualConv2d, ModulatedConv2d)):
            std = 1.0 / mod.lr_mul if isinstance(mod, EqualLinear) else 1.0
            mod.weight.copy_(std * torch.randn(mod.weight.shape, generator=gen))
            if own.get("bias") is not None:
                mod.bias.fill_(getattr(mod, "bias_init", 0.0))
        else:
            for name, p in own.items():
                if name == "sigmoid_beta":
                    p.fill_(0.1)
                elif name == "bias":
                    p.zero_()
                else:
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen))
