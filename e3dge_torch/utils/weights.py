"""Weights for the port: the JAX package's variables carried across, and seeded
weights for runs without JAX.

`state_dicts_from_jax` is the port's own copy of the naming rules of
`e3dge_tpu/utils/torch_ckpt.py::flax_path_to_torch` for the modules of the
inversion path, inverted: each flax leaf goes to its reference torch key, with
HWIO conv kernels -> OIHW and flax Dense kernels [in, out] -> [out, in]. The
result loads into the port's modules with `load_state_dict(strict=True)`, and
`torch_ckpt.ingest_variables` of it gives back the JAX leaves exactly.
`batch_stats_to_jax` carries the BatchNorm running statistics back into a JAX
`batch_stats` layout, `discriminator_state_dict_from_jax` carries the
full-resolution `Discriminator` (its own variables in the JAX package) by the
rules of `flax_path_to_torch`'s "discriminator" branch, and
`perceptual_state_dict_from_jax` carries the JAX package's perceptual nets
(LPIPS, the ArcFace of IDLoss) across by the rules of
`torch_ckpt.lpips_path_to_torch` / `arcface_path_to_torch`, inverted.
`siren_state_dict_from_jax`, `encoder_state_dict_from_jax` (every
`set_encoder` name: `flax_path_to_torch`'s encoder, volume-D and D rules
inverted, and the port's own for DEncoder's heads and FullEncoder's halves)
and `align_state_dict_from_jax` (the align ablation blocks, the port's own
rules) carry standalone JAX modules across.
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


def _dense_to_conv1d(w):  # flax Dense kernel [in, out] -> torch Conv1d [out, in, 1]
    return np.asarray(w).transpose(1, 0)[:, :, None]


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
    rel = rel.removeprefix("backbone/")  # the variant encoders' IR trunk (variants.py::_IRBackbone)
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
    # styles_pigan.i / styles_stylegan.i (the V2 encoder and e4e's pigan rows),
    # plain styles.i (e4e's and ReStyle's decoder rows), thumb_styles.i (ReStyle's pigan rows)
    m = re.match(r"(styles_pigan|styles_stylegan|styles|thumb_styles)_(\d+)/(.+)", rel)
    if m:
        base, sub = f"{m.group(1)}.{m.group(2)}", m.group(3)
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
        # VolumeRenderDiscriminatorEncoder's W+ head (stylesdf_model.py:1429-1430)
        "wplus_latents_pred_conv/conv/conv/kernel": ("wplus_latents_pred_conv.conv.weight", _hwio_to_oihw),
        "wplus_latents_pred_conv/conv/conv/bias": ("wplus_latents_pred_conv.conv.bias", _id),
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


def _context_conv_rule(n: str, sub: str) -> Rule | None:
    """A context conv (`pifu/local_net.py::context_conv`) under torch name n."""
    table = {
        "conv_in/conv/kernel": (f"{n}.0.weight", _hwio_to_oihw),
        # InstanceNorm (the resnetfc variant)
        "rb_norm1/scale": (f"{n}.1.conv.0.weight", _id),
        "rb_norm1/bias": (f"{n}.1.conv.0.bias", _id),
        "rb_conv1/conv/kernel": (f"{n}.1.conv.2.weight", _hwio_to_oihw),
        "rb_norm2/scale": (f"{n}.1.conv.3.weight", _id),
        "rb_norm2/bias": (f"{n}.1.conv.3.bias", _id),
        "rb_conv2/conv/kernel": (f"{n}.1.conv.5.weight", _hwio_to_oihw),
        "conv_out/conv/kernel": (f"{n}.2.weight", _hwio_to_oihw),
    }
    # BatchNorm parameters and running statistics (the "bn" variant)
    for ours, theirs in (("rb_norm1", f"{n}.1.conv.0"), ("rb_norm2", f"{n}.1.conv.3")):
        table.update({f"{ours}/{k}": v for k, v in _bn(theirs).items()})
    return table.get(sub)


def _local_rule(rel: str) -> Rule | None:
    m = re.match(r"(residual_conv|depth_conv)/(.+)", rel)
    if m:
        return _context_conv_rule(m.group(1), m.group(2))
    m = re.match(r"image_filter/(.+)", rel)
    if m:
        return _hgfilter_rule("image_filter", m.group(1))
    # the texture head: ResnetBlockFC (resnetfc) or EqualLinear (bn); the
    # geometry head, EqualLinear
    m = re.match(r"local_feat_to_tex_modulations/(fc_0|fc_1|shortcut)_(weight|bias)", rel)
    if m:
        return (f"local_feat_to_tex_modulations_linear.{m.group(1)}.{m.group(2)}", _id)
    m = re.match(r"local_feat_to_(tex|geo)_modulations/(weight|bias)", rel)
    if m:
        return (f"local_feat_to_{m.group(1)}_modulations_linear.{m.group(2)}", _id)
    m = re.match(r"surface_classifier/conv(\d)/(kernel|bias)", rel)
    if m:  # flax Dense [in, out] -> the reference's Conv1d [out, in, 1]
        if m.group(2) == "kernel":
            return (f"surface_classifier.conv{m.group(1)}.weight", _dense_to_conv1d)
        return (f"surface_classifier.conv{m.group(1)}.bias", _id)
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


def batch_stats_to_jax(model: nn.Module, template: dict) -> dict:
    """The BatchNorm running statistics of an `E3DGE` port model as numpy
    leaves in the layout of a JAX `batch_stats` tree (`template`, e.g.
    variables["batch_stats"] or a part of it under its top modules)."""
    sds = {top: getattr(model, top).state_dict() for top in TOPS if hasattr(model, top)}

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, path)
                continue
            top, (key, transform) = jax_path_to_torch(path)
            if transform is not _id:
                raise KeyError(f"{path} is not a running statistic")
            out[k] = sds[top][key].detach().float().cpu().numpy()
        return out

    return walk(template, "batch_stats")


_DISC_TABLE = {
    "convs_0/conv/weight": "convs.0.0.weight",
    "convs_0/bias": "convs.0.1.bias",
    "final_conv/conv/weight": "final_conv.0.weight",
    "final_conv/bias": "final_conv.1.bias",
    "final_linear_0/weight": "final_linear.0.weight",
    "final_linear_0/bias": "final_linear.0.bias",
    "final_linear_1/weight": "final_linear.1.weight",
    "final_linear_1/bias": "final_linear.1.bias",
}
# DiscResBlock: ConvLayer Sequentials, the downsampling ones behind a blur (index 0)
_DISC_BLOCK = {
    "conv1/conv/weight": "conv1.0.weight",
    "conv1/bias": "conv1.1.bias",
    "conv2/conv/weight": "conv2.1.weight",
    "conv2/bias": "conv2.2.bias",
    "skip/conv/weight": "skip.1.weight",
}


def _discriminator_rule(rel: str) -> str | None:
    rel = rel.removeprefix("trunk/")  # the D-backbone encoders' trunk (factory.py::_SG2Trunk)
    if rel in _DISC_TABLE:
        return _DISC_TABLE[rel]
    m = re.match(r"convs_(\d+)/(.+)", rel)
    if m and int(m.group(1)) > 0 and m.group(2) in _DISC_BLOCK:
        return f"convs.{m.group(1)}.{_DISC_BLOCK[m.group(2)]}"
    return None


def discriminator_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX `Discriminator`'s params (its `variables["params"]`) -> the
    port's `Discriminator` state dict (the layouts are torch's on both
    sides). Raises on a leaf it cannot map."""
    sd = {}
    for rel, value in _flatten(params).items():
        key = _discriminator_rule(rel)
        if key is None:
            raise KeyError(f"discriminator: no torch key for {rel}")
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd


_LPIPS_TV = {0: (1, 0), 1: (2, 3), 2: (3, 6), 3: (4, 8), 4: (5, 10)}  # conv i -> (slice, torchvision index)


def _lpips_rule(rel: str) -> Rule | None:
    m = re.match(r"net/conv(\d)/conv/(kernel|bias)", rel)
    if m:
        s, idx = _LPIPS_TV[int(m.group(1))]
        kernel = m.group(2) == "kernel"
        return (f"net.slice{s}.{idx}.{'weight' if kernel else 'bias'}", _hwio_to_oihw if kernel else _id)
    m = re.match(r"lin(\d)_weight", rel)
    return (f"lin{m.group(1)}.model.1.weight", _id) if m else None


def _arcface_rule(rel: str) -> Rule | None:
    table = {
        "output_weight": ("output_layer.3.weight", _id),
        "output_bias": ("output_layer.3.bias", _id),
        "output_bn1d/scale": ("output_layer.4.weight", _id),
        "output_bn1d/bias": ("output_layer.4.bias", _id),
        "output_bn1d/mean": ("output_layer.4.running_mean", _id),
        "output_bn1d/var": ("output_layer.4.running_var", _id),
    }
    if rel in table:
        return table[rel]
    if rel.startswith("output_bn/"):
        return _bn("output_layer.0").get(rel.split("/", 1)[1])
    return _encoder_rule(rel)  # input_layer.* and body.* as in E0


def perceptual_state_dict_from_jax(variables: dict, kind: str) -> dict[str, torch.Tensor]:
    """The JAX package's LPIPS variables (kind "lpips") or IDLoss variables
    (kind "arcface": the ArcFace under `facenet`) -> the state dict of the
    port's `LPIPS` / `ArcFaceBackbone`, the reference torch keys. Raises on a
    leaf it cannot map."""
    rule_fn = {"lpips": _lpips_rule, "arcface": _arcface_rule}[kind]
    sd = {}
    for path, value in _flatten(variables).items():
        parts = path.split("/")
        rel = "/".join(parts[2 if kind == "arcface" else 1:])  # past the collection (and facenet)
        rule = rule_fn(rel)
        if rule is None:
            raise KeyError(f"{kind}: no torch key for {path}")
        key, transform = rule
        sd[key] = torch.from_numpy(np.array(transform(np.asarray(value, np.float32)), dtype=np.float32))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _state_dict_by_rule(variables: dict, rule: Callable[[str], Rule | None], what: str) -> dict[str, torch.Tensor]:
    """A standalone JAX module's variables (nested dicts of arrays under
    'params' and, with BatchNorm, 'batch_stats') -> its torch state dict by
    `rule` (a leaf's path past the collection -> (torch key, transform)).
    Raises on a leaf it cannot map; BatchNorm's `num_batches_tracked` is
    added as 0."""
    sd, unmapped = {}, []
    for path, value in _flatten(variables).items():
        r = rule(path.split("/", 1)[1])
        if r is None:
            unmapped.append(path)
            continue
        key, transform = r
        sd[key] = torch.from_numpy(np.array(transform(np.asarray(value, np.float32)), dtype=np.float32))
    if unmapped:
        raise KeyError(f"{what}: {len(unmapped)} JAX leaves without a torch key, e.g. {unmapped[:5]}")
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def siren_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """A standalone JAX `SirenGenerator`'s variables -> the port's
    `SirenGenerator` state dict (the generator's renderer.network rules)."""
    def rule(rel):
        r = _generator_rule(f"renderer/network/{rel}")
        return None if r is None else (r[0].removeprefix("renderer.network."), r[1])

    return _state_dict_by_rule(variables, rule, "SirenGenerator")


def _disc_rule(rel: str) -> Rule | None:
    key = _discriminator_rule(rel)
    return None if key is None else (key, _id)


def _d_encoder_rule(rel: str) -> Rule | None:
    # DEncoder's downsampling ConvLayer heads (blur 0, conv 1, activation 2)
    m = re.match(r"(renderer|stylegan)_latents_conv/(conv/weight|bias)", rel)
    if m:
        return (f"{m.group(1)}_latents_conv.{'1.weight' if m.group(2) == 'conv/weight' else '2.bias'}", _id)
    return _disc_rule(rel)


def _prefixed(prefix: str, rule: Callable[[str], Rule | None]) -> Callable[[str], Rule | None]:
    def r(rel):
        if not rel.startswith(f"{prefix}/"):
            return None
        got = rule(rel[len(prefix) + 1:])
        return None if got is None else (f"{prefix}.{got[0]}", got[1])
    return r


def _full_encoder_rule(rel: str) -> Rule | None:
    return _prefixed("renderer_encoder", _volume_d_rule)(rel) or _prefixed("stylegan_encoder", _disc_rule)(rel)


# set_encoder's names -> the rule of their leaves: torch_ckpt.flax_path_to_torch's
# "encoder" (the IR trunk family), "volume_discriminator" (the volume-D
# encoders) and "discriminator" (StyleGANEncoder, under "trunk/") branches,
# inverted; DEncoder's heads and FullEncoder's two halves have no rule there
ENCODER_RULES = {
    "HybridGradualStyleEncoder_V2": _encoder_rule,
    "HybridBackboneEncoder": _encoder_rule,
    "BackboneEncoderRenderer": _encoder_rule,
    "Encoder4Editing": _encoder_rule,
    "Encoder4EditingHybridBaseline": _encoder_rule,
    "VolumeRenderDiscriminatorEncoder": _volume_d_rule,
    "VolumeStyleEncoder": _volume_d_rule,
    "StyleGANEncoder": _disc_rule,
    "DEncoder": _d_encoder_rule,
    "FullEncoder": _full_encoder_rule,
}


def encoder_state_dict_from_jax(encoder_type: str, variables: dict) -> dict[str, torch.Tensor]:
    """The variables of the JAX `set_encoder(encoder_type, ...)` module ->
    the state dict of the port's `encoders.factory.set_encoder(encoder_type,
    ...)`, loadable with strict=True. Raises on a leaf it cannot map."""
    return _state_dict_by_rule(variables, ENCODER_RULES[encoder_type], encoder_type)


def _residual_encoder_rule(rel: str) -> Rule | None:
    m = re.match(r"condition_(scale|shift)3_([02])/(weight|bias)", rel)
    if m:  # Sequential(EqualConv2d, ScaledLeakyReLU, EqualConv2d)
        return (f"condition_{m.group(1)}3.{m.group(2)}.{m.group(3)}", _id)
    return _grid_align_rule(rel)  # conv_layer1 and the bottleneck stages, as the ADA aligner's


def _feature_aligner_rule(rel: str) -> Rule | None:
    m = re.match(r"(residual_conv|depth_conv|que_thumb_conv)/(.+)", rel)
    if m:
        return _context_conv_rule(m.group(1), m.group(2))
    if rel == "downsample_channel_conv/conv/kernel":
        return ("downsample_channel_conv.weight", _hwio_to_oihw)
    return _grid_align_rule(rel)  # conv_layer1 and the bottleneck stages, as the ADA aligner's


def _group_norm_convs_rule(rel: str) -> Rule | None:
    """ConvResBlock / ResidualConvBlock: GroupNorms norm1, norm2 (flax scale,
    bias) and convs conv1, conv2, conv_out, short_cut."""
    m = re.match(r"(norm[12])/(scale|bias)", rel)
    if m:
        return (f"{m.group(1)}.{'weight' if m.group(2) == 'scale' else 'bias'}", _id)
    m = re.match(r"(conv[12]|conv_out|short_cut)/(.+)", rel)
    return _conv(m.group(1)).get(m.group(2)) if m else None


def _fuse_sft_block_rule(rel: str) -> Rule | None:
    m = re.match(r"(scale|shift)_([02])/(.+)", rel)
    if m:  # Sequential(conv, LeakyReLU, conv)
        return _conv(f"{m.group(1)}.{m.group(2)}").get(m.group(3))
    return _prefixed("encode_enc", _group_norm_convs_rule)(rel)


# the align ablation blocks: no rule in torch_ckpt; the port's own, the
# reference's torch names (alignment_old.py, sft.py, helpers.py)
ALIGN_RULES = {
    "ResidualEncoder": _residual_encoder_rule,
    "FeatureAligner": _feature_aligner_rule,
    "DemodulatedConv2d": lambda rel: (rel, _id) if rel in ("weight", "bias") else None,
    "ConvResBlock": _group_norm_convs_rule,
    "FuseSftBlock": _fuse_sft_block_rule,
    "ResidualConvBlock": _group_norm_convs_rule,
    "AlignInpainterFusionBlock": _prefixed("fusionBlock", _group_norm_convs_rule),
}


def align_state_dict_from_jax(block: str, variables: dict) -> dict[str, torch.Tensor]:
    """The variables of a JAX `models/align.py` ablation block (`ALIGN_RULES`'
    names) -> the state dict of the port's block of that name, loadable with
    strict=True. Raises on a leaf it cannot map."""
    return _state_dict_by_rule(variables, ALIGN_RULES[block], block)


def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Load the JAX variables into an `E3DGE` port model, strictly per module
    (a module that neither side has, as the local branch of a global-only
    model, is skipped)."""
    for top, sd in state_dicts_from_jax(variables).items():
        if sd or hasattr(model, top):
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
