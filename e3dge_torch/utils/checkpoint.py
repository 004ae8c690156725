"""Reference checkpoints into the port's modules; counterpart of the
checkpoint helpers of `e3dge_tpu/utils/torch_ckpt.py:516-632`; and the
variables-only warm start from the port's own checkpoints (`--ckpt`).

The port's modules keep the reference's state_dict keys, so a reference
checkpoint loads with `load_state_dict(strict=True)` once its wrappers are
undone: a StyleSDF/E3DGE generator (`g_ema`) nests the global field under
`renderer.network.netGlobal.` and the local branch under
`renderer.network.netLocal.`, and DataParallel prefixes `module.`; an E3DGE
training checkpoint is a save_dict with one state_dict per network.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import torch
from torch import nn

# the reference's network-dict names (base_runner.save_network:253-285) -> the
# port's top modules
E3DGE_SAVE_DICT_TOPS = {
    "encoder": "encoder",                  # trainer.py:1684
    "netLocal": "local",                   # AERunner network dict
    "grid_align": "grid_align",            # e3dge_2dalignonly_runner.py:566
    "Fuse_sft_block": "fuse_sft_block",    # e3dge_full_runner.py:322
    "volume_discriminator": "volume_discriminator",
}
LOCAL_PREFIX = "renderer.network.netLocal."
# the top modules the port's trainer saved as `<module>.pt` files at its work
# dir's root before it wrote `models_<name>/` checkpoints
LEGACY_MODULES = ("encoder", "local", "grid_align", "fuse_sft_block", "volume_discriminator")


def normalize_g_ema_keys(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Undo the `module.` prefix and the netGlobal nesting
    (train_setup.py:243-265): renderer.network.netGlobal.X ->
    renderer.network.X; netLocal keys stay for `split_generator_sd`."""
    return {
        k.removeprefix("module.").replace("renderer.network.netGlobal.", "renderer.network."): v
        for k, v in sd.items()
    }


def split_generator_sd(g_ema_sd: Mapping[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
    """A normalized generator state dict -> (generator, netLocal) state dicts."""
    gen, local = {}, {}
    for k, v in g_ema_sd.items():
        if k.startswith(LOCAL_PREFIX):
            local[k[len(LOCAL_PREFIX):]] = v
        else:
            gen[k] = v
    return gen, local


def split_e3dge_save_dict(ckpt: Mapping[str, Any]) -> dict[str, dict[str, torch.Tensor]]:
    """An E3DGE training save_dict ('iter', 'encoder', 'netLocal',
    'grid_align', 'Fuse_sft_block', optimizer states, ...) -> {top module:
    state dict} for the inference networks it holds, `module.` prefixes
    removed, tensors detached on the CPU."""
    out = {}
    for ref_name, top in E3DGE_SAVE_DICT_TOPS.items():
        sd = ckpt.get(ref_name)
        if isinstance(sd, Mapping) and sd:
            out[top] = {k.removeprefix("module."): v.detach().cpu() for k, v in sd.items() if torch.is_tensor(v)}
    return out


def load_torch_file(path: str | os.PathLike) -> Any:
    """torch.load onto the CPU, unpickling tensors and plain containers only. A
    checkpoint that also pickles objects needs `torch.load(...,
    weights_only=False)`, for a source you trust."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(
    model: nn.Module,
    g_ema: Mapping[str, torch.Tensor] | None = None,
    e3dge_save_dict: Mapping[str, Any] | None = None,
) -> list[str]:
    """Load a reference generator (`g_ema`, with or without its wrappers) and
    an E3DGE save_dict into a port `E3DGE`, each module strictly. A netLocal
    inside g_ema fills `local` unless the save_dict has one. Returns the top
    modules loaded."""
    sds: dict[str, dict[str, Any]] = {}
    if g_ema is not None:
        gen, local = split_generator_sd(normalize_g_ema_keys(g_ema))
        sds["generator"] = gen
        if local:
            sds["local"] = local
    if e3dge_save_dict is not None:
        sds.update(split_e3dge_save_dict(e3dge_save_dict))
    for top, sd in sds.items():
        getattr(model, top).load_state_dict(sd, strict=True)
    return list(sds)


def warm_start(module: nn.Module, path: str | os.PathLike) -> None:
    """Merge the state dict saved at path into module where the shapes match
    (`train_utils.warm_start_merge`); the rest keeps its fresh values."""
    from e3dge_torch.training.train_utils import warm_start_merge

    merged, loaded, skipped = warm_start_merge(module.state_dict(), load_torch_file(path))
    module.load_state_dict(merged)
    print(f"warm-started from {path}: {loaded} entries loaded, {skipped} shape-mismatched kept fresh", flush=True)


def warm_start_checkpoint(model: nn.Module, ckpt: str | os.PathLike) -> None:
    """A variables-only warm start (reference --ckpt surgery,
    train_setup.py:144-177): from a `models_<name>/` directory's
    variables.pt, the whole model; from a directory of the earlier layout,
    each `<module>.pt` the model has a module for. Raises if ckpt holds
    neither."""
    path = Path(ckpt)
    if (path / "variables.pt").is_file():
        warm_start(model, path / "variables.pt")
        return
    names = [n for n in LEGACY_MODULES if (path / f"{n}.pt").is_file() and hasattr(model, n)]
    if not names:
        raise FileNotFoundError(f"{path}: neither a models_<name> checkpoint (variables.pt) nor <module>.pt files")
    for n in names:
        warm_start(getattr(model, n), path / f"{n}.pt")
