"""Reference-flag compatibility: the reference's flags (`project/utils/
options.py`, as `scripts/{test,train}/*.sh` use them) -> the port's
`E3DGEConfig`; the port's own copy of `e3dge_tpu/utils/options_compat.py`
(the same flag map and couplings), so a reference user's flag list builds
the same configuration on both sides.

Only flags that change behaviour in the released configs are honoured;
unknown flags are collected and returned. `--no_sdf` selects the
raw-density renderer (`RendererConfig.with_sdf=False`) and `--netLocal_type
HGPIFuNetGANResidual` the BatchNorm netLocal with its EqualLinear texture
head (`LocalFeatureNet`, variant "bn").

    cfg, unknown = config_from_reference_flags([
        "--size", "1024", "--N_samples", "24", "--enable_local_model",
        "--netLocal_type", "HGPIFuNetGANResidualResnetFC", "--z_size", "1.12",
    ])
"""

from __future__ import annotations

from typing import Sequence

from e3dge_torch.config import E3DGEConfig, _with, default_config

# flag -> (group, field, type) ; None type = store_true
_FLAG_MAP: dict[str, tuple[str, str, type | None]] = {
    # model group
    "--size": ("decoder", "size", int),
    "--style_dim": ("renderer", "style_dim", int),
    "--channel_multiplier": ("decoder", "channel_multiplier", int),
    "--lr_mapping": ("decoder", "lr_mapping", float),
    "--renderer_spatial_output_dim": ("renderer", "out_im_res", int),
    "--project_noise": ("decoder", "project_noise", None),
    # camera group
    "--uniform": ("camera", "uniform", None),
    "--azim": ("camera", "azim_range", float),
    "--elev": ("camera", "elev_range", float),
    "--azim_mean": ("camera", "azim_mean", float),
    "--elev_mean": ("camera", "elev_mean", float),
    "--fov": ("camera", "fov_ang", float),
    "--dist_radius": ("camera", "dist_radius", float),
    # rendering group
    "--depth": ("renderer", "depth", int),
    "--width": ("renderer", "width", int),
    "--N_samples": ("renderer", "n_samples", int),
    "--no_offset_sampling": ("renderer", "offset_sampling", "invert"),
    "--perturb": ("renderer", "perturb", "float_bool"),
    "--raw_noise_std": ("renderer", "raw_noise_std", float),
    "--static_viewdirs": ("renderer", "static_viewdirs", None),
    "--no_z_normalize": ("renderer", "z_normalize", "invert"),
    "--force_background": ("renderer", "force_background", None),
    "--no_sdf": ("renderer", "with_sdf", "invert"),
    "--enable_local_model": ("renderer", "enable_local_model", None),
    "--local_modulation_layer": ("renderer", "local_modulation_layer", None),
    "--residual_local_feats_dim": ("renderer", "residual_local_feats_dim", int),
    "--sample_near_surface": ("renderer", "sample_near_surface", None),
    "--sample_uniform_grid": ("renderer", "sample_uniform_grid", None),
    "--uniform_grid_sampling_num": ("renderer", "uniform_grid_sampling_num", int),
    "--surface_sampling_stdv": ("renderer", "surface_sampling_stdv", float),
    # pifu group
    "--num_stack": ("pifu", "num_stack", int),
    "--num_hourglass": ("pifu", "num_hourglass", int),
    "--hourglass_dim": ("pifu", "hourglass_dim", int),
    "--hg_input_channel": ("pifu", "hg_input_channel", int),
    "--norm": ("pifu", "norm", str),
    "--loadSize": ("pifu", "load_size", int),
    "--z_size": ("pifu", "z_size", float),
    "--netLocal_type": ("pifu", "netLocal_type", str),
    # training group
    "--batch": ("train", "batch", int),
    "--lr": ("train", "lr", float),
    "--ada_lr": ("train", "ada_lr", float),
    "--r1": ("train", "r1", float),
    "--d_reg_every": ("train", "d_reg_every", int),
    "--l2_lambda": ("train", "l2_lambda", float),
    "--lpips_lambda": ("train", "lpips_lambda", float),
    "--id_lambda": ("train", "id_lambda", float),
    "--latent_gt_lambda": ("train", "latent_gt_lambda", float),
    "--res_lambda": ("train", "res_lambda", float),
    "--adv_lambda": ("train", "adv_lambda", float),
    "--uniform_pts_sdf_lambda": ("train", "shape_uniform_lambda", float),
    "--surf_sdf_lambda": ("train", "shape_surface_lambda", float),
    "--surf_normal_lambda": ("train", "shape_normal_lambda", float),
    "--eikonal_lambda": ("train", "eikonal_lambda", float),
}


def config_from_reference_flags(
    argv: Sequence[str], base: E3DGEConfig | None = None
) -> tuple[E3DGEConfig, list[str]]:
    """Parse reference-style flags into a config. Returns (cfg, unknown_flags)."""
    cfg = base or default_config()
    updates: dict[str, dict] = {}
    unknown: list[str] = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        flag = argv[i]
        spec = _FLAG_MAP.get(flag)
        if spec is None:
            unknown.append(flag)
            # best-effort skip of its value
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                i += 1
            i += 1
            continue
        group, field, typ = spec
        if typ is None:
            value = True
            i += 1
        elif typ == "invert":
            value = False
            i += 1
        elif typ == "float_bool":
            value = float(argv[i + 1]) > 0
            i += 2
        else:
            value = typ(argv[i + 1])
            i += 2
        updates.setdefault(group, {})[field] = value

    # derived couplings the reference's setup cross-copies (base_setup.py:31-67)
    r = updates.get("renderer", {})
    if "style_dim" in r:
        updates.setdefault("decoder", {})["style_dim"] = 2 * r["style_dim"]
        updates.setdefault("encoder", {})["style_dim"] = r["style_dim"]
        updates["encoder"]["decoder_style_dim"] = 2 * r["style_dim"]
    if "width" in r:
        updates.setdefault("decoder", {})["in_channels"] = r["width"]
    if "out_im_res" in r:
        updates.setdefault("decoder", {})["in_res"] = r["out_im_res"]
    if "depth" in r:
        updates.setdefault("encoder", {})["n_styles_pigan"] = r["depth"] + 1
        updates["encoder"]["pigan_tex_layer"] = r["depth"] + 1

    cfg = _with(cfg, **updates)
    # decoder n_latent depends on size/in_res
    updates2 = {"encoder": {"n_styles_decoder": cfg.decoder.n_latent}}
    cfg = _with(cfg, **updates2)
    return cfg.validate(), unknown
