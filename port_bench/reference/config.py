"""Typed configuration for the PyTorch port: a field-for-field copy of
`e3dge_tpu/utils/config.py` (frozen dataclasses + the named presets), kept here so
the port imports nothing of the JAX package. `tests/test_torch_config.py` holds
every preset's `dataclasses.asdict` equal to the JAX package's.

Fields that steer TPU-only rewrites (`DecoderConfig.s2d_min_res*`,
`RendererConfig.fused_inference`, `PifuConfig.query_sample_mode`) are carried so
the trees stay equal; the port reads none of them (one decoder path, one
bilinear sampler, and the hand-written field kernel always serves inference).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class CameraConfig:
    """Camera sampling (reference `options.py` camera group + camera_utils.py:8)."""

    uniform: bool = False        # uniform vs gaussian (azim, elev) sampling
    azim_range: float = 0.3      # radians (std when gaussian)
    elev_range: float = 0.15
    azim_mean: float = 0.0
    elev_mean: float = 0.0
    fov_ang: float = 6.0         # HALF fov in degrees (full fov = 12 deg)
    dist_radius: float = 0.12    # near/far = 1 -/+ dist_radius


@dataclass(frozen=True)
class RendererConfig:
    """Volume renderer / SIREN MLP (reference rendering group)."""

    depth: int = 8               # FiLM-SIREN backbone layers
    width: int = 256             # hidden width == feature map channels
    style_dim: int = 256
    out_im_res: int = 64         # thumb render resolution
    n_samples: int = 24          # samples per ray
    offset_sampling: bool = True   # eq.(3) offset sampling (vs NeRF stratified)
    perturb: bool = True           # jitter z_vals during training
    raw_noise_std: float = 0.0
    # The reference's base_setup.py:54 hardwires static_viewdirs=True for the
    # renderer option group that reaches VolumeFeatureRenderer — the released
    # models see CAMERA-space (pose-independent) view dirs. Golden-oracle-proven
    # (tests/test_golden_oracle.py::test_volume_render_golden).
    static_viewdirs: bool = True
    z_normalize: bool = True       # warp coords by 2/(2*dist_radius) -> [-1,1]
    force_background: bool = True  # put leftover transmittance on last sample
    with_sdf: bool = True          # SDF + sigmoid-Laplace density (vs raw density)
    return_xyz: bool = True
    output_features: bool = True
    fg_mask_threshold: float = 1.08  # depth < 1.08 heuristic fg mask
    # Local (E1) branch
    enable_local_model: bool = False
    local_modulation_layer: bool = True   # SFT (alpha+1)*h+beta before view layer
    residual_local_feats_dim: int = 256 + 45  # hourglass feats + 45-dim PE
    # 3D supervision sampling
    sample_near_surface: bool = False
    sample_uniform_grid: bool = False
    uniform_grid_sampling_num: int = 2048
    surface_sampling_stdv: float = 0.03
    # Field compute dtype. In the port "bfloat16" selects the field kernel's
    # `serving` precision (bf16 operands, f32 accumulation, fast_sin) and
    # "float32" its `highest` precision. Integration and z-sampling stay f32.
    field_dtype: str = "float32"
    # Occlusion-query (query_hit_prob) field dtype. The hit-prob re-integration is
    # a stop-gradient weighting (reference cycle_runner.py:133-161 against a frozen
    # generator), so it can run the bf16+fast_sin serving field even when training
    # keeps field_dtype f32 for its fused-cos VJP. None -> follow field_dtype.
    occlusion_field_dtype: str | None = None
    # Occlusion re-integration mode for use_ref_view_weight (cycle training):
    # "exact" re-integrates a full ray through every query point (reference
    # cycle_runner.py:133-161 semantics; ~24x a render's field work); "texture"
    # trilinearly samples the ref render's own weight volume instead — a
    # light-field approximation of the same stop-gradient weighting (see
    # VolumeFeatureRenderer.query_hit_prob_texture).
    occlusion_mode: str = "exact"
    # Field dtype for the frozen-teacher target rendering in synthetic_sample
    # (stage-1 training; "bfloat16" samples with the kernel's serving precision).
    sample_field_dtype: str = "float32"
    # JAX package only: its Pallas field query switch. The port always serves
    # inference through its CUDA field kernel (ops/siren_field.py).
    fused_inference: bool = False
    # Rematerialise the differentiable field (the eager twin) in the training
    # backward instead of storing its activations (torch.utils.checkpoint).
    remat_field: bool = False


@dataclass(frozen=True)
class DecoderConfig:
    """StyleGAN2 upsampler G1 (reference model group + Decoder, stylesdf_model.py:587)."""

    size: int = 1024             # output resolution
    style_dim: int = 512         # decoder w dim (2x renderer style_dim)
    channel_multiplier: int = 2
    channel_base: int = 512      # reference channel table scales off 512
    lr_mapping: float = 0.01
    in_res: int = 64             # == renderer out_im_res
    in_channels: int = 256       # == renderer width (feature map channels)
    project_noise: bool = False
    # JAX package only: its space-to-depth decoder tail, a TPU layout rewrite
    # pinned to the standard path by tests/test_s2d.py. The port runs the
    # standard path and ignores both thresholds.
    s2d_min_res: int = 1024
    s2d_min_res_eval: int = 0

    def channels(self) -> dict[int, int]:
        """StyleGAN2 channel table (reference stylesdf_model.py:614-624)."""
        cb, cm = self.channel_base, self.channel_multiplier
        return {
            4: cb, 8: cb, 16: cb, 32: cb,
            64: cb // 2 * cm, 128: cb // 4 * cm, 256: cb // 8 * cm,
            512: cb // 16 * cm, 1024: cb // 32 * cm,
        }

    @property
    def n_latent(self) -> int:
        import math

        return (int(math.log2(self.size)) - int(math.log2(self.in_res))) * 2 + 2


@dataclass(frozen=True)
class EncoderConfig:
    """E0 FPN encoder (reference `HybridGradualStyleEncoder_V2`, fpn_encoders.py:266)."""

    num_layers: int = 50         # IR-SE depth
    mode: str = "ir_se"
    input_nc: int = 3
    input_res: int = 256
    style_dim: int = 256         # renderer W+ row dim
    decoder_style_dim: int = 512
    n_styles_pigan: int = 9      # renderer W+ rows
    n_styles_decoder: int = 10   # decoder W+ rows
    pigan_geo_layer: int = 6     # first 6 styles from p32 ("geo")
    pigan_tex_layer: int = 9
    # Released flags: stage scripts pass --fpn_pigan_geo_layer_dim 128; tex dim
    # keeps the options.py:1415 default 128. These dims set the conv COUNT in
    # each GradualStyleBlock (log2(dim) stride-2 convs, helpers.py:479) — the
    # released ckpts carry 7-conv blocks, and tex!=64 means ALL 9 pigan styles
    # read p32 (fpn_encoders.py:406-410). Golden-oracle-proven
    # (tests/test_golden_oracle.py::test_fpn_encoder_golden).
    fpn_pigan_geo_layer_dim: int = 128
    fpn_pigan_tex_layer_dim: int = 128
    # ckpt-layout only: False (released) builds 10 styles_stylegan blocks, but
    # the reference forward uses block 0 repeated either way (fpn_encoders.py:417-419)
    single_decoder_layer: bool = True
    full_pipeline: bool = True


@dataclass(frozen=True)
class PifuConfig:
    """E1 hourglass local filter (reference vendor/pifu/lib/options.py defaults used
    by E3DGE: num_stack=4, hourglass depth 2, group-norm, 256 feats)."""

    num_stack: int = 4
    num_hourglass: int = 2
    hourglass_dim: int = 256
    hg_input_channel: int = 64
    norm: str = "group"
    hg_down: str = "ave_pool"
    load_size: int = 256
    z_size: float = 1.12   # released flag --z_size 1.12 (pifu options.py default is 200)
    residual_context_feats: tuple[str, ...] = ("depth",)
    netLocal_type: str = "HGPIFuNetGANResidualResnetFC"  # released inference ckpts
    # bilinear-sampling lowering for pixel-aligned queries: "gather" | "mm" |
    # "auto" (mm — one-hot sampling-matrix matmul, backward is a matmul not a
    # scatter — only for bf16 feature maps at large point counts; see
    # ops/grid_sample.grid_sample_mm)
    query_sample_mode: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    """Stage losses + optimization (reference training group, stage*.sh scripts)."""

    batch: int = 4
    lr: float = 1e-4
    ada_lr: float = 1e-4
    r1: float = 10.0
    d_reg_every: int = 16
    # loss lambdas (stage-dependent; defaults = stage 1)
    l2_lambda: float = 1.0
    lpips_lambda: float = 0.8
    id_lambda: float = 0.1
    latent_gt_lambda: float = 1.0
    res_lambda: float = 1.0
    adv_lambda: float = 0.0
    shape_uniform_lambda: float = 0.1
    shape_surface_lambda: float = 1.0
    shape_normal_lambda: float = 0.05
    eikonal_lambda: float = 0.1
    # cycle training
    cycle_training: bool = False
    supervise_both_gen_imgs: bool = True


@dataclass(frozen=True)
class E3DGEConfig:
    """Top-level config: one object instead of the reference's Munch-of-Munch tree."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    renderer: RendererConfig = field(default_factory=RendererConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    pifu: PifuConfig = field(default_factory=PifuConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    full_pipeline: bool = True   # decoder on top of renderer
    dtype: Any = "float32"       # compute dtype for conv/matmul paths

    def validate(self) -> "E3DGEConfig":
        assert self.decoder.in_res == self.renderer.out_im_res
        assert self.decoder.in_channels == self.renderer.width
        assert self.decoder.style_dim == 2 * self.renderer.style_dim
        assert self.encoder.style_dim == self.renderer.style_dim
        assert self.encoder.decoder_style_dim == self.decoder.style_dim
        assert self.encoder.n_styles_pigan == self.renderer.depth + 1
        assert self.encoder.n_styles_decoder == self.decoder.n_latent
        assert self.encoder.pigan_tex_layer == self.encoder.n_styles_pigan
        assert self.renderer.residual_local_feats_dim == self.pifu.hourglass_dim + 45
        assert self.pifu.query_sample_mode in ("gather", "mm", "auto")
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------- named presets (the reference's shell scripts) ----------------

