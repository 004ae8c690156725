"""On-card smoke run of the PyTorch/CUDA port (e3dge_torch); needs one CUDA card.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits non-zero before the last line):
  1. the card's name and power limit (nvidia-smi);
  2. build of the field kernel (csrc/siren_field.cu, nvcc for sm_90a), timed;
  3. the kernel against its plain version on the card: both entries, both
     precisions, with and without SFT, at N=300 and at the full width of one
     image (D=8, W=256, B=1, N=64*64*24), each output within its max and mean
     limits (`siren_field.KERNEL_TOLERANCE`); then each entry timed at the main
     path's shapes beside the plain version and the bound;
  4. `E3DGE.image2image` at the flagship configuration (bf16, 64^2 x 24 field,
     IR-SE-50 at 256^2, 4-stack hourglass, decoder to 1024^2) on seeded
     weights: launch counts from one call (one launch of each kernel entry),
     a finite, non-constant [1, 3, 1024, 1024] output, ms per inversion over
     warm calls, then where that time goes (stage times, device busy share,
     top device kernels);
  5. the same inversion in f32 on the card and on the CPU (plain versions)
     with the same weights, input and decoder noise: max abs difference of
     gen_imgs against a stated tolerance, and the bf16 image of phase 4
     against the f32 card image (mean relative error).
Prints a `kernels` JSON line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

SEED = 0
N_FULL = 64 * 64 * 24
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# f32 image2image, card vs CPU: field outputs agree to the goldens' 3e-3
# (tests/test_golden_oracle.py:40-41); the decoder's 5 upsampling levels carry
# that at gain ~1 into [-1, 1] images, so 1e-2 on gen_imgs.
TOL_CARD_VS_CPU = 1e-2
# bf16 image2image against f32 on the same weights, input and noise: mean
# |bf16 - f32| / max |f32| as tests/test_precision.py:94 holds the JAX bf16
# pipeline; an image whose std falls below the floor is taken as degenerate.
TOL_BF16_VS_F32_REL = 0.05
MIN_IMAGE_STD = 1e-2
# top-level stages of image2image, timed with CUDA events at their forward hooks
STAGES = (
    "encoder",
    "volume_discriminator",
    "generator.renderer",
    "local.residual_conv",
    "local.depth_conv",
    "local.image_filter",
    "grid_align",
    "fuse_sft_block",
    "local.local_feat_to_tex_modulations_linear",
    "generator.decoder",
)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def field_inputs(n: int, precision: str, sft: bool, device, depth: int = 8, width: int = 256):
    """Seeded field operands: SIREN-initialised weights, warped points in the
    [-1, 1] box, unit view dirs, W+ styles, optional SFT modulations."""
    from e3dge_torch.models.siren import SirenGenerator
    from e3dge_torch.ops.siren_field import io_dtype

    torch.manual_seed(SEED)
    net = SirenGenerator(depth, width, width).to(device)
    g = torch.Generator().manual_seed(SEED + n)
    pts = (torch.rand(1, n, 3, generator=g) * 2 - 1).to(device)
    dirs = torch.nn.functional.normalize(torch.randn(1, n, 3, generator=g), dim=-1).to(device)
    styles = (0.3 * torch.randn(1, depth + 1, width, generator=g)).to(device)
    alpha = lbeta = None
    if sft:
        dt = io_dtype(precision)
        alpha = (0.1 * torch.randn(1, n, width, generator=g)).to(device, dt)
        lbeta = (0.1 * torch.randn(1, n, width, generator=g)).to(device, dt)
    gamma, beta = net.film_vectors(styles.to(torch.bfloat16) if precision == "serving" else styles)
    return dict(pts=pts, dirs=dirs, pack=net.pack(precision), gamma=gamma, beta=beta, alpha=alpha, lbeta=lbeta)


def check_kernels(device) -> dict:
    """Phase 3: each entry against its plain version; returns the main-path
    (serving, full width) max abs errors per entry."""
    from e3dge_torch.ops import siren_field as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main_err = {}
    for n in (300, N_FULL):
        for precision in ("highest", "serving"):
            for sft in (False, True):
                x = field_inputs(n, precision, sft, device)
                args = (x["pts"], x["dirs"], x["pack"], x["gamma"], x["beta"], x["alpha"], x["lbeta"])
                feat, rgb_sdf, raw_h = sf.siren_field_full(*args, precision=precision, return_raw_h=True)
                pfeat, prgb_sdf, praw_h = sf.siren_field_reference(*args, precision=precision, return_raw_h=True)
                tex_args = (praw_h, x["dirs"], x["pack"], x["gamma"][:, -1].contiguous(),
                            x["beta"][:, -1].contiguous(), x["alpha"], x["lbeta"])
                tfeat, trgb = sf.siren_field_tex(*tex_args, precision=precision)
                qfeat, qrgb = sf.siren_field_tex_reference(*tex_args, precision=precision)
                torch.cuda.synchronize()
                rows = {
                    "full.feat": (feat, pfeat, "hidden"),
                    "full.rgb_sdf": (rgb_sdf, prgb_sdf, "head"),
                    "full.raw_h": (raw_h, praw_h, "hidden"),
                    "tex.feat": (tfeat, qfeat, "hidden"),
                    "tex.rgb": (trgb, qrgb, "head"),
                }
                errs = {}
                for name, (got, want, kind) in rows.items():
                    mx, mean, ok = sf.kernel_errors(got, want, kind, precision)
                    errs[name] = mx
                    tol_max, tol_mean = sf.KERNEL_TOLERANCE[precision][kind]
                    log(f"  N={n:6d} {precision:7s} sft={int(sft)} {name:12s} max {mx:.3e} mean {mean:.3e}"
                        f"  [max<={tol_max:g} mean<={tol_mean:g}] {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"field kernel disagrees with its plain version: {name} N={n} {precision}")
                if n == N_FULL and precision == "serving":
                    # the main path: pass 1 has no SFT, pass 2 (texture) has it
                    if not sft:
                        main_err["siren_field_full"] = max(errs["full.feat"], errs["full.rgb_sdf"], errs["full.raw_h"])
                    else:
                        main_err["siren_field_tex"] = max(errs["tex.feat"], errs["tex.rgb"])
    return main_err


def field_bounds(n: int, depth: int = 8, width: int = 256) -> dict:
    """Least time for each entry at the main path's serving shapes: bytes each
    input read once / each output written once over HBM rate, matmul flops over
    the bf16 tensor-core peak, the FiLM sines (fast_sin ~ 16 f32 flops) over
    the f32 peak; the largest of the three."""
    bf, f4 = 2, 4
    weights = (3 * width + (depth - 1) * width * width + width * width + 3 * width + width + 3 * width) * bf
    film = 2 * (depth + 1) * width * f4
    full_bytes = n * 3 * f4 * 2 + weights + film + n * width * bf * 2 + n * 4 * f4  # in; feat, raw_h, rgb_sdf
    full_mm = 2 * n * width * (3 + (depth - 1) * width + width + 3 + 1 + 3)
    full_sin = 16 * n * width * (depth + 1)
    tex_bytes = n * width * bf * 3 + n * 3 * f4 + (width * width + 6 * width) * bf + 2 * width * f4 \
        + n * width * bf + n * 3 * f4  # raw_h, alpha, lbeta, dirs in; feat, rgb out
    tex_mm = 2 * n * width * (width + 3 + 3)
    tex_sin = 16 * n * width
    out = {}
    for name, nbytes, mm, sin in (("siren_field_full", full_bytes, full_mm, full_sin),
                                  ("siren_field_tex", tex_bytes, tex_mm, tex_sin)):
        terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": max(mm / PEAK_BF16_TC, sin / PEAK_F32)}
        by = max(terms, key=terms.get)
        out[name] = {"bound_ms": terms[by] * 1e3, "bound_by": by}
    return out


def time_kernels(device) -> dict:
    """Each entry and its plain version at the main path's shapes (serving,
    B=1, N=64*64*24; pass 1 without SFT writing raw_h, pass 2 with SFT)."""
    from e3dge_torch.ops import siren_field as sf

    x = field_inputs(N_FULL, "serving", False, device)
    full_args = (x["pts"], x["dirs"], x["pack"], x["gamma"], x["beta"])
    y = field_inputs(N_FULL, "serving", True, device)
    raw_h = sf.siren_field_reference(*full_args, precision="serving", return_raw_h=True)[2]
    tex_args = (raw_h, y["dirs"], y["pack"], y["gamma"][:, -1].contiguous(), y["beta"][:, -1].contiguous(),
                y["alpha"], y["lbeta"])
    t = {
        "siren_field_full": (
            cuda_ms(lambda: sf.siren_field_full(*full_args, precision="serving", return_raw_h=True)),
            cuda_ms(lambda: sf.siren_field_reference(*full_args, precision="serving", return_raw_h=True), iters=5),
        ),
        "siren_field_tex": (
            cuda_ms(lambda: sf.siren_field_tex(*tex_args, precision="serving")),
            cuda_ms(lambda: sf.siren_field_tex_reference(*tex_args, precision="serving"), iters=5),
        ),
    }
    hx = field_inputs(N_FULL, "highest", False, device)
    t_high = cuda_ms(lambda: sf.siren_field_full(hx["pts"], hx["dirs"], hx["pack"], hx["gamma"], hx["beta"],
                                                 precision="highest", return_raw_h=True))
    log(f"  siren_field_full highest (f32) at N={N_FULL}: {t_high:.4f} ms")
    return t


def decoder_noise(cfg, batch: int, seed: int) -> list[torch.Tensor]:
    """Explicit per-layer decoder noise (CPU, seeded): one map at in_res, then
    two at each level up to size."""
    rng = np.random.RandomState(seed)
    sizes = [cfg.decoder.in_res]
    res = cfg.decoder.in_res
    while res < cfg.decoder.size:
        res *= 2
        sizes += [res, res]
    return [torch.from_numpy(rng.randn(batch, 1, s, s).astype(np.float32)) for s in sizes]


def seeded_inputs(cfg, seed: int):
    from e3dge_torch.models.e3dge import LatentMeans

    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 256, 256)).astype(np.float32))
    ml = LatentMeans(
        renderer=torch.from_numpy((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)),
        decoder=torch.from_numpy((0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32)),
    )
    return images, ml


def to_device(images, ml, noise, device):
    from e3dge_torch.models.e3dge import LatentMeans

    return (images.to(device), LatentMeans(ml.renderer.to(device), ml.decoder.to(device)),
            [n.to(device) for n in noise])


def run_flagship(device) -> tuple[dict, float, torch.Tensor]:
    """Phase 4: counts from one image2image call, output checks, ms/inversion,
    and where that time goes. Returns the counts, the median ms and gen_imgs."""
    from e3dge_torch.config import flagship_config
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.utils.weights import init_weights

    cfg = flagship_config()
    t0 = time.perf_counter()
    model = E3DGE(cfg)  # device=None: the card
    init_weights(model, SEED)
    images, ml, noise = to_device(*seeded_inputs(cfg, SEED), decoder_noise(cfg, 1, SEED), device)
    torch.cuda.synchronize()
    log(f"  model built + seeded weights: {time.perf_counter() - t0:.1f} s")

    sf.reset_launch_counts()
    out = model.image2image(images, ml, noise=noise)
    torch.cuda.synchronize()
    counts = dict(sf.launch_counts)
    log(f"  launch counts over one image2image: {counts}")
    if counts != {"siren_field_full": 1, "siren_field_tex": 1}:
        raise AssertionError(f"image2image did not launch each field kernel once: {counts}")
    img = out["res_render_out"]["gen_imgs"].cpu()
    if tuple(img.shape) != (1, 3, 1024, 1024) or img.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite gen_imgs")
    std = float(img.std())
    log(f"  gen_imgs {tuple(img.shape)} finite, range [{float(img.min()):.4f}, {float(img.max()):.4f}], "
        f"std {std:.4f} [floor {MIN_IMAGE_STD:g}]")
    if not std > MIN_IMAGE_STD:
        raise AssertionError("gen_imgs is constant or vanishing")

    call = lambda: model.image2image(images, ml, noise=noise)  # noqa: E731
    for _ in range(3):
        call()
    # the path is host-bound at B=1, so host noise shows: per-call times, median
    per_call = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(per_call))
    log(f"  image2image flagship bf16, B=1, 256^2 -> 1024^2: median {ms:.2f} ms per inversion "
        f"({1e3 / ms:.3f} inversions/s) over 20 calls, min {min(per_call):.2f}, max {max(per_call):.2f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_flagship(model, call, ms)
    del model, out
    torch.cuda.empty_cache()
    return counts, ms, img


def profile_flagship(model, call, wall_ms: float, iters: int = 5) -> None:
    """Where one inversion's time goes: per-stage CUDA-event ms at the top
    modules' forward hooks (host gaps inside a stage included), the device
    busy ms and its share of the unprofiled wall time (torch.profiler), and the
    top device kernels by total time."""
    from torch.profiler import ProfilerActivity, profile

    events = defaultdict(list)

    def hooks(name):
        def pre(_mod, _inp):
            events[name].append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
            events[name][-1][0].record()

        def post(_mod, _inp, _out):
            events[name][-1][1].record()

        return pre, post

    handles = []
    for name in STAGES:
        pre, post = hooks(name)
        mod = model.get_submodule(name)
        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    for _ in range(iters):
        call()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    staged = 0.0
    for name in STAGES:
        ms = sum(s.elapsed_time(e) for s, e in events[name]) / iters
        staged += ms
        log(f"  stage {name:45s} {ms:8.3f} ms  ({len(events[name]) // iters} forward(s) per inversion)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    kernel_us, launches = defaultdict(float), defaultdict(int)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernel_us[ev.name] += ev.time_range.elapsed_us()
            launches[ev.name] += 1
    busy_ms = sum(kernel_us.values()) / iters / 1e3
    log(f"  device busy {busy_ms:.3f} ms per inversion in {sum(launches.values()) // iters} launches; "
        f"busy share {busy_ms / wall_ms:.3f} of the {wall_ms:.2f} ms median wall; stages sum {staged:.3f} ms")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  kernel {us / iters / 1e3:8.4f} ms {launches[name] // iters:5d}x  {name[:100]}")


def run_card_vs_cpu(device, bf16_img: torch.Tensor) -> float:
    """Phase 5: f32 image2image on the card and on the CPU with phase 4's
    weights, input and noise; then phase 4's bf16 image against the f32 one."""
    from e3dge_torch.config import flagship_config
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.utils.weights import init_weights

    cfg = dataclasses.replace(flagship_config(), dtype="float32")
    cfg = dataclasses.replace(cfg, renderer=dataclasses.replace(cfg.renderer, field_dtype="float32")).validate()
    images, ml = seeded_inputs(cfg, SEED)
    noise = decoder_noise(cfg, 1, SEED)
    outs = {}
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        model = E3DGE(cfg, device=dev)
        init_weights(model, SEED)
        d_images, d_ml, d_noise = to_device(images, ml, noise, dev)
        out = model.image2image(d_images, d_ml, noise=d_noise)
        outs[dev.type] = out["res_render_out"]["gen_imgs"].float().cpu()
        log(f"  f32 image2image on {dev.type}: {time.perf_counter() - t0:.1f} s (build + one call)")
        if dev.type == "cuda":  # warm after the first call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                model.image2image(d_images, d_ml, noise=d_noise)
            torch.cuda.synchronize()
            log(f"  f32 image2image on the card (highest field): {(time.perf_counter() - t0) * 200:.2f} ms per inversion")
        del model, out
    diff = float((outs["cuda"] - outs["cpu"]).abs().max())
    ok = diff <= TOL_CARD_VS_CPU and math.isfinite(diff)
    log(f"  gen_imgs card vs CPU (f32, full width): max abs {diff:.3e} [tol {TOL_CARD_VS_CPU:g}] "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card and CPU image2image disagree")
    ref = outs["cuda"]
    rel = float(((bf16_img - ref).abs() / (ref.abs().max() + 1e-6)).mean())
    ok = rel < TOL_BF16_VS_F32_REL
    log(f"  gen_imgs bf16 vs f32 on the card: mean rel err {rel:.4e} [tol {TOL_BF16_VS_F32_REL:g}] "
        f"{'ok' if ok else 'FAIL'}; f32 std {float(ref.std()):.4f}")
    if not ok:
        raise AssertionError("bf16 image2image drifted from f32")
    return diff


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from e3dge_torch.ops import siren_field as sf

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    path, build_log = sf.build_library()
    log(f"[2] field kernel built in {time.perf_counter() - t0:.1f} s: {path.name}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("[3] field kernel vs its plain version on the card")
    with torch.no_grad():
        main_err = check_kernels(device)
        times = time_kernels(device)
    bounds = field_bounds(N_FULL)
    for name, (ms, plain_ms) in times.items():
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bounds[name]['bound_ms']:.4f} ms "
            f"({bounds[name]['bound_by']})")

    log("[4] image2image, flagship config on seeded weights")
    counts, inv_ms, bf16_img = run_flagship(device)

    log("[5] f32 image2image, card vs CPU; bf16 vs f32")
    run_card_vs_cpu(device, bf16_img)

    kernels = []
    for name in ("siren_field_full", "siren_field_tex"):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "e3dge_torch/csrc/siren_field.cu",
            "replaces": "e3dge_tpu/ops/pallas/siren_kernel.py:48",
            "launches": counts[name],
            "max_abs_err": main_err[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bounds[name]["bound_ms"],
            "bound_by": bounds[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the FiLM-SIREN field
        })
    log(f"image2image ms per inversion (flagship bf16, B=1): {inv_ms:.4f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
