"""On-card smoke run of the PyTorch/CUDA port (e3dge_torch); needs one CUDA card.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits non-zero before the last line):
  1. the card's name and power limit (nvidia-smi);
  2. build of the field kernels (csrc/*.cu, nvcc for sm_90a), timed; ptxas
     registers and spills per kernel, and from `cuobjdump -sass` the count of
     HGMMA (wgmma) and bulk-copy/TMA (UBLKCP/UTMALDG) instructions per kernel
     entry and precision: fails if any entry has no HGMMA or spills, or if
     the library holds a kernel that is not one of the four entries;
  3. the kernel against its plain version on the card: both entries, both
     precisions, with and without SFT, at N=300 and at the full width of one
     image (D=8, W=256, B=1, N=64*64*24), and in `serving` at B=2, N=64*64*24+37
     (the persistent tile walk across items, a ragged last tile), each output
     within its max and mean limits (`siren_field.KERNEL_TOLERANCE`); then each
     entry timed in both precisions at the main path's shapes beside the plain
     version and the bound; then `siren_field_full` in serving at the shapes
     of the other paths (the SFT re-render of 4 novel views, B=4, N=64*64*24;
     one of the 16 occlusion chunks, B=1, N=64*64*23/16*24 = 141,312), checked
     and timed the same way;
  4. `E3DGE.image2image` at the flagship configuration (bf16, 64^2 x 24 field,
     IR-SE-50 at 256^2, 4-stack hourglass, decoder to 1024^2) on seeded
     weights: launch counts from one call (one launch of each kernel entry),
     a finite, non-constant [1, 3, 1024, 1024] output, ms per inversion over
     warm calls and the peak memory, then where that time goes (stage times,
     device busy share, top device kernels);
  5. the same inversion in f32 on the card and on the CPU (plain versions)
     with the same weights, input and decoder noise: max abs difference of
     gen_imgs against a stated tolerance, and the bf16 image of phase 4
     against the f32 card image (mean relative error);
  6. the other inference paths on phase 4's weights, input and noise, each
     with its launch counts, output checks, ms per call, device busy ms per
     call and peak memory:
     a. `Runner.render_video`, 4 views batched (`render_multiview`);
     b. the generic `que_render_given_ref` at the ref camera against the
        same-view image, in f32 (phase 5's model) and in bf16;
     c. the ref-view occlusion weighting at a novel camera, "exact" and
        "texture";
     d. `image2image_global` on the model without the local branch;
     e. `Runner.latent2surface`: the SDF grid against the plain field's, the
        marching library's build time, the mesh's size;
  7. stage-1 training at `stage1_config`'s full width (64^2 x 18 field
     samples, SIREN 8 x 256, IR-SE-50 at 256^2, decoder to 1024^2, f32), B=4,
     seeded weights and perceptual nets, Adam at 5e-5, the stage-1 lambdas:
     the `highest` field kernel at each of the step's three launch shapes
     (the sample render, the near-surface and the uniform SDF targets, the
     last two with zero dirs) against its plain version and timed; 2 warm-up
     + 5 measured steps, each with exactly 3 + 0 field launches (every
     differentiable query runs the eager twin), every loss term finite,
     a gradient on the renderer W+, E0's parameters and BN statistics moved,
     the generator, volume D and perceptual nets bit-identical; ms per step in
     four parts (CUDA events), peak memory, device busy per step, the top
     device kernels; then one step of a reduced config (field 8 x 256 at 32^2,
     decoder to 128^2, B=2) from one batch on the card and on the CPU (8
     threads; again at 1 thread for the reference's own spread): the loss
     terms, E0's gradient as a whole and each leaf within their tolerances,
     and a control step with the eikonal double backward cut outside them;
  8. stage-2.2 training at `stage2_config`'s full width (64^2 x 24 field
     samples, SIREN 8 x 256, IR-SE-50 at 256^2, 4-stack hourglass, decoder to
     1024^2, f32), B=4, seeded weights, perceptual nets and full-res D (at
     256^2), the stage2.2.sh lambdas and switches: the `highest` kernel at the
     iteration's new launch shapes (B=4 x 98,304 with and without raw_h, the
     texture pass with SFT) against its plain version and timed; 2 warm-up + 4
     measured iterations of (D producer, D step with lazy R1, E step), each
     half's field launches asserted (D 4 + 1, E 5 + 0), every term finite,
     local and the fusion block moved, the aligner (--fix-ada), E0, the
     generator, the volume D and the perceptual nets bit-identical, E0's and
     the aligner's BN statistics moved, the EMA between old and new, the D
     moved and R1 at its step 0 only; ms per iteration in six parts, a warm D
     step with R1 (timed, then profiled), peak memory, device busy, the
     field kernel's share, the top device kernels; then one cycle loss of a
     reduced config (as phase 7's)
     with every branch on, card vs CPU within phase 7's limits, and a control
     with the SFT modulations detached outside them;
  9. the eval entry point, `e3dge_torch.eval.main`, at
     demo_view_synthesis_config's full width (64^2 x 24 field, SIREN 8 x 256,
     IR-SE-50, 4-stack hourglass, decoder to 1024^2), f32, seeded weights, on
     5 seeded 256^2 PNGs (written by the port's codec) at batch 2: the field
     kernel at the eval paths' new launch shapes against its plain version
     and timed (`highest` B=2 with raw_h, with SFT, B=8 with SFT, the texture
     pass at B=2; `serving` B=2 with raw_h and its texture pass); then the
     modes metrics (seeded perceptual nets from .pth files holding a subset
     of their keys), video (4 views), hdtf, mesh, edit (seeded boundaries),
     project (5 steps + 2 PTI steps) and metrics from its latents with PTI,
     and metrics in bf16, each with its field launches asserted, its
     artifacts checked (existence, shape, finiteness), its scores, wall ms
     per image or frame and device busy ms of the Runner call (under the
     profiler), and peak memory; validation's scores card vs CPU at a
     reduced config within stated tolerances, with a control outside them;
     then `Runner.render_video_projected_noise` (4 views) and
     `Runner.render_depth_mesh` (512^2) on phase 4's seeded weights, input
     and noise, with the host share (marching and rasterizer ms).
Prints a `kernels` JSON line (with each entry's launches per path, and the
`highest` entries the training paths launch), the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

SEED = 0
N_FULL = 64 * 64 * 24
# H100 SXM data-sheet peaks (dense): bf16 and TF32 tensor cores, f32 outside
# them, HBM3
PEAK_BF16_TC = 989e12
PEAK_TF32_TC = 495e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# f32 image2image, card vs CPU: field outputs agree to the goldens' 3e-3
# (tests/test_golden_oracle.py:40-41); the decoder's 5 upsampling levels carry
# that at gain ~1 into [-1, 1] images, so 1e-2 on gen_imgs.
TOL_CARD_VS_CPU = 1e-2
# the FiLM epilogue's f32-pipe instructions per activation (bias add, FiLM
# fma, fast_sin's range reduction and 6-term polynomial, bf16 rounding)
EPILOGUE_INSTR = 14
# kernel entries by their mangled names in the built library
KERNEL_ENTRIES = {
    "siren_field_tc_kernelILb0E": ("siren_field_full", "serving"),
    "siren_field_tc_kernelILb1E": ("siren_field_tex", "serving"),
    "siren_field_tf32_kernelILb0E": ("siren_field_full", "highest"),
    "siren_field_tf32_kernelILb1E": ("siren_field_tex", "highest"),
}
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


def kernel_entry(mangled: str) -> tuple[str, str] | None:
    """(entry, precision) of a kernel function of the built library."""
    return next((v for k, v in KERNEL_ENTRIES.items() if k in mangled), None)


def check_build(path, build_log: str) -> dict:
    """Phase 2: per kernel entry and precision, ptxas's registers (the launch
    count; `sass_max_register` is the highest register the code names, which
    setmaxnreg lets a consumer warpgroup raise past it), spill bytes, stack
    frame, injected warpgroup fences (C7519) and wgmma serialisation
    (C7510/C7511), and the SASS counts of HGMMA (wgmma) and bulk-copy/TMA
    (UBLKCP/UTMALDG) instructions. Fails if an entry has no HGMMA or spills,
    or if the library holds a kernel function that is none of the entries
    (the replaced scalar f32 kernel, say). An empty log (library already
    built) leaves the ptxas columns None."""
    from e3dge_torch.ops import siren_field as sf

    func, ptxas = None, defaultdict(dict)
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            func = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and func:
            ptxas[func]["stack_frame"] = int(m.group(1))
            ptxas[func]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            ptxas[func]["registers"] = int(m.group(1))
        m = re.search(r"\((C75\d\d)\).* in (?:the )?function '(\w+)'", line)
        if m:
            key = "serialized_wgmma" if "serialized" in line else "injected_fences" if m.group(1) == "C7519" else None
            if key:
                ptxas[m.group(2)][key] = ptxas[m.group(2)].get(key, 0) + 1
            if key != "injected_fences":
                log(f"  ptxas: {line.strip()[:160]}")
        elif "warning" in line:
            log(f"  ptxas: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(sf.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        entry = kernel_entry(name)
        if entry is None:
            raise AssertionError(f"the built library holds a kernel that is no field entry: {name}")
        info = next((v for k, v in ptxas.items() if k == name), {})
        counts[entry] = {"registers": info.get("registers"), "spill_bytes": info.get("spill_bytes"),
                         "stack_frame": info.get("stack_frame"),
                         **{k: info.get(k, 0) if info else None for k in ("injected_fences", "serialized_wgmma")},
                         "sass_max_register": max(map(int, re.findall(r"\bR(\d+)\b", block)), default=None),
                         **{op: len(re.findall(rf"\b{op}\b", block)) for op in ("HGMMA", "UBLKCP", "UTMALDG")}}
        log(f"  {entry[0]:16s} {entry[1]:7s} {counts[entry]}")
    for entry in set(KERNEL_ENTRIES.values()):
        c = counts.get(entry)
        if not c or c["HGMMA"] == 0:
            raise AssertionError(f"{entry} runs no wgmma (HGMMA) in the built library: {c}")
        if c["spill_bytes"]:
            raise AssertionError(f"{entry} spills registers: {c['spill_bytes']} bytes")
    return counts


def field_inputs(n: int, precision: str, sft: bool, device, depth: int = 8, width: int = 256, batch: int = 1):
    """Seeded field operands: SIREN-initialised weights, warped points in the
    [-1, 1] box, unit view dirs, W+ styles, optional SFT modulations."""
    from e3dge_torch.models.siren import SirenGenerator
    from e3dge_torch.ops.siren_field import io_dtype

    torch.manual_seed(SEED)
    net = SirenGenerator(depth, width, width).to(device)
    g = torch.Generator().manual_seed(SEED + n)
    pts = (torch.rand(batch, n, 3, generator=g) * 2 - 1).to(device)
    dirs = torch.nn.functional.normalize(torch.randn(batch, n, 3, generator=g), dim=-1).to(device)
    styles = (0.3 * torch.randn(batch, depth + 1, width, generator=g)).to(device)
    alpha = lbeta = None
    if sft:
        dt = io_dtype(precision)
        alpha = (0.1 * torch.randn(batch, n, width, generator=g)).to(device, dt)
        lbeta = (0.1 * torch.randn(batch, n, width, generator=g)).to(device, dt)
    gamma, beta = net.film_vectors(styles.to(torch.bfloat16) if precision == "serving" else styles)
    return dict(pts=pts, dirs=dirs, pack=net.pack(precision), gamma=gamma, beta=beta, alpha=alpha, lbeta=lbeta)


def check_kernels(device) -> dict:
    """Phase 3: each entry against its plain version; returns the main-path
    (serving, full width) max abs errors per entry."""
    from e3dge_torch.ops import siren_field as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main_err = {}
    cases = [(1, n, precision) for n in (300, N_FULL) for precision in ("highest", "serving")]
    cases.append((2, N_FULL + 37, "serving"))
    for batch, n, precision in cases:
        for sft in (False, True):
            x = field_inputs(n, precision, sft, device, batch=batch)
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
                log(f"  B={batch} N={n:6d} {precision:7s} sft={int(sft)} {name:12s} max {mx:.3e} mean {mean:.3e}"
                    f"  [max<={tol_max:g} mean<={tol_mean:g}] {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"field kernel disagrees with its plain version: {name} N={n} {precision}")
            if (batch, n, precision) == (1, N_FULL, "serving"):
                # the main path: pass 1 has no SFT, pass 2 (texture) has it
                if not sft:
                    main_err["siren_field_full"] = max(errs["full.feat"], errs["full.rgb_sdf"], errs["full.raw_h"])
                else:
                    main_err["siren_field_tex"] = max(errs["tex.feat"], errs["tex.rgb"])
    return main_err


def field_bounds(n: int, precision: str, depth: int = 8, width: int = 256, batch: int = 1,
                 sft: bool = False, raw_h: bool = True) -> dict:
    """Least time for each entry over `batch` items of n points: the larger of
    the bytes (each input read once, each output written once) over the HBM
    rate and the operations over their pipe's peak. The full entry reads
    alpha/lbeta when `sft` and writes raw_h when `raw_h` (the main path's pass
    1 does; a novel-view re-render reads the SFT and writes no raw_h). The
    256x256 products go to the tensor cores: `serving` once on bf16
    operands, `highest` three times on TF32 operands (3xTF32 split products);
    the FiLM sines (~16 f32 flops each) and the K=3 layers and heads go to the
    f32 pipe beside them. bf16 weights and io in `serving`, f32 in `highest`.
    Also the epilogue's f32-pipe floor (EPILOGUE_INSTR instructions per
    activation at the f32 instruction rate, half the flop rate) and, for
    `highest`, `fma_bound_ms`: the bound with every product on the f32 pipe
    (the yardstick of the scalar f32 kernel this one replaced)."""
    io, f4 = (2 if precision == "serving" else 4), 4
    weights = (3 * width + (depth - 1) * width * width + width * width + 3 * width + width + 3 * width) * io
    film = batch * 2 * (depth + 1) * width * f4
    n_io = batch * n * width * io  # one [B, N, W] io tensor
    full_bytes = (batch * n * 3 * f4 * 2 + weights + film + n_io * (1 + int(raw_h) + 2 * int(sft))
                  + batch * n * 4 * f4)  # pts, dirs, [alpha, lbeta] in; feat, [raw_h], rgb_sdf out
    n *= batch
    full_tc, full_small = 2 * n * width * width * depth, 2 * n * width * (3 + 3 + 1 + 3)
    tex_bytes = n * width * io * 3 + n * 3 * f4 + (width * width + 6 * width) * io + 2 * batch * width * f4 \
        + n * width * io + n * 3 * f4  # raw_h, alpha, lbeta, dirs in; feat, rgb out
    tex_tc, tex_small = 2 * n * width * width, 2 * n * width * (3 + 3)
    tc_time = 1 / PEAK_BF16_TC if precision == "serving" else 3 / PEAK_TF32_TC  # s per tensor-core flop
    out = {}
    for name, nbytes, tc, small, acts in (
            ("siren_field_full", full_bytes, full_tc, full_small, n * width * (depth + 1)),
            ("siren_field_tex", tex_bytes, tex_tc, tex_small, n * width)):
        f32_pipe = (small + 16 * acts) / PEAK_F32
        terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": max(tc * tc_time, f32_pipe)}
        by = max(terms, key=terms.get)
        out[name] = {"bound_ms": terms[by] * 1e3, "bound_by": by,
                     "epilogue_floor_ms": EPILOGUE_INSTR * acts / (PEAK_F32 / 2) * 1e3}
        if precision == "highest":
            out[name]["fma_bound_ms"] = max(terms["bytes"], (tc + small + 16 * acts) / PEAK_F32) * 1e3
    return out


def bound_keys(bd: dict) -> dict:
    """The kernels line's bound keys of one `field_bounds` entry."""
    return {k: bd[k] for k in ("bound_ms", "bound_by", "fma_bound_ms") if k in bd}


def bound_text(bd: dict) -> str:
    fma = f", f32-FMA bound {bd['fma_bound_ms']:.4f} ms" if "fma_bound_ms" in bd else ""
    return f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}){fma}"


def time_kernels(device) -> dict:
    """Each entry and its plain version at the main path's shapes (B=1,
    N=64*64*24; pass 1 without SFT writing raw_h, pass 2 with SFT), in both
    precisions: {(entry, precision): (kernel ms, plain ms)}."""
    from e3dge_torch.ops import siren_field as sf

    t = {}
    for precision in ("serving", "highest"):
        x = field_inputs(N_FULL, precision, False, device)
        full_args = (x["pts"], x["dirs"], x["pack"], x["gamma"], x["beta"])
        y = field_inputs(N_FULL, precision, True, device)
        raw_h = sf.siren_field_reference(*full_args, precision=precision, return_raw_h=True)[2]
        tex_args = (raw_h, y["dirs"], y["pack"], y["gamma"][:, -1].contiguous(), y["beta"][:, -1].contiguous(),
                    y["alpha"], y["lbeta"])
        t[("siren_field_full", precision)] = (
            cuda_ms(lambda: sf.siren_field_full(*full_args, precision=precision, return_raw_h=True)),
            cuda_ms(lambda: sf.siren_field_reference(*full_args, precision=precision, return_raw_h=True), iters=5),
        )
        t[("siren_field_tex", precision)] = (
            cuda_ms(lambda: sf.siren_field_tex(*tex_args, precision=precision)),
            cuda_ms(lambda: sf.siren_field_tex_reference(*tex_args, precision=precision), iters=5),
        )
    return t


def path_cases(n_views: int = 4) -> tuple:
    """siren_field_full in serving at the shapes of the paths beyond
    image2image, from the flagship config: (name, B, N, SFT). The SFT
    re-render of render_multiview's n_views views, and one of query_hit_prob's
    chunks: with force_background the last of the S query samples is not
    queried, so H*W*(S-1) points, each the start of an S-sample ray from the
    ref camera, split into n_chunks launches."""
    import inspect

    from e3dge_torch.config import flagship_config
    from e3dge_torch.models.volume_renderer import VolumeFeatureRenderer

    c = flagship_config().renderer
    n_chunks = inspect.signature(VolumeFeatureRenderer.query_hit_prob).parameters["n_chunks"].default
    n_query = c.out_im_res ** 2 * (c.n_samples - int(c.force_background))
    return (("novel-view SFT re-render", n_views, c.out_im_res ** 2 * c.n_samples, True),
            ("occlusion chunk", 1, -(-n_query // n_chunks) * c.n_samples, False))


def _hold(label: str, rows, precision: str) -> float:
    """Each (name, kernel output, plain output, kind) within KERNEL_TOLERANCE;
    returns the max abs error."""
    from e3dge_torch.ops import siren_field as sf

    err = 0.0
    for name, got, want, kind in rows:
        mx, mean, ok = sf.kernel_errors(got, want, kind, precision)
        tol_max, tol_mean = sf.KERNEL_TOLERANCE[precision][kind]
        log(f"  {label}: {precision} {name:13s} max {mx:.3e} mean {mean:.3e}"
            f"  [max<={tol_max:g} mean<={tol_mean:g}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"field kernel disagrees with its plain version: {label} {name}")
        err = max(err, mx)
    return err


def check_and_time_full(label: str, batch: int, n: int, sft: bool, precision: str, device,
                        sdf_only: bool = False, raw_h: bool = False) -> dict:
    """`siren_field_full` (with raw_h out if asked) on seeded operands of
    `batch` items of n points against its plain version, each output within
    KERNEL_TOLERANCE, then timed beside the plain version and the bound.
    `sdf_only`: zero view dirs, as the renderer gives an SDF query
    (`field_args` with dirs None). Returns the max abs error, both times and
    the bound."""
    from e3dge_torch.ops import siren_field as sf

    x = field_inputs(n, precision, sft, device, batch=batch)
    dirs = torch.zeros_like(x["dirs"]) if sdf_only else x["dirs"]
    args = (x["pts"], dirs, x["pack"], x["gamma"], x["beta"], x["alpha"], x["lbeta"])
    with torch.no_grad():
        got = sf.siren_field_full(*args, precision=precision, return_raw_h=raw_h)
        want = sf.siren_field_reference(*args, precision=precision, return_raw_h=raw_h)
        torch.cuda.synchronize()
        rows = [("full.feat", got[0], want[0], "hidden"), ("full.rgb_sdf", got[1], want[1], "head")]
        if raw_h:
            rows.append(("full.raw_h", got[2], want[2], "hidden"))
        err = _hold(f"{label}: B={batch} N={n} sft={int(sft)}", rows, precision)
        del got, want, rows
        ms = cuda_ms(lambda: sf.siren_field_full(*args, precision=precision, return_raw_h=raw_h))
        plain_ms = cuda_ms(lambda: sf.siren_field_reference(*args, precision=precision, return_raw_h=raw_h), iters=3)
    bd = field_bounds(n, precision, batch=batch, sft=sft, raw_h=raw_h)["siren_field_full"]
    log(f"  {label}: siren_field_full {precision} B={batch} N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{bound_text(bd)}, epilogue f32-pipe floor {bd['epilogue_floor_ms']:.4f} ms")
    del x, dirs, args
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound_keys(bd)}


def check_and_time_tex(label: str, batch: int, n: int, precision: str, device) -> dict:
    """`siren_field_tex` with SFT on a plain-version raw_h of `batch` items of
    n points against its plain version, within KERNEL_TOLERANCE, timed beside
    the plain version and the bound."""
    from e3dge_torch.ops import siren_field as sf

    x = field_inputs(n, precision, True, device, batch=batch)
    with torch.no_grad():
        raw_h = sf.siren_field_reference(x["pts"], x["dirs"], x["pack"], x["gamma"], x["beta"], precision=precision,
                                         return_raw_h=True)[2]
        args = (raw_h, x["dirs"], x["pack"], x["gamma"][:, -1].contiguous(), x["beta"][:, -1].contiguous(),
                x["alpha"], x["lbeta"])
        got, want = sf.siren_field_tex(*args, precision=precision), sf.siren_field_tex_reference(*args,
                                                                                                 precision=precision)
        torch.cuda.synchronize()
        err = _hold(f"{label}: B={batch} N={n} sft=1", [("tex.feat", got[0], want[0], "hidden"),
                                                         ("tex.rgb", got[1], want[1], "head")], precision)
        del got, want
        ms = cuda_ms(lambda: sf.siren_field_tex(*args, precision=precision))
        plain_ms = cuda_ms(lambda: sf.siren_field_tex_reference(*args, precision=precision), iters=3)
    bd = field_bounds(n, precision, batch=batch)["siren_field_tex"]
    log(f"  {label}: siren_field_tex {precision} B={batch} N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{bound_text(bd)}")
    del x, raw_h, args
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound_keys(bd)}


def check_path_shapes(device) -> None:
    """Phase 3, second part: `siren_field_full` in serving at `path_cases()`."""
    for label, batch, n, sft in path_cases():
        check_and_time_full(label, batch, n, sft, "serving", device)


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


def check_image(img: torch.Tensor, shape: tuple, what: str) -> float:
    """Fail unless img is a finite f32 tensor of `shape` whose std exceeds
    MIN_IMAGE_STD; returns the std."""
    if tuple(img.shape) != shape or img.dtype != torch.float32:
        raise AssertionError(f"{what}: unexpected output {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{what}: non-finite output")
    std = float(img.std())
    log(f"  {what} {tuple(img.shape)} finite, range [{float(img.min()):.4f}, {float(img.max()):.4f}], "
        f"std {std:.4f} [floor {MIN_IMAGE_STD:g}]")
    if not std > MIN_IMAGE_STD:
        raise AssertionError(f"{what} is constant or vanishing")
    return std


def median_call_ms(fn, calls: int = 10, warmup: int = 2) -> tuple[float, float, float]:
    """(median, min, max) host-clock ms of fn over `calls` synchronised calls."""
    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(per_call)), min(per_call), max(per_call)


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def counted(fn):
    """(fn's result, the field kernels' launch counts over that one call)."""
    from e3dge_torch.ops import siren_field as sf

    torch.cuda.synchronize()
    sf.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(sf.launch_counts)


def counted_split(fn):
    """As `counted`, with the same call's launches also split by precision:
    (fn's result, {entry: n}, {(entry, precision): n})."""
    from e3dge_torch.ops import siren_field as sf

    out, counts = counted(fn)
    return out, counts, dict(sf.precision_launch_counts)


def split_text(split: dict) -> str:
    return ", ".join(f"{e}/{p} {n}" for (e, p), n in split.items() if n) or "none"


def run_flagship(device):
    """Phase 4: counts from one image2image call, output checks, ms/inversion,
    peak memory, and where that time goes. Returns the counts, the median ms,
    gen_imgs, and the model with its device inputs for phase 6."""
    from e3dge_torch.config import flagship_config
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.utils.weights import init_weights

    cfg = flagship_config()
    t0 = time.perf_counter()
    model = E3DGE(cfg)  # device=None: the card
    init_weights(model, SEED)
    images, ml, noise = to_device(*seeded_inputs(cfg, SEED), decoder_noise(cfg, 1, SEED), device)
    torch.cuda.synchronize()
    log(f"  model built + seeded weights: {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    out, counts = counted(lambda: model.image2image(images, ml, noise=noise))
    log(f"  launch counts over one image2image: {counts}")
    if counts != {"siren_field_full": 1, "siren_field_tex": 1}:
        raise AssertionError(f"image2image did not launch each field kernel once: {counts}")
    img = out["res_render_out"]["gen_imgs"].cpu()
    check_image(img, (1, 3, 1024, 1024), "gen_imgs")

    call = lambda: model.image2image(images, ml, noise=noise)  # noqa: E731
    # the path is host-bound at B=1, so host noise shows: per-call times, median
    ms, lo, hi = median_call_ms(call, calls=20, warmup=3)
    log(f"  image2image flagship bf16, B=1, 256^2 -> 1024^2: median {ms:.2f} ms per inversion "
        f"({1e3 / ms:.3f} inversions/s) over 20 calls, min {lo:.2f}, max {hi:.2f}; "
        f"peak memory {peak_gib():.2f} GiB")
    profile_flagship(model, call, ms)
    del out
    torch.cuda.empty_cache()
    return counts, ms, img, (model, images, ml, noise)


def device_kernels(call, iters: int) -> tuple[dict, dict]:
    """Device time (us) and launches by kernel name over `iters` calls, from
    torch.profiler's CUDA events. User annotations on the device timeline (the
    optimizer's `Optimizer.step#...` range) span kernels, so they are left
    out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    kernel_us, launches = defaultdict(float), defaultdict(int)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            kernel_us[ev.name] += ev.time_range.elapsed_us()
            launches[ev.name] += 1
    return kernel_us, launches


def profile_flagship(model, call, wall_ms: float, iters: int = 5) -> None:
    """Where one inversion's time goes: per-stage CUDA-event ms at the top
    modules' forward hooks (host gaps inside a stage included), the device
    busy ms and its share of the unprofiled wall time (torch.profiler), and the
    top device kernels by total time."""
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

    kernel_us, launches = device_kernels(call, iters)
    busy_ms = sum(kernel_us.values()) / iters / 1e3
    log(f"  device busy {busy_ms:.3f} ms per inversion in {sum(launches.values()) // iters} launches; "
        f"busy share {busy_ms / wall_ms:.3f} of the {wall_ms:.2f} ms median wall; stages sum {staged:.3f} ms")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  kernel {us / iters / 1e3:8.4f} ms {launches[name] // iters:5d}x  {name[:100]}")


def run_card_vs_cpu(device, bf16_img: torch.Tensor):
    """Phase 5: f32 image2image on the card and on the CPU with phase 4's
    weights, input and noise; then phase 4's bf16 image against the f32 one.
    Returns the f32 card model with its device inputs and its image."""
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
            card = (model, d_images, d_ml, d_noise)
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
    return card, outs["cuda"]


# phase 6c's novel camera: azimuth in radians, at the reference's elevation
NOVEL_AZIM = 0.25
# the paths whose launch counts the kernels line carries under the serving
# entries, in order; latent2surface's SDF grid and the training paths launch
# the `highest` entries (their own lines)
PATHS = ("image2image", "render_multiview", "occlusion_exact", "image2image_global")


def run_paths(device, flagship, f32_card, f32_img: torch.Tensor, bf16_img: torch.Tensor) -> dict:
    """Phase 6: the inference paths beyond image2image on phase 4's model,
    input and noise (and phase 5's f32 card model for 6b). Each path's launch
    counts are read over one call and must match; returns them by path."""
    from e3dge_torch.config import _with
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.render.camera import camera_params_from_angles
    from e3dge_torch.runner import Runner
    from e3dge_torch.utils import mesh

    model, images, ml, noise = flagship
    cfg = model.cfg
    runner = Runner(model, ml, device)
    ref_info = runner.encode_ref(images)
    paths = {}

    def expect(path, counts, full, tex):
        log(f"  launch counts over one {path}: {counts}")
        if counts != {"siren_field_full": full, "siren_field_tex": tex}:
            raise AssertionError(f"{path} launched {counts}, expected {full} + {tex}")
        paths[path] = counts

    def timed(what, fn, per=None):
        ms, lo, hi = median_call_ms(fn)
        peak = peak_gib()
        kernel_us, launches = device_kernels(fn, 3)
        busy = sum(kernel_us.values()) / 3e3
        field = sum(us for name, us in kernel_us.items() if "siren_field" in name) / 3e3
        extra = f", {ms / per[0]:.2f} ms per {per[1]}" if per else ""
        log(f"  {what}: median {ms:.2f} ms per call{extra} over 10 calls (min {lo:.2f}, max {hi:.2f}); "
            f"device busy {busy:.3f} ms in {sum(launches.values()) // 3} launches (field kernel {field:.3f} ms), "
            f"busy share {busy / ms:.3f}; peak memory {peak:.2f} GiB")

    log("  [6a] Runner.render_video: 4 views batched (render_multiview)")
    torch.cuda.reset_peak_memory_stats()
    video = lambda: runner.render_video(images, n_views=4, batched=True, noise=noise, ref_info=ref_info)  # noqa: E731
    frames, counts = counted(video)
    expect("render_multiview", counts, 2, 0)
    frames = frames.cpu()
    check_image(frames, (1, 4, 3, 1024, 1024), "frames")
    d03 = float((frames[:, 0] - frames[:, 3]).abs().mean())
    log(f"  views 0 and 3: mean abs difference {d03:.4f} [floor {MIN_IMAGE_STD:g}]")
    if not d03 > MIN_IMAGE_STD:
        raise AssertionError("the novel views do not differ")
    del frames
    timed("render_multiview flagship bf16, B=1 x 4 views", video, per=(4, "view"))

    log("  [6b] generic que_render_given_ref at the ref camera against the same-view image")

    def generic(m, ref, n):
        return m.que_render_given_ref(ref, ref["cam_settings"], que_info=ref["global_render_out"],
                                      same_view=False, reuse_backbone=False, noise=n)

    model32, images32, ml32, noise32 = f32_card
    ref32 = model32.encode_ref_images(images32, ml32)
    out, counts = counted(lambda: generic(model32, ref32, noise32))
    expect("generic_novel_view f32", counts, 1, 0)
    diff = float((out["res_render_out"]["gen_imgs"].float().cpu() - f32_img).abs().max())
    ok = diff <= TOL_CARD_VS_CPU and math.isfinite(diff)
    log(f"  f32 generic vs same-view gen_imgs: max abs {diff:.3e} [tol {TOL_CARD_VS_CPU:g}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the generic branch disagrees with the same-view one in f32")
    del out, ref32
    torch.cuda.reset_peak_memory_stats()
    out, counts = counted(lambda: generic(model, ref_info, noise))
    expect("generic_novel_view", counts, 1, 0)
    img = out["res_render_out"]["gen_imgs"].float().cpu()
    rel = float(((img - bf16_img).abs() / (bf16_img.abs().max() + 1e-6)).mean())
    ok = rel < TOL_BF16_VS_F32_REL
    log(f"  bf16 generic vs same-view gen_imgs: mean rel err {rel:.4e} [tol {TOL_BF16_VS_F32_REL:g}] "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the generic branch disagrees with the same-view one in bf16")
    del out
    timed("generic que_render_given_ref flagship bf16, B=1", lambda: generic(model, ref_info, noise))

    log(f"  [6c] ref-view occlusion weighting at azim {NOVEL_AZIM:+g}")
    cam = camera_params_from_angles(torch.full((1,), NOVEL_AZIM, device=device), ref_info["cam_settings"].viewpoint[:, 1],
                                    cfg.renderer.out_im_res, cfg.camera.fov_ang, cfg.camera.dist_radius)
    hit_prob = {}
    for mode, full in (("exact", 18), ("texture", 2)):
        model.cfg = _with(cfg, renderer=dict(occlusion_mode=mode))
        call = lambda: model.que_render_given_ref(ref_info, cam, use_ref_view_weight=True, noise=noise)  # noqa: E731
        torch.cuda.reset_peak_memory_stats()
        out, counts = counted(call)
        expect(f"occlusion_{mode}", counts, full, 0)
        hp = out["ref_hit_prob"].float()
        body, last = hp[..., :-1, :], hp[..., -1, :]
        lo, hi = float(body.min()), float(body.max())
        log(f"  {mode}: ref_hit_prob {tuple(hp.shape)}, samples before the last in [{lo:.4e}, {hi:.4e}] "
            f"[within -1e-3, 1+1e-3]; the last (1 - sum) in [{float(last.min()):.4e}, {float(last.max()):.4e}]")
        if not bool(torch.isfinite(hp).all()) or lo < -1e-3 or hi > 1 + 1e-3:
            raise AssertionError(f"{mode} ref_hit_prob out of range")
        check_image(out["res_render_out"]["gen_imgs"].cpu(), (1, 3, 1024, 1024), f"{mode} gen_imgs")
        hit_prob[mode] = hp
        del out
        timed(f"que_render_given_ref + {mode} occlusion flagship bf16, B=1", call)
    model.cfg = cfg
    d = (hit_prob["exact"] - hit_prob["texture"]).abs()
    log(f"  exact vs texture ref_hit_prob: max abs {float(d.max()):.4e}, mean abs {float(d.mean()):.4e}")
    del hit_prob, d

    log("  [6d] image2image_global (no local branch)")
    model_g = E3DGE(_with(cfg, renderer=dict(enable_local_model=False)), device=device)
    model_g.load_state_dict({k: v for k, v in model.state_dict().items()
                             if k.split(".")[0] in ("encoder", "generator", "volume_discriminator")}, strict=True)
    call = lambda: model_g.image2image_global(images, ml, noise=noise)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    out, counts = counted(call)
    expect("image2image_global", counts, 1, 0)
    check_image(out["gen_imgs"].cpu(), (1, 3, 1024, 1024), "global gen_imgs")
    del out
    timed("image2image_global flagship bf16, B=1", call)
    del model_g

    log("  [6e] Runner.latent2surface")
    t0 = time.perf_counter()
    lib = mesh.build_marching_library()
    log(f"  marching library built in {time.perf_counter() - t0:.2f} s: {lib.name}")
    torch.cuda.reset_peak_memory_stats()
    surf = lambda: runner.latent2surface(ref_info["pred_latents"])  # noqa: E731
    meshes, counts = counted(surf)
    expect("latent2surface", counts, 1, 0)
    verts, faces = meshes[0]
    log(f"  mesh: {len(verts)} vertices, {len(faces)} faces (seeded weights may give an empty surface)")
    renderer, styles = model.generator.renderer, ref_info["pred_latents"][0]
    cam0 = camera_params_from_angles(torch.zeros(1, device=device), torch.zeros(1, device=device),
                                     cfg.renderer.out_im_res, cfg.camera.fov_ang, cfg.camera.dist_radius)
    precision = "highest"  # the SDF queries run in f32 in every config, as JAX's
    sdf = renderer.render_sdf_grid(cam0, styles)
    args = renderer.field_args(renderer.sdf_grid_points(cam0), None, styles, precision)
    plain = sf.siren_field_reference(*args, precision=precision)[1][..., 3:4]
    mx, mean, ok = sf.kernel_errors(sdf.reshape(plain.shape), plain, "head", precision)
    tol_max, tol_mean = sf.KERNEL_TOLERANCE[precision]["head"]
    log(f"  SDF grid {tuple(sdf.shape)} against the plain field: max {mx:.3e} mean {mean:.3e} "
        f"[max<={tol_max:g} mean<={tol_mean:g}] {'ok' if ok else 'FAIL'}; sdf in [{float(sdf.min()):.4f}, "
        f"{float(sdf.max()):.4f}]")
    if not ok:
        raise AssertionError("the SDF grid disagrees with the plain field")
    timed("latent2surface flagship, B=1 (f32 SDF grid + align + marching + weld)", surf)
    return paths


# Phase 7: stage-1 training at stage1_config's full width
ST1_BATCH, ST1_WARMUP, ST1_STEPS, ST1_LR = 4, 2, 5, 5e-5
ST1_TERMS = ("loss_l2", "loss_lpips", "loss_id", "latent_gt", "sdf_rec_loss", "surf_rec_loss",
             "surface_norm_rec_loss", "eikonal_term", "thumb_rec")
# field kernel launches per stage-1 step: the frozen-GAN render and its two
# SDF-target queries, under no_grad; every differentiable query runs the twin
ST1_LAUNCHES = {"siren_field_full": 3, "siren_field_tex": 0}
# card vs CPU on one stage-1 step of a reduced config, f32, TF32 off. The
# CPU reference runs at ST1_CPU_THREADS threads, so its summation order does
# not move with the host's core count; a second CPU step at 1 thread reads
# the size of that order's own effect. Gates: each loss term within a
# relative 1e-3; E0's gradient, all leaves together, within a relative L2 of
# ST1_TOL_GRAD, and each leaf within ST1_TOL_LEAF (the worst leaf is a deep
# block's train-mode BN bias, a small sum of large terms). Control: the card
# step with the eikonal double backward cut (the predicted SDF gradients
# taken as constants) must fail the gradient gate.
ST1_TOL_TERM, ST1_TOL_GRAD, ST1_TOL_LEAF = 1e-3, 1e-2, 3e-2
ST1_CPU_THREADS = 8


def st1_reduced_config():
    """stage1_config cut for the card-vs-CPU check: the field at depth 8 and
    width 256 (so the kernel samples the batch) rendering 32^2, the decoder to
    128^2, E0 unchanged."""
    from e3dge_torch.config import _with, stage1_config

    return _with(stage1_config(), renderer=dict(out_im_res=32), decoder=dict(size=128, in_res=32),
                 encoder=dict(n_styles_decoder=6)).validate()


def st1_model(cfg, device):
    """(model, mean latents, lpips_fn, id_fn, train state): seeded weights
    (init_weights), phase 4's seeded mean latents, seeded perceptual nets, E0
    trainable under Adam at ST1_LR."""
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.training import steps
    from e3dge_torch.training.perceptual import make_perceptual_fns
    from e3dge_torch.utils.weights import init_weights

    model = E3DGE(cfg, device=device)
    init_weights(model, SEED)
    ml = to_device(*seeded_inputs(cfg, SEED), [], device)[1]
    lpips_fn, id_fn = make_perceptual_fns(device, seed=SEED)
    state = steps.create_train_state(model, steps.STAGE1_TRAINABLE, ST1_LR, "adam")
    return model, ml, lpips_fn, id_fn, state


def st1_kernel_cases() -> tuple:
    """The stage-1 step's three `siren_field_full` launches, all `highest`
    and without raw_h, from stage1_config: (label, B, N, SDF-only). The
    frozen-GAN render (out_im_res^2 rays x n_samples), the near-surface SDF
    targets (one point per ray, `sample_near_surface_grid`) and the uniform
    ones (`uniform_grid_sampling_num` points, `sample_uniform_grid`)."""
    from e3dge_torch.config import stage1_config

    c = stage1_config().renderer
    return (("stage-1 sample render", ST1_BATCH, c.out_im_res ** 2 * c.n_samples, False),
            ("stage-1 near-surface SDF targets", ST1_BATCH, c.out_im_res ** 2, True),
            ("stage-1 uniform SDF targets", ST1_BATCH, c.uniform_grid_sampling_num, True))


def st1_kernel_check(device) -> dict:
    """`siren_field_full` in `highest` at each of `st1_kernel_cases()`
    against its plain version, timed. Returns the render's figures (the
    kernels line's row) with the max abs error over all three shapes, and
    each shape's figures under "shapes"."""
    shapes = []
    for label, batch, n, sdf_only in st1_kernel_cases():
        r = check_and_time_full(label, batch, n, False, "highest", device, sdf_only=sdf_only)
        shapes.append({"label": label, "batch": batch, "n": n, **r})
    render = {k: shapes[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "fma_bound_ms")}
    return {**render, "max_abs_err": max(r["max_abs_err"] for r in shapes), "shapes": shapes}


def run_stage1(device) -> dict:
    """Phase 7: stage-1 training at stage1_config (64^2 x 18 field samples,
    SIREN 8 x 256, IR-SE-50 at 256^2, decoder to 1024^2, f32), B=4:
    ST1_WARMUP + ST1_STEPS steps, each timed by CUDA events in four parts and
    its field launches counted; then the checks (finite terms, E0 moved, the
    rest frozen, a gradient on the renderer W+) and a profile of two steps.
    Returns the launch counts of the measured steps and the kernel check."""
    from e3dge_torch.config import stage1_config
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.training import steps

    kernel = st1_kernel_check(device)
    cfg = stage1_config()
    t0 = time.perf_counter()
    model, ml, lpips_fn, id_fn, state = st1_model(cfg, device)
    gen = torch.Generator(device).manual_seed(SEED)
    torch.cuda.synchronize()
    log(f"  model, mean latents, perceptual nets built: {time.perf_counter() - t0:.1f} s")
    frozen = {f"model.{k}": v.clone() for k, v in model.state_dict().items() if not k.startswith("encoder.")}
    frozen.update({f"lpips.{k}": v.clone() for k, v in lpips_fn.state_dict().items()})
    frozen.update({f"id.{k}": v.clone() for k, v in id_fn.state_dict().items()})
    e0_before = {k: v.clone() for k, v in model.encoder.state_dict().items()}

    def one_step(retain: bool = False):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        noise = steps.decoder_noise(model, ST1_BATCH, gen)
        batch = model.synthetic_sample(ST1_BATCH, 1.0, generator=gen, noise=noise)
        ev[1].record()
        loss, metrics, out = steps.stage1_loss(model, batch, ml, steps.STAGE1_LAMBDAS, lpips_fn, id_fn, noise=noise)
        if retain:
            out["pred_latents"][0].retain_grad()
        ev[2].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        steps.optimizer_step(state)
        ev[4].record()
        return ev, metrics, out["pred_latents"][0] if retain else None

    torch.cuda.reset_peak_memory_stats()
    parts, counts = [], []
    for i in range(ST1_WARMUP + ST1_STEPS):
        (ev, metrics, w_plus), c = counted(lambda: one_step(retain=i == 0))
        counts.append(c)
        if c != ST1_LAUNCHES:
            raise AssertionError(f"stage-1 step {i} launched {c}, expected {ST1_LAUNCHES}")
        if i == 0:
            g = w_plus.grad
            gmax = float(g.abs().max()) if g is not None else 0.0
            log(f"  renderer W+ gradient after step 0: max abs {gmax:.3e} (G0 differentiated by the twin)")
            if not gmax > 0 or not math.isfinite(gmax):
                raise AssertionError("no gradient reached the renderer W+")
            del w_plus, g
        bad = [k for k in ST1_TERMS if k not in metrics or not math.isfinite(float(metrics[k].detach()))]
        if bad:
            raise AssertionError(f"stage-1 step {i}: missing or non-finite terms {bad}")
        if i >= ST1_WARMUP:
            parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
        log(f"  step {i}{' (warm-up)' if i < ST1_WARMUP else ''}: " + ", ".join(
            f"{k} {float(metrics[k].detach()):.5g}" for k in ("loss",) + ST1_TERMS))
    peak = peak_gib()
    parts = np.asarray(parts)
    total = parts.sum(axis=1)
    log(f"  ms per stage-1 step (B={ST1_BATCH}, CUDA events over {ST1_STEPS} steps): median {np.median(total):.2f}, "
        f"min {total.min():.2f}, max {total.max():.2f}; median sampling {np.median(parts[:, 0]):.2f}, forward+loss "
        f"{np.median(parts[:, 1]):.2f}, backward {np.median(parts[:, 2]):.2f}, optimizer {np.median(parts[:, 3]):.2f}; "
        f"peak memory {peak:.2f} GiB")
    launches = {k: sum(c[k] for c in counts[ST1_WARMUP:]) for k in ST1_LAUNCHES}
    log(f"  field kernel launches over the {ST1_STEPS} measured steps: {launches} "
        f"({ST1_LAUNCHES} per step, as expected)")

    after = model.encoder.state_dict()
    moved_p = sum(not torch.equal(after[k], e0_before[k]) for k, _ in model.encoder.named_parameters())
    moved_bn = sum(not torch.equal(after[k], e0_before[k]) for k in after if "running_" in k)
    n_p = len(list(model.encoder.named_parameters()))
    n_bn = sum("running_" in k for k in after)
    log(f"  E0: {moved_p} of {n_p} parameters and {moved_bn} of {n_bn} BN running statistics moved")
    if moved_p < n_p // 2 or moved_bn != n_bn:
        raise AssertionError("E0's parameters or BN running statistics did not move")
    now = {f"model.{k}": v for k, v in model.state_dict().items() if not k.startswith("encoder.")}
    now.update({f"lpips.{k}": v for k, v in lpips_fn.state_dict().items()})
    now.update({f"id.{k}": v for k, v in id_fn.state_dict().items()})
    changed = [k for k in frozen if not torch.equal(frozen[k], now[k])]
    log(f"  generator, volume D and perceptual nets: {len(frozen) - len(changed)} of {len(frozen)} tensors "
        f"bit-identical")
    if changed:
        raise AssertionError(f"frozen tensors changed: {changed[:5]}")
    if any(p.grad is not None for n, p in model.named_parameters() if not n.startswith("encoder.")):
        raise AssertionError("a frozen parameter received a gradient")

    wall_ms = float(np.median(total))
    kernel_us, n_launch = device_kernels(lambda: one_step(), 2)
    busy = sum(kernel_us.values()) / 2e3
    field = sum(us for name, us in kernel_us.items() if "siren_field" in name) / 2e3
    log(f"  device busy {busy:.3f} ms per step in {sum(n_launch.values()) // 2} launches (field kernel {field:.3f} ms); "
        f"busy share {busy / wall_ms:.3f} of the {wall_ms:.2f} ms median step")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  kernel {us / 2e3:8.4f} ms {n_launch[name] // 2:5d}x  {name[:100]}")
    del model, state, lpips_fn, id_fn, frozen, e0_before
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": counts[-1], "kernel": kernel}


# a leaf whose reference gradient is below this share of the whole gradient's
# norm is zero but for rounding (a BatchNorm shift that feeds only other
# train-mode BatchNorms, as in the ADA aligner): its error is taken against
# that floor, not against its own noise
LEAF_FLOOR = 1e-6


def grad_gap(got: dict, want: dict) -> tuple[float, str, float]:
    """(relative L2 of all leaves together, the worst leaf, its relative L2,
    each leaf's against max(its norm, LEAF_FLOOR x the whole norm))."""
    num = sum(float((got[k] - want[k]).double().square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    floor = LEAF_FLOOR * math.sqrt(den)
    leaf = {k: float((got[k] - want[k]).norm()) / max(float(want[k].norm()), floor, 1e-30) for k in want}
    worst = max(leaf, key=leaf.get)
    return math.sqrt(num / den), worst, leaf[worst]


def st1_card_vs_cpu(device) -> None:
    """Phase 7, last part: one stage-1 step of `st1_reduced_config` at B=2,
    same weights, from one batch made on the card (the kernel samples it):
    the loss terms and E0 gradients on the card, on the card with the eikonal
    double backward cut (the control), on the CPU at ST1_CPU_THREADS threads
    (the reference) and at 1 thread, each compared with the reference."""
    from unittest import mock

    from e3dge_torch.render.camera import CameraParams
    from e3dge_torch.training import steps

    def to(x, dev):
        return CameraParams(*(f.to(dev) for f in x)) if isinstance(x, CameraParams) else x.to(dev)

    eikonal = steps.eikonal_term

    def cut_eikonal(renderer, pts, styles, create_graph=False):
        return eikonal(renderer, pts, styles, create_graph=False)

    cfg = st1_reduced_config()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    threads = torch.get_num_threads()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs, data = {}, {}
    try:
        for name, dev, n_threads, cut in (("card", device, None, False),
                                          ("card, double backward cut", device, None, True),
                                          ("CPU", torch.device("cpu"), ST1_CPU_THREADS, False),
                                          ("CPU at 1 thread", torch.device("cpu"), 1, False)):
            t0 = time.perf_counter()
            torch.set_num_threads(n_threads or threads)
            model, ml, lpips_fn, id_fn, state = st1_model(cfg, dev)
            if not data:  # on the card
                gen = torch.Generator(dev).manual_seed(SEED)
                data["noise"] = steps.decoder_noise(model, 2, gen)
                data["batch"] = model.synthetic_sample(2, 1.0, generator=gen, noise=data["noise"])
            b = {k: to(v, dev) for k, v in data["batch"].items()}
            with mock.patch.object(steps, "eikonal_term", cut_eikonal) if cut else contextlib.nullcontext():
                loss, metrics, _ = steps.stage1_loss(model, b, ml, steps.STAGE1_LAMBDAS, lpips_fn, id_fn,
                                                     noise=[n.to(dev) for n in data["noise"]])
            loss.backward()
            runs[name] = ({k: float(metrics[k].detach()) for k in ("loss",) + ST1_TERMS},
                          {k: p.grad.detach().float().cpu() for k, p in state.params.items()})
            log(f"  reduced stage-1 step, {name}: {time.perf_counter() - t0:.1f} s (build + one step)")
            del model, state, lpips_fn, id_fn, loss, metrics, b
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_num_threads(threads)
    m_ref, g_ref = runs["CPU"]
    log("  terms card / CPU: " + ", ".join(f"{k} {runs['card'][0][k]:.6g} / {m_ref[k]:.6g}" for k in m_ref))
    gaps = {}
    for name in ("card", "CPU at 1 thread", "card, double backward cut"):
        m, g = runs[name]
        term = max(abs(m[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-30) for k in m_ref)
        gaps[name] = (term, *grad_gap(g, g_ref))
        log(f"  {name} vs CPU at {ST1_CPU_THREADS} threads: worst term relative error {term:.3e}; E0 gradient "
            f"relative L2 {gaps[name][1]:.3e} over {len(g_ref)} leaves, worst leaf {gaps[name][3]:.3e} at "
            f"{gaps[name][2]}")
    term, glob, _, leaf = gaps["card"]
    ok = term < ST1_TOL_TERM and glob < ST1_TOL_GRAD and leaf < ST1_TOL_LEAF
    log(f"  card vs CPU [terms < {ST1_TOL_TERM:g}, gradient < {ST1_TOL_GRAD:g}, each leaf < {ST1_TOL_LEAF:g}]: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the stage-1 step disagrees between the card and the CPU")
    _, glob, _, leaf = gaps["card, double backward cut"]
    seen = glob >= ST1_TOL_GRAD or leaf >= ST1_TOL_LEAF
    log(f"  control (double backward cut) {'fails' if seen else 'PASSES'} the gradient gate")
    if not seen:
        raise AssertionError("the gradient gate does not see the eikonal double backward")


# Phase 8: stage-2.2 training at stage2_config's full width (the stage2.2.sh
# recipe: l2 1, lpips 1, id 0.1, res 1, adv 0.01, the D's lambda 0.01, r1 60
# every 16 D steps, --fix-ada, --ema, --pose-curriculum; Adam at 5e-5)
ST2_BATCH, ST2_WARMUP, ST2_ITERS, ST2_LR = 4, 2, 4, 5e-5
ST2_LAMBDAS = dict(l2_lambda=1.0, lpips_lambda=1.0, id_lambda=0.1, res_lambda=1.0, adv_lambda=0.01)
ST2_D_LAMBDAS, ST2_D_REG_EVERY = dict(discriminator_lambda=0.01, r1=60.0), 16
ST2_TERMS = ("loss_l2", "loss_lpips", "loss_id", "loss_e_adv", "thumb_rec", "res_loss")
# field kernel launches per iteration, all `highest` and no_grad: the E step
# samples (render + 2 SDF targets), renders the ref view and the query view
# (raw_h kept; the conditioned re-render is the twin's texture head on it);
# the full-res D's fake producer samples (3) and runs image2image (its render
# and its texture pass)
ST2_E_LAUNCHES = {"siren_field_full": 5, "siren_field_tex": 0}
ST2_D_LAUNCHES = {"siren_field_full": 4, "siren_field_tex": 1}
# the E-step parts timed by CUDA events, in order
ST2_PARTS = ("D producer", "D step", "sampling", "forward+loss", "backward", "optimizer+EMA")


def st2_kernel_cases() -> tuple:
    """The stage-2 iteration's launch shapes new to the `highest` kernel,
    from stage2_config: (label, entry, B, N, raw_h). The sample, ref and
    fake-producer renders (B x out_im_res^2 x n_samples points, no raw_h),
    the query and image2image renders (raw_h out), and image2image's texture
    pass (SFT in). The SDF targets' shapes are stage 1's."""
    from e3dge_torch.config import stage2_config

    c = stage2_config().renderer
    n = c.out_im_res ** 2 * c.n_samples
    return (("stage-2 sample / ref render", "siren_field_full", ST2_BATCH, n, False),
            ("stage-2 query render, raw_h out", "siren_field_full", ST2_BATCH, n, True),
            ("stage-2 D producer texture pass", "siren_field_tex", ST2_BATCH, n, False))


def st2_kernel_check(device) -> dict:
    """`highest` at each of `st2_kernel_cases()` against its plain version,
    timed; {label: figures}."""
    out = {}
    for label, entry, batch, n, raw_h in st2_kernel_cases():
        if entry == "siren_field_tex":
            r = check_and_time_tex(label, batch, n, "highest", device)
        else:
            r = check_and_time_full(label, batch, n, False, "highest", device, raw_h=raw_h)
        out[label] = {"entry": entry, "batch": batch, "n": n, "raw_h": raw_h, **r}
    return out


def st2_model(cfg, device, trainable, d_res: int):
    """(model, mean latents, lpips_fn, id_fn, train state with EMA, the
    full-res D): seeded weights, phase 4's seeded mean latents, seeded
    perceptual nets, Adam at ST2_LR; the D seeded from SEED + 3, frozen
    outside its step."""
    from e3dge_torch.models.discriminator import Discriminator
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.training import steps
    from e3dge_torch.training.perceptual import make_perceptual_fns
    from e3dge_torch.utils.weights import init_weights

    model = E3DGE(cfg, device=device)
    init_weights(model, SEED)
    ml = to_device(*seeded_inputs(cfg, SEED), [], device)[1]
    lpips_fn, id_fn = make_perceptual_fns(device, seed=SEED)
    state = steps.create_train_state(model, trainable, ST2_LR, "adam", ema=True)
    d = Discriminator(d_res).to(device)
    init_weights(d, SEED + 3)
    return model, ml, lpips_fn, id_fn, state, d.requires_grad_(False)


def run_stage2(device) -> dict:
    """Phase 8: stage-2.2 training at stage2_config (64^2 x 24 field samples,
    SIREN 8 x 256, IR-SE-50 at 256^2, 4-stack hourglass, decoder to 1024^2,
    f32), B=4, the full-res D at 256^2: ST2_WARMUP + ST2_ITERS iterations of
    (D producer, D step, E step), each part timed by CUDA events and each
    half's field launches counted; the checks (finite terms, what moves and
    what stays, the EMA, an R1 step), a warm D step with R1 timed, and a
    profile of two iterations. Returns the launch counts and the kernel
    check."""
    from e3dge_torch.config import stage2_config
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.training import steps

    kernel = st2_kernel_check(device)
    cfg = stage2_config()
    d_res = min(cfg.decoder.size, 256)
    t0 = time.perf_counter()
    model, ml, lpips_fn, id_fn, state, d = st2_model(cfg, device, steps.stage22_trainable(fix_ada=True), d_res)
    d_state = steps.create_d_state(d, ST2_LR * ST2_D_REG_EVERY / (ST2_D_REG_EVERY + 1))
    d_step = steps.make_full_d_step(ST2_D_LAMBDAS, d_state, ST2_D_REG_EVERY)
    schedule = steps.pose_curriculum()
    gen = torch.Generator(device).manual_seed(SEED)
    torch.cuda.synchronize()
    log(f"  model, mean latents, perceptual nets, D built: {time.perf_counter() - t0:.1f} s")
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    frozen_nets = {f"lpips.{k}": v.clone() for k, v in lpips_fn.state_dict().items()}
    frozen_nets.update({f"id.{k}": v.clone() for k, v in id_fn.state_dict().items()})
    d0 = {k: v.clone() for k, v in d.state_dict().items()}

    def one_iter():
        """(CUDA events, E metrics, D metrics, D-half launches, E-half launches)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(ST2_PARTS) + 1)]
        sf.reset_launch_counts()
        ev[0].record()
        fakes, reals = steps.full_d_batch(model, ml, ST2_BATCH, d_res, gen)
        ev[1].record()
        d_metrics = d_step(reals, fakes)
        ev[2].record()
        d_counts = dict(sf.launch_counts)
        noise = steps.decoder_noise(model, ST2_BATCH, gen)
        batch = model.synthetic_sample(ST2_BATCH, schedule(state.step), pair_same_id=True, generator=gen,
                                       noise=noise)
        ev[3].record()
        loss, metrics, _ = steps.cycle_loss(model, batch, ml, ST2_LAMBDAS, lpips_fn, id_fn, d_fn=d, noise=noise)
        ev[4].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[5].record()
        steps.optimizer_step(state)
        ev[6].record()
        torch.cuda.synchronize()
        e_counts = {k: v - d_counts[k] for k, v in sf.launch_counts.items()}
        return ev, metrics, d_metrics, d_counts, e_counts

    torch.cuda.reset_peak_memory_stats()
    parts, r1 = [], []
    for i in range(ST2_WARMUP + ST2_ITERS):
        before = {k: p.detach().clone() for k, p in state.params.items()} if i == 0 else None
        ev, metrics, d_metrics, d_counts, e_counts = one_iter()
        if (d_counts, e_counts) != (ST2_D_LAUNCHES, ST2_E_LAUNCHES):
            raise AssertionError(f"stage-2 iteration {i} launched {d_counts} + {e_counts}, expected "
                                 f"{ST2_D_LAUNCHES} + {ST2_E_LAUNCHES}")
        if i == 0:  # the EMA after one step: decay x old + (1 - decay) x new, so between them
            worst = 0.0
            for k, p in state.params.items():
                lo, hi = torch.minimum(before[k], p.detach()), torch.maximum(before[k], p.detach())
                e = state.ema[k]
                out = torch.maximum(torch.clamp(lo - e, min=0), torch.clamp(e - hi, min=0)) / (1 + e.abs())
                worst = max(worst, float(out.max()))
            log(f"  EMA after step 0: furthest outside [old, new] {worst:.3e} relative (f32 rounding at most)")
            if worst > 1e-6:
                raise AssertionError("the EMA does not lie between the old and the new parameters")
            del before
        vals = {k: float(metrics[k].detach()) for k in ("loss",) + ST2_TERMS if k in metrics}
        vals.update({f"d_{k}": float(v) for k, v in d_metrics.items()})
        bad = [k for k in ("loss",) + ST2_TERMS + ("d_d", "d_r1") if k not in vals or not math.isfinite(vals[k])]
        if bad:
            raise AssertionError(f"stage-2 iteration {i}: missing or non-finite terms {bad}")
        r1.append(vals["d_r1"])
        if i >= ST2_WARMUP:
            parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(len(ST2_PARTS))])
        log(f"  iteration {i}{' (warm-up)' if i < ST2_WARMUP else ''}: "
            + ", ".join(f"{k} {v:.5g}" for k, v in vals.items()))
    peak = peak_gib()
    if not (r1[0] > 0 and all(v == 0 for v in r1[1:])):
        raise AssertionError(f"lazy R1 not at D step 0 only: {r1}")
    parts = np.asarray(parts)
    total = parts.sum(axis=1)
    log(f"  ms per stage-2 iteration (B={ST2_BATCH}, CUDA events over {ST2_ITERS} iterations): median "
        f"{np.median(total):.2f}, min {total.min():.2f}, max {total.max():.2f}; median "
        + ", ".join(f"{name} {np.median(parts[:, j]):.2f}" for j, name in enumerate(ST2_PARTS))
        + f"; peak memory {peak:.2f} GiB")
    # a warm D step with the lazy R1 (it fires at every ST2_D_REG_EVERY-th D step)
    fakes, reals = steps.full_d_batch(model, ml, ST2_BATCH, d_res, gen)
    d_state.step = ST2_D_REG_EVERY * (d_state.step // ST2_D_REG_EVERY + 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    dm = d_step(reals, fakes)
    ev[1].record()
    torch.cuda.synchronize()
    log(f"  D step with R1 (warm, step {d_state.step - 1}): {ev[0].elapsed_time(ev[1]):.2f} ms, "
        f"r1 {float(dm['r1']):.4g}; without R1: median {np.median(parts[:, 1]):.2f} ms")
    d_state.step = ST2_D_REG_EVERY * (d_state.step // ST2_D_REG_EVERY + 1)
    kernel_us, n_launch = device_kernels(lambda: d_step(reals, fakes), 1)
    log(f"  that D step with R1 again, profiled: device busy {sum(kernel_us.values()) / 1e3:.3f} ms in "
        f"{sum(n_launch.values())} launches")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  kernel {us / 1e3:8.4f} ms {n_launch[name]:5d}x  {name[:100]}")
    del fakes, reals

    sd = model.state_dict()
    tops = ("local", "fuse_sft_block", "grid_align", "encoder")
    moved = {top: sum(not torch.equal(p, sd0[f"{top}.{k}"]) for k, p in getattr(model, top).named_parameters())
             for top in tops}
    n_p = {top: sum(1 for _ in getattr(model, top).parameters()) for top in tops}
    bn_moved = {top: sum(not torch.equal(sd[k], sd0[k]) for k in sd if k.startswith(f"{top}.") and "running_" in k)
                for top in ("encoder", "grid_align")}
    log(f"  parameters moved: {moved} of {n_p}; BN running statistics moved: {bn_moved}")
    if moved["local"] < n_p["local"] // 2 or moved["fuse_sft_block"] < n_p["fuse_sft_block"] // 2:
        raise AssertionError("local or fuse_sft_block did not move")
    if moved["grid_align"] or moved["encoder"]:
        raise AssertionError("the frozen aligner (--fix-ada) or E0 moved")
    if not bn_moved["encoder"] or not bn_moved["grid_align"]:
        raise AssertionError("E0's and the aligner's BN running statistics did not move (train mode)")
    frozen = [k for k in sd if k.split(".")[0] in ("generator", "volume_discriminator")]
    changed = [k for k in frozen if not torch.equal(sd[k], sd0[k])]
    nets = {f"lpips.{k}": v for k, v in lpips_fn.state_dict().items()}
    nets.update({f"id.{k}": v for k, v in id_fn.state_dict().items()})
    changed += [k for k in frozen_nets if not torch.equal(frozen_nets[k], nets[k])]
    log(f"  generator, volume D and perceptual nets: {len(frozen) + len(frozen_nets) - len(changed)} of "
        f"{len(frozen) + len(frozen_nets)} tensors bit-identical")
    if changed:
        raise AssertionError(f"frozen tensors changed: {changed[:5]}")
    trained = ("local", "fuse_sft_block")
    if any(p.grad is not None for n, p in model.named_parameters() if n.split(".")[0] not in trained):
        raise AssertionError("a frozen parameter received a gradient")
    d_moved = sum(not torch.equal(v, d0[k]) for k, v in d.state_dict().items())
    log(f"  full-res D: {d_moved} of {len(d0)} tensors moved")
    if d_moved < len(d0) // 2 or any(p.grad is not None for p in d.parameters()):
        raise AssertionError("the D did not move, or kept gradients")

    wall_ms = float(np.median(total))
    kernel_us, n_launch = device_kernels(lambda: one_iter(), 2)
    busy = sum(kernel_us.values()) / 2e3
    field = sum(us for name, us in kernel_us.items() if "siren_field" in name) / 2e3
    log(f"  device busy {busy:.3f} ms per iteration in {sum(n_launch.values()) // 2} launches (field kernel "
        f"{field:.3f} ms, {field / busy:.3f} of busy); busy share {busy / wall_ms:.3f} of the {wall_ms:.2f} ms median "
        f"iteration")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  kernel {us / 2e3:8.4f} ms {n_launch[name] // 2:5d}x  {name[:100]}")
    del model, state, lpips_fn, id_fn, d, d_state, sd0, frozen_nets
    torch.cuda.empty_cache()
    per_iter = {k: ST2_D_LAUNCHES[k] + ST2_E_LAUNCHES[k] for k in ST2_E_LAUNCHES}
    return {"per_iter": per_iter, "launches": {k: v * ST2_ITERS for k, v in per_iter.items()}, "kernel": kernel}


def st2_reduced_config():
    """stage2_config cut for the card-vs-CPU check as phase 7 cuts stage 1:
    the field at depth 8 and width 256 rendering 32^2, the decoder to 128^2,
    E0 and the E1 branch unchanged."""
    from e3dge_torch.config import _with, stage2_config

    return _with(stage2_config(), renderer=dict(out_im_res=32), decoder=dict(size=128, in_res=32),
                 encoder=dict(n_styles_decoder=6)).validate()


def st2_card_vs_cpu(device) -> None:
    """Phase 8, last part: one stage-2 cycle loss and backward of
    `st2_reduced_config` at B=2 from one batch made on the card, with every
    branch on (the adversarial term at the adaptive weight, the exact ref-view
    weighting, both consistency terms, the aligner trained): the loss terms
    and the trainable gradient on the card, on the card with the SFT
    modulations detached before the re-render (the control), on the CPU at
    ST1_CPU_THREADS threads (the reference) and at 1 thread, each against the
    reference, within phase 7's limits."""
    from unittest import mock

    from e3dge_torch.render.camera import CameraParams
    from e3dge_torch.training import steps

    def to(x, dev):
        return CameraParams(*(f.to(dev) for f in x)) if isinstance(x, CameraParams) else x.to(dev)

    cfg = st2_reduced_config()
    d_res = min(cfg.decoder.size, 256)
    lambdas = dict(ST2_LAMBDAS, hit_prob_consistency_lambda=0.1, depth_lambda=0.1)
    terms = ("loss",) + ST2_TERMS + ("d_weight", "hit_prob_consistency", "depth_consistency")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    threads = torch.get_num_threads()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs, data = {}, {}
    try:
        for name, dev, n_threads, cut in (("card", device, None, False),
                                          ("card, SFT detached", device, None, True),
                                          ("CPU", torch.device("cpu"), ST1_CPU_THREADS, False),
                                          ("CPU at 1 thread", torch.device("cpu"), 1, False)):
            t0 = time.perf_counter()
            torch.set_num_threads(n_threads or threads)
            model, ml, lpips_fn, id_fn, state, d = st2_model(cfg, dev, steps.STAGE22_TRAINABLE, d_res)
            if not data:  # on the card
                gen = torch.Generator(dev).manual_seed(SEED)
                data["noise"] = steps.decoder_noise(model, 2, gen)
                data["batch"] = model.synthetic_sample(2, 1.0, pair_same_id=True, generator=gen, noise=data["noise"])
            b = {k: to(v, dev) for k, v in data["batch"].items()}
            probe = [p for k, p in state.params.items() if k.startswith("local.")]
            render_cached = model.generator.render_cached

            def detached(styles, cached, conditions, **kw):
                return render_cached(styles, cached, tuple(t.detach() for t in conditions), **kw)

            with mock.patch.object(model.generator, "render_cached", detached) if cut else contextlib.nullcontext():
                loss, metrics, _ = steps.cycle_loss(model, b, ml, lambdas, lpips_fn, id_fn, use_ref_view_weight=True,
                                                    d_fn=d, adaptive_params=probe,
                                                    noise=[n.to(dev) for n in data["noise"]])
            loss.backward()
            runs[name] = ({k: float(metrics[k].detach()) for k in terms},
                          {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().float().cpu()
                           for k, p in state.params.items()})
            log(f"  reduced stage-2 step, {name}: {time.perf_counter() - t0:.1f} s (build + one step)")
            del model, state, lpips_fn, id_fn, d, loss, metrics, b, probe
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_num_threads(threads)
    m_ref, g_ref = runs["CPU"]
    log("  terms card / CPU: " + ", ".join(f"{k} {runs['card'][0][k]:.6g} / {m_ref[k]:.6g}" for k in m_ref))
    gaps = {}
    for name in ("card", "CPU at 1 thread", "card, SFT detached"):
        m, g = runs[name]
        term = max(abs(m[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-6) for k in m_ref)
        gaps[name] = (term, *grad_gap(g, g_ref))
        log(f"  {name} vs CPU at {ST1_CPU_THREADS} threads: worst term relative error {term:.3e}; trainable "
            f"gradient relative L2 {gaps[name][1]:.3e} over {len(g_ref)} leaves, worst leaf {gaps[name][3]:.3e} at "
            f"{gaps[name][2]}")
    term, glob, _, leaf = gaps["card"]
    ok = term < ST1_TOL_TERM and glob < ST1_TOL_GRAD and leaf < ST1_TOL_LEAF
    log(f"  card vs CPU [terms < {ST1_TOL_TERM:g}, gradient < {ST1_TOL_GRAD:g}, each leaf < {ST1_TOL_LEAF:g}]: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the stage-2 step disagrees between the card and the CPU")
    _, glob, _, leaf = gaps["card, SFT detached"]
    seen = glob >= ST1_TOL_GRAD or leaf >= ST1_TOL_LEAF
    log(f"  control (SFT detached) {'fails' if seen else 'PASSES'} the gradient gate")
    if not seen:
        raise AssertionError("the gradient gate does not see the SFT modulations' gradient")


# Phase 9: the eval entry point (python -m e3dge_torch.eval) at the flagship
# widths of demo_view_synthesis_config, f32, on seeded weights
EVAL_IMAGES, EVAL_BATCH, EVAL_VIEWS, EVAL_PROJECT_STEPS, EVAL_PTI_STEPS = 5, 2, 4, 5, 2
# field launches (full, texture) per CLI call, from the modes' call graphs:
# validation's ceil(5 / 2) batches each render with raw_h and run the texture
# pass; the video renders the ref view, then the B*V query render and its SFT
# re-render; each HDTF batch renders the ref view, the query view and the SFT
# re-render; the mesh renders the ref view and the SDF grid; the edit renders
# the ref view, the edited view, the query view and the SFT re-render;
# projection renders its reconstruction (its steps and PTI run the twin), and
# validation from the latents renders once; each in the call's field
# precision (highest in f32, serving in bf16), counted per precision
EVAL_LAUNCHES = {"metrics": (3, 3), "video": (3, 0), "hdtf": (9, 0), "mesh": (2, 0), "edit": (4, 0),
                 "project": (1, 0), "metrics_projection": (1, 0), "metrics_bf16": (3, 3)}
# validation's scores, card vs CPU at a reduced config (phase 7's cut of the
# field and the decoder, the E1 branch whole), B=2, f32 with TF32 off. H100
# readings: loss_l2 6.4e-6, mae 1.8e-6, ssim 3.0e-7, PSNR 1.3e-5 dB; the
# same card with the field in bf16 (the serving kernel): 4.0e-3, 1.2e-3,
# 1.2e-4, 8.1e-3 dB. Each limit sits near the geometric mean of the two, 16
# to 28 times above the f32 reading and 24 to 40 times below the bf16 one.
EVAL_TOL = {"loss_l2": 1e-4, "mae": 5e-5, "ssim": 5e-6, "psnr": 3e-4}
# the Runner method each CLI mode drives, probed for wall and device time
EVAL_METHODS = {"metrics": ("validation",), "metrics_bf16": ("validation",), "project": ("project_images",),
                "metrics_projection": ("validation_from_latents",), "video": ("render_video",),
                "hdtf": ("render_hdtf",), "mesh": ("encode_ref", "latent2surface"), "edit": ("edit_and_render",)}


def smooth_images(n: int, size: int, seed: int) -> np.ndarray:
    """n seeded smooth RGB images [n, size, size, 3] uint8, three
    low-frequency sinusoids per channel."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = np.zeros((n, size, size, 3))
    for i in range(n):
        for c in range(3):
            for _ in range(3):
                fx, fy, ph, a = rng.uniform(0.5, 3), rng.uniform(0.5, 3), rng.uniform(0, 2 * np.pi), rng.uniform(0.15, 0.3)
                out[i, :, :, c] += a * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
    return np.clip((out + 1.0) * 127.5, 0, 255).astype(np.uint8)


def write_folder(root: str, images: np.ndarray) -> str:
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray(img).save(os.path.join(root, f"{i}.png"))
    return root


@contextlib.contextmanager
def probed(names, record: list):
    """While active, each Runner method in `names` is timed on the host
    clock around a synchronise and profiled (torch.profiler, CUDA activity
    only): its wall ms, device busy ms, field kernel ms and peak memory go to
    `record`."""
    from torch.profiler import ProfilerActivity, profile

    from e3dge_torch.runner import Runner

    originals = {n: getattr(Runner, n) for n in names}

    def wrap(name, fn):
        def call(self, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn(self, *args, **kwargs)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = field = 0.0
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
                    busy += ev.time_range.elapsed_us() / 1e3
                    field += ev.time_range.elapsed_us() / 1e3 if "siren_field" in ev.name else 0.0
            if busy <= 0:
                raise AssertionError(f"the profiler saw no device time in Runner.{name}")
            record.append({"method": name, "wall_ms": wall, "busy_ms": busy, "field_ms": field,
                           "peak_gib": peak_gib()})
            return out

        return call

    for n, fn in originals.items():
        setattr(Runner, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(Runner, n, fn)


def finite_array(path: str, shape: tuple) -> np.ndarray:
    a = np.load(path)
    if a.shape != shape or not np.isfinite(a).all():
        raise AssertionError(f"{path}: {a.shape} finite={bool(np.isfinite(a).all())}, expected finite {shape}")
    log(f"  {os.path.basename(path)} {a.shape} finite, range [{a.min():.4f}, {a.max():.4f}], std {a.std():.4f}")
    if not a.std() > MIN_IMAGE_STD:
        raise AssertionError(f"{path} is constant")
    return a


def one_video(pattern_dir: str, stem: str) -> str:
    """The video `stem.*` that `write_video` put in pattern_dir (its suffix
    follows the writer the machine has: .mp4, .gif or .png)."""
    hits = [f for f in os.listdir(pattern_dir) if f.split(".")[0] == stem and not f.endswith(".npy")]
    if len(hits) != 1 or os.path.getsize(os.path.join(pattern_dir, hits[0])) == 0:
        raise AssertionError(f"expected one non-empty {stem}.* in {pattern_dir}, found {hits}")
    return os.path.join(pattern_dir, hits[0])


def check_scores(scores: dict, n: int, what: str) -> None:
    bad = {k: v for k, v in scores.items() if isinstance(v, float) and not math.isfinite(v)}
    if scores.get("num_images") != n or bad:
        raise AssertionError(f"{what}: {scores}")
    log(f"  {what} scores: " + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in scores.items()))


def eval_kernel_check(device) -> dict:
    """The field kernel at phase 9's new launch shapes against its plain
    version, timed beside its bound: in `highest`, validation's B=2 render with
    raw_h and its texture pass, HDTF's and the edit's B=2 SFT re-render, the
    video's B=8 (2 images x 4 views) SFT re-render; in `serving`, the bf16
    validation's B=2 render with raw_h and its texture pass."""
    out = {}
    with torch.no_grad():
        for label, batch, sft, precision, raw_h in (
                ("eval validation render", EVAL_BATCH, False, "highest", True),
                ("eval HDTF / edit SFT re-render", EVAL_BATCH, True, "highest", False),
                ("eval video SFT re-render", EVAL_BATCH * EVAL_VIEWS, True, "highest", False),
                ("eval bf16 validation render", EVAL_BATCH, False, "serving", True)):
            r = check_and_time_full(label, batch, N_FULL, sft, precision, device, raw_h=raw_h)
            out[label] = {"entry": "siren_field_full", "precision": precision, "batch": batch, "n": N_FULL,
                          "sft": sft, "raw_h": raw_h, **r}
        for label, precision in (("eval validation texture pass", "highest"),
                                 ("eval bf16 validation texture pass", "serving")):
            r = check_and_time_tex(label, EVAL_BATCH, N_FULL, precision, device)
            out[label] = {"entry": "siren_field_tex", "precision": precision, "batch": EVAL_BATCH, "n": N_FULL,
                          "sft": True, **r}
    return out


def run_eval(device, root: str) -> dict:
    """Phase 9, first part: every mode of `e3dge_torch.eval.main` on the card
    at demo_view_synthesis_config, f32 (and metrics once in bf16), on 5
    seeded 256^2 PNGs at batch 2, with seeded perceptual nets read from .pth
    files that hold a subset of their keys. Per mode: the field launches
    (asserted), the artifacts (existence, shape, finiteness), the scores,
    wall ms per image or frame, device busy ms per call and peak memory.
    Returns the launch counts by mode, split by precision."""
    from e3dge_torch import eval as teval
    from e3dge_torch.config import demo_view_synthesis_config
    from e3dge_torch.training.perceptual import make_perceptual_fns
    from PIL import Image

    from e3dge_torch.utils.editing import ATTRS

    cfg = demo_view_synthesis_config()
    data = write_folder(os.path.join(root, "imgs"), smooth_images(EVAL_IMAGES, cfg.pifu.load_size, SEED))
    lp, idl = make_perceptual_fns("cpu", seed=SEED + 5)
    torch.save({k: v for k, v in lp.state_dict().items() if k.startswith("lin")}, os.path.join(root, "lpips.pth"))
    torch.save({k: v for k, v in idl.facenet.state_dict().items() if not k.startswith("body.")},
               os.path.join(root, "arcface.pth"))
    del lp, idl
    rng = np.random.RandomState(SEED)
    for attr in ATTRS[:4]:
        for space, dim in (("renderer", cfg.renderer.style_dim), ("decoder", cfg.decoder.style_dim)):
            os.makedirs(os.path.join(root, "bounds", f"{space}_{attr}"))
            np.save(os.path.join(root, "bounds", f"{space}_{attr}", "boundary.npy"),
                    (rng.randn(1, dim) / np.sqrt(dim)).astype(np.float32))
    out = os.path.join(root, "out")
    base = ["--data", data, "--out", out, "--batch", str(EVAL_BATCH)]
    perceptual = ["--lpips-ckpt", os.path.join(root, "lpips.pth"), "--arcface-ckpt", os.path.join(root, "arcface.pth")]
    size = cfg.decoder.size
    runs = (
        ("metrics", ["--mode", "metrics", *perceptual], EVAL_IMAGES, "image"),
        ("video", ["--mode", "video", "--views", str(EVAL_VIEWS)], EVAL_BATCH * EVAL_VIEWS, "frame"),
        ("hdtf", ["--mode", "hdtf", "--max-images", str(EVAL_IMAGES)], EVAL_IMAGES, "frame"),
        ("mesh", ["--mode", "mesh"], EVAL_BATCH, "mesh"),
        ("edit", ["--mode", "edit", "--boundaries", os.path.join(root, "bounds")], EVAL_BATCH, "image"),
        ("project", ["--mode", "project", "--batch", "1", "--max-images", "1", "--project-steps",
                     str(EVAL_PROJECT_STEPS), "--pti", "--pti-steps", str(EVAL_PTI_STEPS), *perceptual], 1, "image"),
        ("metrics_projection", ["--mode", "metrics", "--projection-root", os.path.join(out, "projection"), "--pti",
                                *perceptual], 1, "image"),
        ("metrics_bf16", ["--mode", "metrics", "--dtype", "bfloat16", *perceptual], EVAL_IMAGES, "image"),
    )
    launches, n_scores = {}, 0
    for mode, args, per, unit in runs:
        record = []
        log(f"  [9] python -m e3dge_torch.eval {' '.join(args[:2])} ({mode})")
        t0 = time.perf_counter()
        with probed(EVAL_METHODS[mode], record):
            rc, counts, split = counted_split(lambda: teval.main(base + args))
        call_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"eval {mode} exited {rc}")
        full, tex = EVAL_LAUNCHES[mode]
        precision = "serving" if mode == "metrics_bf16" else "highest"
        log(f"  launch counts over the call: {counts}; by precision: {split_text(split)}")
        if counts != {"siren_field_full": full, "siren_field_tex": tex} or \
                split[("siren_field_full", precision)] != full or split[("siren_field_tex", precision)] != tex:
            raise AssertionError(f"eval {mode} launched {split}, expected {full} + {tex} in {precision}")
        launches[mode] = split
        wall, busy = sum(r["wall_ms"] for r in record), sum(r["busy_ms"] for r in record)
        field = sum(r["field_ms"] for r in record)
        log(f"  {mode}: the CLI call {call_s:.2f} s (model build and seeding included); "
            f"{'+'.join(r['method'] for r in record)} {wall:.2f} ms wall under the profiler, "
            f"{wall / per:.2f} ms per {unit}; device busy {busy:.3f} ms (field kernel {field:.3f} ms), "
            f"busy share {busy / wall:.3f}; peak memory {max(r['peak_gib'] for r in record):.2f} GiB")
        if mode.startswith("metrics"):
            scores = json.load(open(os.path.join(out, "scores.json")))
            if len(scores) != n_scores + 1:
                raise AssertionError(f"scores.json holds {len(scores)} entries after {n_scores + 1} metrics runs")
            n_scores += 1
            check_scores(scores[-1], per, mode)
            if mode == "metrics_projection" and scores[-1].get("projection_validation") is not True:
                raise AssertionError("validation from latents did not mark its scores")
        elif mode == "video":
            finite_array(os.path.join(out, "video_frames.npy"), (EVAL_BATCH, EVAL_VIEWS, 3, size, size))
            for i in range(EVAL_BATCH):
                log(f"  video file {os.path.basename(one_video(os.path.join(out, 'videos'), str(i)))}")
        elif mode == "hdtf":
            finite_array(os.path.join(out, "trajectory_videos", "HDTF_nvs_video.npy"), (EVAL_IMAGES, 3, size, size))
            log(f"  video file {os.path.basename(one_video(os.path.join(out, 'trajectory_videos'), 'HDTF_nvs_video'))}")
        elif mode == "mesh":
            for i in range(EVAL_BATCH):
                n_v = sum(1 for line in open(os.path.join(out, f"mesh_{i}.obj")) if line.startswith("v "))
                log(f"  mesh_{i}.obj: {n_v} vertices (seeded weights may give an empty surface)")
        elif mode == "edit":
            finite_array(os.path.join(out, "edited.npy"), (EVAL_BATCH, 3, size, size))
        elif mode == "project":
            d = os.path.join(out, "projection", "0")
            lat = np.load(os.path.join(d, "latent_in.npz"))
            rec = np.asarray(Image.open(os.path.join(d, "rec.png")))
            tuned = torch.load(os.path.join(d, "pti_g.pt"), weights_only=True)
            ok = (np.isfinite(lat["renderer"]).all() and np.isfinite(lat["decoder"]).all()
                  and math.isfinite(float(lat["final_loss"])) and rec.shape == (size, size, 3) and rec.std() > 1
                  and all(bool(torch.isfinite(v).all()) for v in tuned.values() if v.is_floating_point()))
            log(f"  projection/0: latents {lat['renderer'].shape} + {lat['decoder'].shape}, final loss "
                f"{float(lat['final_loss']):.5f}, rec.png {rec.shape} std {rec.std():.2f}, pti_g.pt {len(tuned)} "
                f"entries {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the projection's artifacts are missing or not finite")
        torch.cuda.empty_cache()
    return launches


def eval_reduced_config():
    """demo_view_synthesis_config cut as phase 7 cuts stage 1: the field at
    depth 8 and width 256 rendering 32^2, the decoder to 128^2, E0 and the E1
    branch whole."""
    from e3dge_torch.config import _with, demo_view_synthesis_config

    return _with(demo_view_synthesis_config(), renderer=dict(out_im_res=32), decoder=dict(size=128, in_res=32),
                 encoder=dict(n_styles_decoder=6)).validate()


def eval_card_vs_cpu(device, root: str) -> None:
    """Phase 9, second part: `Runner.validation` at `eval_reduced_config`,
    B=2 over 5 seeded PNGs (a ragged last batch), same weights, f32 with TF32
    off, on the card and on the CPU (ST1_CPU_THREADS threads): loss_l2, mae,
    ssim and PSNR within EVAL_TOL. Two controls, each on the card, must fall
    outside: the field in bf16 (the serving kernel, a lower-precision
    render), and the last batch's padded row scored too (the folder with its
    last image repeated as a sixth, the fault the ragged batch's mask guards
    against)."""
    from e3dge_torch.config import _with
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.runner import Runner
    from e3dge_torch.utils.weights import init_weights

    cfg = eval_reduced_config()
    imgs = smooth_images(EVAL_IMAGES, cfg.pifu.load_size, SEED + 1)
    folders = {"": write_folder(os.path.join(root, "cmp"), imgs),
               "padded": write_folder(os.path.join(root, "cmp_padded"), np.concatenate([imgs, imgs[-1:]]))}
    _, ml = seeded_inputs(cfg, SEED)
    threads = torch.get_num_threads()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    controls = ("card, the field in bf16", "card, the padded row scored")
    scores = {}
    try:
        for name, dev, folder, run_cfg in (
                ("card", device, "", cfg), ("CPU", torch.device("cpu"), "", cfg),
                (controls[0], device, "", _with(cfg, renderer=dict(field_dtype="bfloat16")).validate()),
                (controls[1], device, "padded", cfg)):
            t0 = time.perf_counter()
            torch.set_num_threads(ST1_CPU_THREADS if dev.type == "cpu" else threads)
            model = E3DGE(run_cfg, device=dev)
            init_weights(model, SEED)
            runner = Runner(model, ml, dev, work_dir=os.path.join(root, f"cmp_{len(scores)}"))
            scores[name] = runner.validation(folders[folder], batch_size=EVAL_BATCH)
            log(f"  validation on the {name}: {time.perf_counter() - t0:.1f} s, {scores[name]['num_images']} images; "
                + ", ".join(f"{k} {scores[name][k]:.8f}" for k in EVAL_TOL))
            del model, runner
    finally:
        torch.set_num_threads(threads)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    for name in ("card", *controls):
        gaps = {k: abs(scores[name][k] - scores["CPU"][k]) for k in EVAL_TOL}
        inside = all(gaps[k] <= EVAL_TOL[k] for k in EVAL_TOL)
        log(f"  {name} vs CPU: " + ", ".join(f"{k} {gaps[k]:.3e} [tol {EVAL_TOL[k]:g}]" for k in EVAL_TOL)
            + f": {'inside' if inside else 'outside'} the tolerance")
        if name == "card" and not inside:
            raise AssertionError("validation's scores disagree between the card and the CPU")
        if name != "card" and inside:
            raise AssertionError(f"the control ({name}) passes the card-vs-CPU gate")


def run_host_videos(device, root: str) -> dict:
    """Phase 9, last part: `Runner.render_video_projected_noise` (4 views) and
    `Runner.render_depth_mesh` (512^2) at the flagship config on phase 4's
    seeded weights, input and noise: launch counts, finite frames, wall ms
    per frame, device busy ms, and the host share (the ms of mesh extraction,
    marching and welding, and of the rasterizer, against device ms). Returns the launch
    counts by path, split by precision."""
    from e3dge_torch.config import flagship_config
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.runner import Runner
    from e3dge_torch.utils import mesh
    from e3dge_torch.utils.weights import init_weights

    cfg = flagship_config()
    model = E3DGE(cfg)
    init_weights(model, SEED)
    images, ml, noise = to_device(*seeded_inputs(cfg, SEED), decoder_noise(cfg, 1, SEED), device)
    runner = Runner(model, ml, device, work_dir=os.path.join(root, "host_videos"))
    host = defaultdict(float)

    def timed_native(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                host[name] += (time.perf_counter() - t0) * 1e3
        return call

    launches = {}
    originals = {"extract_mesh": mesh.extract_mesh, "rasterize": mesh.rasterize}
    for name, fn in originals.items():
        setattr(mesh, name, timed_native(name, fn))
    try:
        for path, method, call, n_frames, expect in (
                ("projected_noise_video", "render_video_projected_noise",
                 lambda: runner.render_video_projected_noise(images, n_views=EVAL_VIEWS, noise=noise), EVAL_VIEWS,
                 {("siren_field_full", "serving"): 1 + EVAL_VIEWS, ("siren_field_full", "highest"): 1}),
                ("depth_mesh", "render_depth_mesh", lambda: runner.render_depth_mesh(images, image_size=512), 1,
                 {("siren_field_full", "serving"): 1})):
            host.clear()
            record = []
            with probed((method,), record):
                frames, counts, split = counted_split(call)
            log(f"  [9] Runner.{method}: launch counts {counts}; by precision: {split_text(split)}")
            if split != {k: expect.get(k, 0) for k in split}:
                raise AssertionError(f"{method} launched {split}, expected {expect}")
            launches[path] = split
            frames = torch.as_tensor(frames).float().cpu()
            shape = (1, EVAL_VIEWS, 3, cfg.decoder.size, cfg.decoder.size) if n_frames > 1 else (1, 512, 512)
            if path == "depth_mesh":
                if tuple(frames.shape) != shape or not bool(torch.isfinite(frames).all()) \
                        or float(frames.min()) < 0 or float(frames.max()) > 1:
                    raise AssertionError(f"depth-mesh frames {tuple(frames.shape)} not finite in [0, 1]")
                log(f"  frames {tuple(frames.shape)} in [{float(frames.min()):.4f}, {float(frames.max()):.4f}], "
                    f"std {float(frames.std()):.4f}")
            else:
                check_image(frames, shape, "projected-noise frames")
            (r,) = record
            native = host["extract_mesh"] + host["rasterize"]
            log(f"  {path}: {r['wall_ms']:.2f} ms wall under the profiler, {r['wall_ms'] / n_frames:.2f} ms per frame; "
                f"device busy {r['busy_ms']:.3f} ms (field kernel {r['field_ms']:.3f} ms); host mesh work "
                f"{native:.2f} ms (marching + welding {host['extract_mesh']:.2f}, rasterizer {host['rasterize']:.2f}), "
                f"{native / r['wall_ms']:.3f} of the wall against the device's {r['busy_ms'] / r['wall_ms']:.3f}; "
                f"peak memory {r['peak_gib']:.2f} GiB")
    finally:
        for name, fn in originals.items():
            setattr(mesh, name, fn)
    del model, runner
    torch.cuda.empty_cache()
    return launches


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
    log(f"[2] field kernels built in {time.perf_counter() - t0:.1f} s: {path.name}")
    check_build(path, build_log)

    log("[3] field kernel vs its plain version on the card")
    with torch.no_grad():
        main_err = check_kernels(device)
        times = time_kernels(device)
    bounds = {p: field_bounds(N_FULL, p) for p in ("serving", "highest")}
    for (name, precision), (ms, plain_ms) in times.items():
        bd = bounds[precision][name]
        log(f"  {name} {precision}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {bound_text(bd)}, "
            f"epilogue f32-pipe floor {bd['epilogue_floor_ms']:.4f} ms")
    bounds = bounds["serving"]
    times = {name: times[(name, "serving")] for name in ("siren_field_full", "siren_field_tex")}
    with torch.no_grad():
        check_path_shapes(device)

    log("[4] image2image, flagship config on seeded weights")
    counts, inv_ms, bf16_img, flagship = run_flagship(device)

    log("[5] f32 image2image, card vs CPU; bf16 vs f32")
    f32_card, f32_img = run_card_vs_cpu(device, bf16_img)

    log("[6] the other inference paths, flagship config")
    with torch.no_grad():
        paths = run_paths(device, flagship, f32_card, f32_img, bf16_img)
    paths["image2image"] = counts
    del flagship, f32_card
    torch.cuda.empty_cache()

    log("[7] stage-1 training, stage1_config at full width")
    st1 = run_stage1(device)
    st1_card_vs_cpu(device)

    log("[8] stage-2.2 training, stage2_config at full width")
    st2 = run_stage2(device)
    st2_card_vs_cpu(device)

    log("[9] the eval entry point, demo_view_synthesis_config at full width")
    with tempfile.TemporaryDirectory(prefix="e3dge_eval_") as root:
        ev_kernel = eval_kernel_check(device)
        ev = run_eval(device, root)
        eval_card_vs_cpu(device, root)
        ev.update(run_host_videos(device, root))
    ev_shapes = [{"label": label, **r} for label, r in ev_kernel.items()]

    def eval_launches(entry, precision):
        """Phase 9's measured launches of one entry in one precision, by path."""
        return {f"eval_{m}" if m in EVAL_LAUNCHES else m: split[(entry, precision)] for m, split in ev.items()}

    kernels = []
    for name in ("siren_field_full", "siren_field_tex"):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "e3dge_torch/csrc/siren_field_sm90.cu",
            "replaces": "e3dge_tpu/ops/pallas/siren_kernel.py:48",
            "launches": counts[name],
            "max_abs_err": main_err[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bounds[name]["bound_ms"],
            "bound_by": bounds[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the FiLM-SIREN field
            "launches_by_path": {path: paths[path][name] for path in PATHS},
        })
        kernels[-1]["launches_by_path"].update(eval_launches(name, "serving"))
        kernels[-1]["shapes"] = [r for r in ev_shapes if r["entry"] == name and r["precision"] == "serving"]
    # the stage-1 path's kernel: the f32 entry of csrc/siren_field.cu at the
    # sample render's shape; launches over the measured steps (all `highest`)
    st2_shapes = [{"label": label, **r} for label, r in st2["kernel"].items()]
    kernels.append({
        "name": "siren_field_full (highest)",
        "route": "cuda",
        "source": "e3dge_torch/csrc/siren_field.cu",
        "replaces": "e3dge_tpu/ops/pallas/siren_kernel.py:48",
        "launches": st1["launches"]["siren_field_full"],
        **st1["kernel"],
        "shapes": st1["kernel"]["shapes"] + [r for r in st2_shapes if r["entry"] == "siren_field_full"]
        + [r for r in ev_shapes if r["entry"] == "siren_field_full" and r["precision"] == "highest"],
        "library_ms": None,
        "launches_by_path": {"latent2surface": paths["latent2surface"]["siren_field_full"],
                             "stage1_step": st1["per_step"]["siren_field_full"],
                             "stage2_iteration": st2["per_iter"]["siren_field_full"],
                             **eval_launches("siren_field_full", "highest")},
        "launches_stage2": st2["launches"]["siren_field_full"],
    })
    # the texture entry in f32, on the stage-2 path (the D's fake producer):
    # launches over the measured iterations, figures at its B=4 shape
    tex = st2["kernel"]["stage-2 D producer texture pass"]
    kernels.append({
        "name": "siren_field_tex (highest)",
        "route": "cuda",
        "source": "e3dge_torch/csrc/siren_field.cu",
        "replaces": "e3dge_tpu/ops/pallas/siren_kernel.py:48",
        "launches": st2["launches"]["siren_field_tex"],
        **{k: tex[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "fma_bound_ms")},
        "library_ms": None,
        "shapes": [r for r in ev_shapes if r["entry"] == "siren_field_tex" and r["precision"] == "highest"],
        "launches_by_path": {"stage1_step": st1["per_step"]["siren_field_tex"],
                             "stage2_iteration": st2["per_iter"]["siren_field_tex"],
                             **eval_launches("siren_field_tex", "highest")},
    })
    log(f"image2image ms per inversion (flagship bf16, B=1): {inv_ms:.4f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
