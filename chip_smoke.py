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
     gen_imgs against a stated tolerance (the CPU's run in a child process,
     read after phase 6), and the bf16 image of phase 4 against the f32 card
     image (mean relative error);
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
     threads): the loss
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
     and noise, with the host share (marching and rasterizer ms);
 10. the trainer CLI, `e3dge_torch.training.train.main`, at phase 8's
     configuration and recipe (stage2_config, B=4, train_stage2.2.sh's
     switches): a. 4 iterations with --data (8 seeded 256^2 PNGs),
     --val-data, panels, validation and checkpoints every 2 or 4 iterations
     and partial perceptual checkpoints: the artifacts, each iteration's
     field launches (phase 8's), the D's reals equal to the folder's
     batches, ms per iteration beside phase 8's, a batch load, each
     checkpoint save (ms, MB), the validation call and a panel, device busy
     share and peak memory; b. --resume with both D states: two
     uninterrupted runs of RANK_REF_ITERS iterations give the card's spread
     (and are the one-rank reference of phases 11b and 12), a resumed run
     stays within 10x of it (metrics and final state), a resume that drops
     the optimizer state falls outside; c. `e3dge_torch.eval.main --mode now` at
     demo_view_synthesis_config, f32, batch 2, on a seeded NoW layout (4
     JPEGs of 1024x768, scans of 62,500 points): the NoW SDF grid's launch
     shape against the plain field, the launches per batch, a mesh per
     image, finite scores, ms per image in three parts, and
     `now_scan_error` card against CPU with a moved-mesh control (10c runs
     first; the CPU's run in a child process beside 10a and 10b);
 11. data parallelism (`e3dge_torch.parallel`) on the one card, against a
     one-rank reference (10b's uninterrupted runs: its flags at
     RANK_REF_ITERS iterations, SPREAD_RUNS runs, the card's spread, whose
     RESUME_FACTOR x sets 11b's and 12's limits): 2 ranks over gloo with
     CUDA tensors, each run a
     torchrun process group of this
     script's `--rank-child SPEC` with its own time limit: a. train.main at
     stage1_config, B=4, 2 ranks against one rank within RESUME_FACTOR x
     the spread of SPREAD_RUNS one-rank runs (`st1_rank_limits`; metrics and
     final state), a BN-sync-off control outside; b. the
     reference's run on 2 ranks against its first run within its limits, a
     gradient-averaging-off control outside; c. the flagship's bf16
     image2image of 2 images across 2 ranks, equal to one rank's per-row
     inversions and within the bf16 limit of its B=2 call; d. one stage-1
     iteration under nccl at world 1: every collective an exact identity,
     the forward equal to runs without a process group, the backward within
     their spread (d's runs beside c's); each run's field launches per rank
     per iteration and the per-rank launch shapes against the plain field,
     timed;
 12. the sp (ray) axis on the one card: the reference's run through
     `train.main --sp 2` on a 1x2 (a) and a 2x2 (b) dp x sp world over gloo
     (torchrun groups of --rank-child, as 11), each against the reference's
     first run within its limits and beside a control with the sp
     gradient sum of the ray gather off, which must fall outside; c. each world's field launches per rank
     per iteration, and the per-rank launch shapes of the ray-split cycle
     step (1x2, 2x2 and the four-card 1x4 of sp_scaling.py) against the
     plain field, timed beside their bounds.
     `python3 chip_smoke.py --phase 11` (or 12) runs phases 1, 2, the
     reference and that phase only;
 13. the JAX stage scripts' bf16 recipe (`--sample-field-dtype --dtype
     --field-dtype bfloat16`, `bf16_recipe`) and the config-selected variants:
     the `serving` kernel at the recipe's new training shapes (stage 1's
     sample render B=4 x 73,728; stage 2's B=4 x 98,304 with and without
     raw_h, the D producer's texture pass) against its plain version and
     timed beside the bound; a. phase 7's run in the recipe (2 + 5 steps,
     each step's launches by precision and its twin evaluations asserted:
     the sample render `serving`, the SDF targets `highest`, the render's
     twin bf16, the SDF queries' twin f32), its figures beside phase 7's
     f32 ones (ms in four parts, busy, the twin's forward + backward alone
     and its share of busy, peak memory), the bf16 loss against the f32 loss
     of one batch and weights (< BF16_VS_F32_LOSS), a reduced bf16 step card
     vs CPU within the CPU's own bf16-vs-f32 gap, the eikonal control
     outside; b. phase 8's the same (2 + 4 iterations, six parts), the
     SFT-detached control; c. one phase-8 iteration with the bn netLocal
     (every BN's statistics move, phase 8's launches) and its reduced cycle
     loss card vs CPU within phase 8's limits, each leaf's limit raised by
     LEAF_FIELD_FACTOR x its gap between the card's step through the kernel
     and through the plain field (control outside), and the
     flagship image2image with the raw-density renderer (with_sdf False):
     1 + 1 launches, a finite non-constant image, f32 card vs CPU within
     phase 5's tolerance. `python3 chip_smoke.py --phase 13` runs phases 1,
     2 and 13 only;
 14. the long tail, the modules only the JAX tests reach (`run_long_tail`),
     each card-vs-CPU gate a gap by magnitude (`mag_gap`) within 10x its
     CPU test's tolerance (LT_TOL), each with a control that must fail it:
     a. `find_surface_secant` through the flagship renderer's query_sdf, B=1,
     64^2 rays, 24 + 8 samples, on the field kernel (9 launches, its two
     new launch shapes against the plain field and timed), its z and hits
     against the CPU's twin and the card's plain field (control: no secant
     step); `mlp_init_pass` at stage1_config with grad, loss and field
     gradient (control: the stratified grid); `forward_ddf` at 8 x 256
     (control: the W+ rows shifted); b. every `set_encoder` name at the
     flagship's EncoderConfig, B=1, both W+ codes (control: e4e at stage 0);
     c. the align blocks at their widths on the flagship E1's map sizes
     (control: DemodulatedConv2d without demodulation); d. `python -m
     e3dge_torch.tools.calc_losses` in every mode on 5 seeded 256^2 pairs
     within EVAL_TOL (control: two ground truths swapped), `python -m
     e3dge_torch.tools.gallery_video` of 2 images x 8 views written and
     read back (control: no --bounce). `python3 chip_smoke.py --phase 14`
     runs phases 1, 2 and 14 only.
The card-vs-CPU gates of phases 5, 7, 8, 9, 10c, 13 and 14 run their CPU
reference in a child process (`CpuReferences`: ST1_CPU_THREADS threads, the
lowest priority), started before the phase's card work and read after it:
phase 7 starts one for 7, 8, 9 and 13, which runs beside phases 7 to 10
(the rank phases 11 and 12 are CPU-bound), and phase 14's card runs come
before phase 13, beside which their references run, its gates after it.
Prints the wall seconds of each phase with its CPU references' and rank
processes' seconds (`wall_table`), a `kernels` JSON line (with each entry's
launches per path, and the `highest` entries the training paths launch),
the nvidia-smi line, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import OrderedDict, defaultdict

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


# The script's wall by phase, with the seconds its CPU references (child
# processes, `CpuReferences`: from the start to the last job's end, in the
# row of the phase that reads it) and its rank processes (`start_ranks`)
# ran and the seconds this process waited on each: `phase` opens a row, and
# `wall_table` is printed on a line before the last.
WALL: dict[str, dict] = {}
_CURRENT = {"phase": None, "t0": 0.0}
# every child process started, so that none outlives the script
CHILDREN: list[subprocess.Popen] = []


def phase(label: str) -> None:
    """Close the current phase's row of WALL and open `label`'s."""
    now = time.perf_counter()
    if _CURRENT["phase"] is not None:
        WALL[_CURRENT["phase"]]["s"] += now - _CURRENT["t0"]
    _CURRENT.update(phase=label, t0=now)
    WALL.setdefault(label, {"s": 0.0, "cpu_reference_s": 0.0, "cpu_wait_s": 0.0, "ranks_s": 0.0,
                            "ranks_wait_s": 0.0})


def wall_add(key: str, seconds: float) -> None:
    if _CURRENT["phase"] is not None:
        WALL[_CURRENT["phase"]][key] += seconds


def wall_table() -> dict:
    """{phase: its wall seconds, its CPU references' and rank processes' seconds
    and this process's waits on them}, with the total."""
    phase(_CURRENT["phase"] or "end")
    rows = {k: {f: round(v, 1) for f, v in r.items()} for k, r in WALL.items()}
    return {"wall_s": rows, "total_s": round(sum(r["s"] for r in WALL.values()), 1)}


def stop_children() -> None:
    """Kill every child process session still running (a failed phase leaves
    its CPU references and rank runs behind)."""
    for proc in CHILDREN:
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, 9)
            proc.wait()


# CPU references run in a child process beside the card's work, at
# ST1_CPU_THREADS threads (the numbers of an in-process run at those threads),
# at the lowest priority so that the card's host thread keeps its core
CPU_REFERENCE_TIMEOUT = 900


class CpuReferences:
    """CPU reference jobs run in order by one child process,
    `chip_smoke.py --cpu-reference SPEC` with no card visible: `add` queues
    a job (the name of a function of this module and its arguments), `start`
    starts the child, `result` waits for one job's result (the child saves
    each as it ends). Past CPU_REFERENCE_TIMEOUT seconds from its start the
    child is killed and the phase fails, as it does when the child fails
    (with its last output)."""

    def __init__(self, label: str):
        self.label, self.jobs, self.proc, self.waited = label, [], None, 0.0

    def add(self, name: str, *args) -> int:
        if self.proc is not None:
            raise RuntimeError(f"CPU reference {self.label}: a job added after the start")
        self.jobs.append((name, args))
        return len(self.jobs) - 1

    def start(self) -> "CpuReferences":
        self.out = tempfile.mkdtemp(prefix=f"e3dge_cpu_ref_{self.label}_")
        self.spec = os.path.join(self.out, "spec.pt")
        torch.save({"jobs": self.jobs}, self.spec)
        me = os.path.abspath(__file__)
        self.log_file = open(os.path.join(self.out, "output.log"), "w")
        self.proc = subprocess.Popen([sys.executable, me, "--cpu-reference", self.spec], cwd=os.path.dirname(me),
                                     env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, stdout=self.log_file,
                                     stderr=subprocess.STDOUT, start_new_session=True)
        CHILDREN.append(self.proc)
        self.t0, self.t0_wall, self.shown = time.perf_counter(), time.time(), 0
        return self

    def _output(self) -> str:
        return open(os.path.join(self.out, "output.log")).read()

    def result(self, i: int):
        t_wait = time.perf_counter()
        path = f"{self.spec}.{i}"
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                self.log_file.close()
                raise AssertionError(f"CPU reference {self.label} exited {self.proc.returncode} before job {i}:\n"
                                     f"{self._output()[-4000:]}")
            if time.perf_counter() - self.t0 > CPU_REFERENCE_TIMEOUT:
                stop_children()
                raise AssertionError(f"CPU reference {self.label}: still running after {CPU_REFERENCE_TIMEOUT} s, "
                                     "killed")
            time.sleep(0.2)
        result, seconds = torch.load(path, weights_only=False)
        done, ended = time.perf_counter(), os.stat(path).st_mtime - self.t0_wall
        self.waited += done - t_wait
        wall_add("cpu_wait_s", done - t_wait)
        lines = self._output().splitlines()
        for line in lines[self.shown:]:
            log(line)
        self.shown = len(lines)
        log(f"  CPU reference {self.label}, job {i} ({self.jobs[i][0]}, child process at {ST1_CPU_THREADS} "
            f"threads): {seconds:.1f} s, ended {ended:.1f} s after the child's start; waited "
            f"{done - t_wait:.1f} s")
        if i == len(self.jobs) - 1:
            self.proc.wait()
            self.log_file.close()
            wall_add("cpu_reference_s", ended)
            shutil.rmtree(self.out)
        return result


def cpu_reference_child(spec: str) -> int:
    """The child of `CpuReferences`: each job of SPEC run in order at
    ST1_CPU_THREADS threads, its result and seconds saved as SPEC.<i> (by
    way of a temporary file, so that a reader never sees half of one)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.nice(19)
    torch.set_num_threads(ST1_CPU_THREADS)
    for i, (name, args) in enumerate(torch.load(spec, weights_only=False)["jobs"]):
        t0 = time.perf_counter()
        result = globals()[name](*args)
        torch.save((result, time.perf_counter() - t0), f"{spec}.{i}.tmp")
        os.replace(f"{spec}.{i}.tmp", f"{spec}.{i}")
    return 0


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
    Returns the f32 card model with its device inputs, its image and the
    card-vs-CPU gate, which waits for the CPU reference (main runs it after
    phase 6, so that the reference runs beside phase 6's card work)."""
    from e3dge_torch.config import flagship_config

    cfg = dataclasses.replace(flagship_config(), dtype="float32")
    cfg = dataclasses.replace(cfg, renderer=dataclasses.replace(cfg.renderer, field_dtype="float32")).validate()
    card, ref, gate = f32_card_vs_cpu(cfg, device, defer=True)
    rel = float(((bf16_img - ref).abs() / (ref.abs().max() + 1e-6)).mean())
    ok = rel < TOL_BF16_VS_F32_REL
    log(f"  gen_imgs bf16 vs f32 on the card: mean rel err {rel:.4e} [tol {TOL_BF16_VS_F32_REL:g}] "
        f"{'ok' if ok else 'FAIL'}; f32 std {float(ref.std()):.4f}")
    if not ok:
        raise AssertionError("bf16 image2image drifted from f32")
    return card, ref, gate


def f32_model(cfg, dev, weights: str | None = None):
    """(model, images, mean latents, decoder noise) of an f32 cfg on dev:
    seeded weights (`init_weights`, then the function of this module named
    `weights`, if given), input and decoder noise."""
    model = seeded_e3dge(cfg, dev)
    if weights is not None:
        globals()[weights](model)
    images, ml = seeded_inputs(cfg, SEED)
    return (model, *to_device(images, ml, decoder_noise(cfg, 1, SEED), dev))


def f32_image2image_cpu(cfg, weights: str | None = None) -> torch.Tensor:
    """The CPU reference of phase 5's gate (a `CpuReferences` job):
    gen_imgs of `f32_model`'s image2image on the CPU."""
    t0 = time.perf_counter()
    model, images, ml, noise = f32_model(cfg, torch.device("cpu"), weights)
    out = model.image2image(images, ml, noise=noise)["res_render_out"]["gen_imgs"].float()
    log(f"  f32 image2image on cpu: {time.perf_counter() - t0:.1f} s (build + one call)")
    return out


def f32_card_vs_cpu(cfg, device, weights: str | None = None, defer: bool = False,
                    refs: "CpuReferences | None" = None, job: int | None = None):
    """Phase 5's gate: image2image of an f32 cfg on the card and on the CPU
    (`f32_image2image_cpu`, in a child process started first, beside the
    card's work) with `f32_model`'s weights, input and decoder noise:
    gen_imgs within TOL_CARD_VS_CPU. Returns (the card model with its device
    inputs, {device type: gen_imgs}); with `defer`, (the card model with its
    inputs, the card's gen_imgs, the gate: a function that waits for the CPU
    and returns that dict)."""
    own = refs is None
    refs = refs or CpuReferences("5")
    if job is None:  # else queued already, as `raw_density_gate` queues 13c's
        job = refs.add("f32_image2image_cpu", cfg, weights)
    if own:
        refs.start()
    t0 = time.perf_counter()
    model, d_images, d_ml, d_noise = f32_model(cfg, device, weights)
    out = model.image2image(d_images, d_ml, noise=d_noise)
    card_img = out["res_render_out"]["gen_imgs"].float().cpu()
    log(f"  f32 image2image on cuda: {time.perf_counter() - t0:.1f} s (build + one call)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model.image2image(d_images, d_ml, noise=d_noise)
    torch.cuda.synchronize()
    log(f"  f32 image2image on the card (highest field): {(time.perf_counter() - t0) * 200:.2f} ms per inversion")
    card = (model, d_images, d_ml, d_noise)
    del out

    def gate() -> dict:
        outs = {"cuda": card_img, "cpu": refs.result(job)}
        diff = float((outs["cuda"] - outs["cpu"]).abs().max())
        ok = diff <= TOL_CARD_VS_CPU and math.isfinite(diff)
        log(f"  gen_imgs card vs CPU (f32, full width): max abs {diff:.3e} [tol {TOL_CARD_VS_CPU:g}] "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("card and CPU image2image disagree")
        return outs

    return (card, card_img, gate) if defer else (card, gate())


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
ST1_PART_NAMES = ("sampling", "forward+loss", "backward", "optimizer")
# card vs CPU on one stage-1 step of a reduced config, f32, TF32 off. The
# CPU reference runs at ST1_CPU_THREADS threads, so its summation order does
# not move with the host's core count. Gates: each loss term within a
# relative 1e-3; E0's gradient, all leaves together, within a relative L2 of
# ST1_TOL_GRAD, and each leaf within ST1_TOL_LEAF (the worst leaf is a deep
# block's train-mode BN bias, a small sum of large terms). Control: the card
# step with the eikonal double backward cut (the predicted SDF gradients
# taken as constants) must fail the gradient gate.
ST1_TOL_TERM, ST1_TOL_GRAD, ST1_TOL_LEAF = 1e-3, 1e-2, 3e-2
ST1_CPU_THREADS = 8
# 13c's reduced bn step: its depth context convs see the seeded field's
# nearly flat depth map, so their leaves' gradients read the
# depth's last bits, and the card's worst leaf (the depth block's first
# BatchNorm scale) read 1.35e-2 to past ST1_TOL_LEAF from one H100 machine to
# the next. The plain field in place of the kernel (3xTF32, within
# KERNEL_TOLERANCE) moves that leaf by as much on the card itself. Each
# leaf's limit there is ST1_TOL_LEAF plus this factor x that leaf's
# kernel-vs-plain gap, measured in the same run (`leaf_limits`).
LEAF_FIELD_FACTOR = 2.0


def st1_reduced_config():
    """stage1_config cut for the card-vs-CPU check: the field at depth 8 and
    width 256 (so the kernel samples the batch) rendering 32^2, the decoder to
    128^2, E0 unchanged."""
    from e3dge_torch.config import _with, stage1_config

    return _with(stage1_config(), renderer=dict(out_im_res=32), decoder=dict(size=128, in_res=32),
                 encoder=dict(n_styles_decoder=6)).validate()


# seeded builds, each made once per configuration on the CPU and copied to
# the device for every use: a full-width build and its seeding take seconds
# of host time, and the gates build the same seeded model many times
_PRISTINE: dict = {}


def _pristine(key, build):
    if key not in _PRISTINE:
        _PRISTINE[key] = build()
    return _PRISTINE[key]


def seeded_e3dge(cfg, device):
    """E3DGE(cfg) on device with `init_weights(model, SEED)`: bitwise the
    model E3DGE(cfg, device=device) and init_weights give (E3DGE builds on
    the CPU and moves, init_weights draws on the CPU), copied from one
    seeded CPU build per cfg."""
    import copy

    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.utils.device import resolve_device
    from e3dge_torch.utils.weights import init_weights

    def build():
        model = E3DGE(cfg, device="cpu")
        init_weights(model, SEED)
        return model

    model = copy.deepcopy(_pristine(("e3dge", cfg), build)).to(device)
    model.device = resolve_device(device)
    return model


def seeded_perceptual(device):
    """make_perceptual_fns(device, seed=SEED), copied from one CPU build."""
    import copy

    from e3dge_torch.training.perceptual import make_perceptual_fns

    return tuple(copy.deepcopy(net).to(device) for net in _pristine(("perceptual",),
                                                                     lambda: make_perceptual_fns("cpu", seed=SEED)))


def seeded_discriminator(d_res: int, device):
    """The full-res D at d_res seeded from SEED + 3, frozen, copied from one
    CPU build."""
    import copy

    from e3dge_torch.models.discriminator import Discriminator
    from e3dge_torch.utils.weights import init_weights

    def build():
        d = Discriminator(d_res)
        init_weights(d, SEED + 3)
        return d

    return copy.deepcopy(_pristine(("d", d_res), build)).to(device).requires_grad_(False)


def st1_model(cfg, device):
    """(model, mean latents, lpips_fn, id_fn, train state): seeded weights
    (init_weights), phase 4's seeded mean latents, seeded perceptual nets, E0
    trainable under Adam at ST1_LR."""
    from e3dge_torch.training import steps

    model = seeded_e3dge(cfg, device)
    ml = to_device(*seeded_inputs(cfg, SEED), [], device)[1]
    lpips_fn, id_fn = seeded_perceptual(device)
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


def st1_expected(cfg) -> tuple[dict, dict]:
    """A stage-1 step's field evaluations at cfg's dtypes: ({(entry,
    precision): kernel launches}, {(part, precision): twin evaluations}). The
    kernel: the frozen-GAN render (`sample_field_dtype`) and its two SDF
    targets (`highest`), under no_grad. The twin: the inversion's render
    (`field_dtype`) and four SDF queries (`highest`: the uniform and surface
    points at the predicted latents, the two eikonal terms)."""
    from e3dge_torch.models.volume_renderer import field_precision

    launches, twin = defaultdict(int), defaultdict(int)
    launches[("siren_field_full", field_precision(cfg.renderer.sample_field_dtype))] += 1
    launches[("siren_field_full", "highest")] += 2
    twin[("field", field_precision(cfg.renderer.field_dtype))] += 1
    twin[("field", "highest")] += 4
    return dict(launches), dict(twin)


def field_split(fn):
    """(fn's result, {(entry, precision): kernel launches}, {(part,
    precision): twin evaluations}) over one call, the zero counts left out."""
    from e3dge_torch.models import volume_renderer as vr

    vr.reset_twin_counts()
    out, _, split = counted_split(fn)
    return out, {k: n for k, n in split.items() if n}, {k: n for k, n in vr.twin_counts.items() if n}


def twin_ms(model, batch: int, precision: str, texture: bool) -> float:
    """ms of one forward + backward of the eager twin at a training step's
    render shape (CUDA events, 3 after 1), on seeded operands: the whole
    field with the styles differentiated (stage 1's inversion render), or the
    texture head on a no-grad backbone with the SFT modulations
    differentiated (stage 2's conditioned re-render)."""
    from e3dge_torch.ops.siren_field import io_dtype

    c = model.cfg.renderer
    ren, dev, dt = model.generator.renderer, model.device, io_dtype(precision)
    g = torch.Generator(dev).manual_seed(SEED)
    shp = (batch, c.out_im_res, c.out_im_res, c.n_samples)
    pts = (torch.rand(*shp, 3, device=dev, generator=g) * 2 - 1) * ren.camera_dist_radius
    dirs = torch.nn.functional.normalize(torch.randn(*shp, 3, device=dev, generator=g), dim=-1)
    styles = 0.3 * torch.randn(batch, c.depth + 1, c.style_dim, device=dev, generator=g)
    if texture:
        h = torch.rand(*shp, c.width, device=dev, generator=g).to(dt) * 2 - 1
        cond = [(0.1 * torch.randn(*shp, c.width, device=dev, generator=g)).to(dt).requires_grad_()
                for _ in range(2)]

        def run():
            rgb, feat = ren.network.tex_head(h, dirs.to(dt), styles.to(dt), tuple(cond))
            torch.autograd.grad(rgb.float().sum() + feat.float().sum(), cond)
    else:
        styles.requires_grad_()

        def run():
            feat, rgb_sdf, _ = ren._twin_field(pts, dirs, styles, None, precision, False)
            torch.autograd.grad(rgb_sdf.sum() + feat.float().sum(), styles)

    return cuda_ms(run, iters=3, warmup=1)


def run_stage1(device, cfg=None, tag: str = "7") -> dict:
    """Phase 7 (and 13a at the stage scripts' dtypes): stage-1 training at
    stage1_config (64^2 x 18 field samples, SIREN 8 x 256, IR-SE-50 at 256^2,
    decoder to 1024^2; f32 unless cfg says otherwise), B=4: ST1_WARMUP +
    ST1_STEPS steps, each timed by CUDA events in four parts and its field
    evaluations counted (the kernel's launches by precision, the twin's);
    then the checks (finite terms, E0 moved, the rest frozen, a gradient on
    the renderer W+), a profile of two steps and the twin's forward and
    backward timed alone at the render's shape. Returns the launch counts of
    the measured steps, the kernel check (phase 7's) and the figures."""
    from e3dge_torch.config import stage1_config
    from e3dge_torch.models.volume_renderer import field_precision
    from e3dge_torch.training import steps

    kernel = st1_kernel_check(device) if cfg is None else None
    cfg = cfg or stage1_config()
    want_launches, want_twin = st1_expected(cfg)
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
    parts = []
    for i in range(ST1_WARMUP + ST1_STEPS):
        (ev, metrics, w_plus), split, twin = field_split(lambda: one_step(retain=i == 0))
        if (split, twin) != (want_launches, want_twin):
            raise AssertionError(f"[{tag}] stage-1 step {i} launched {split} and ran the twin {twin}, expected "
                                 f"{want_launches} and {want_twin}")
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
    launches = {k: sum(n for (e, _), n in want_launches.items() if e == k) * ST1_STEPS for k in ST1_LAUNCHES}
    log(f"  [{tag}] per step, as expected: kernel {split_text(want_launches)}; twin "
        f"{split_text(want_twin)}; over the {ST1_STEPS} measured steps {launches}")

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
    twin = twin_ms(model, ST1_BATCH, field_precision(cfg.renderer.field_dtype), texture=False)
    log(f"  device busy {busy:.3f} ms per step in {sum(n_launch.values()) // 2} launches (field kernel {field:.3f} ms); "
        f"busy share {busy / wall_ms:.3f} of the {wall_ms:.2f} ms median step; the render's twin "
        f"({cfg.renderer.field_dtype}) forward + backward alone {twin:.3f} ms, {twin / busy:.3f} of busy")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  kernel {us / 2e3:8.4f} ms {n_launch[name] // 2:5d}x  {name[:100]}")
    del model, state, lpips_fn, id_fn, frozen, e0_before
    torch.cuda.empty_cache()
    figures = {"ms": wall_ms, "parts": dict(zip(ST1_PART_NAMES, np.median(parts, axis=0).tolist())), "busy_ms": busy,
               "field_ms": field, "twin_ms": twin, "twin_share": twin / busy, "peak_gib": peak}
    return {"launches": launches, "per_step": {k: launches[k] // ST1_STEPS for k in launches},
            "split": want_launches, "kernel": kernel, "figures": figures}


# a leaf whose reference gradient is below this share of the whole gradient's
# norm is zero but for rounding (a BatchNorm shift that feeds only other
# train-mode BatchNorms, as in the ADA aligner): its error is taken against
# that floor, not against its own noise
LEAF_FLOOR = 1e-6


def leaf_gaps(got: dict, want: dict) -> dict:
    """{leaf: relative L2 gap}, each leaf's against max(its norm, LEAF_FLOOR x
    the whole norm)."""
    floor = LEAF_FLOOR * math.sqrt(sum(float(want[k].double().square().sum()) for k in want))
    return {k: float((got[k] - want[k]).norm()) / max(float(want[k].norm()), floor, 1e-30) for k in want}


def grad_gap(got: dict, want: dict) -> tuple[float, str, float]:
    """(relative L2 of all leaves together, the worst leaf, its relative L2
    by `leaf_gaps`)."""
    num = sum(float((got[k] - want[k]).double().square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    leaf = leaf_gaps(got, want)
    worst = max(leaf, key=leaf.get)
    return math.sqrt(num / den), worst, leaf[worst]


def leaf_limits(field_gap: dict | None, keys) -> dict:
    """Each leaf's limit in the reduced step's card-vs-CPU gate: ST1_TOL_LEAF,
    plus LEAF_FIELD_FACTOR x the leaf's gap between the card's step through
    the field kernel and through the plain field (`field_gap`, by
    `leaf_gaps`) where that is measured."""
    return {k: ST1_TOL_LEAF + (LEAF_FIELD_FACTOR * field_gap[k] if field_gap else 0.0) for k in keys}


def worst_leaf(gaps: dict, limits: dict) -> tuple[str, float, float]:
    """(the leaf nearest its limit or farthest past it, its gap, its limit)."""
    k = max(gaps, key=lambda k: gaps[k] / limits[k])
    return k, gaps[k], limits[k]


def to_dev(x, dev):
    """A tensor or a CameraParams of tensors on dev."""
    from e3dge_torch.render.camera import CameraParams

    return CameraParams(*(f.to(dev) for f in x)) if isinstance(x, CameraParams) else x.to(dev)


@contextlib.contextmanager
def tf32_off():
    """TF32 off in cuDNN and matmul for the block, the flags restored after."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def reduced_batch(model, device, pair_same_id: bool) -> dict:
    """The reduced gates' batch: decoder noise and `synthetic_sample` of B=2
    from one generator seeded with SEED on the card (the kernel samples it),
    moved to the CPU, which every run of the gate then reads."""
    from e3dge_torch.training import steps

    gen = torch.Generator(device).manual_seed(SEED)
    noise = steps.decoder_noise(model, 2, gen)
    batch = model.synthetic_sample(2, 1.0, pair_same_id=pair_same_id, generator=gen, noise=noise)
    return {"noise": [n.cpu() for n in noise], "batch": {k: to_dev(v, torch.device("cpu")) for k, v in batch.items()}}


def st1_step(cfg, dev, data: dict, cut: bool = False) -> tuple[dict, dict]:
    """One stage-1 step of cfg at B=2 on dev from `reduced_batch`'s data:
    (the loss terms, E0's gradient on the CPU); `cut` cuts the eikonal
    double backward (the control). On the CPU, a job of the child of
    `start_cpu_reference`."""
    from unittest import mock

    from e3dge_torch.training import steps

    dev = torch.device(dev)
    eikonal = steps.eikonal_term

    def cut_eikonal(renderer, pts, styles, create_graph=False):
        return eikonal(renderer, pts, styles, create_graph=False)

    t0 = time.perf_counter()
    model, ml, lpips_fn, id_fn, state = st1_model(cfg, dev)
    b = {k: to_dev(v, dev) for k, v in data["batch"].items()}
    with mock.patch.object(steps, "eikonal_term", cut_eikonal) if cut else contextlib.nullcontext():
        loss, metrics, _ = steps.stage1_loss(model, b, ml, steps.STAGE1_LAMBDAS, lpips_fn, id_fn,
                                             noise=[n.to(dev) for n in data["noise"]])
    loss.backward()
    out = ({k: float(metrics[k].detach()) for k in ("loss",) + ST1_TERMS},
           {k: p.grad.detach().float().cpu() for k, p in state.params.items()})
    name = "CPU" if dev.type == "cpu" else ("card, double backward cut" if cut else "card")
    log(f"  reduced stage-1 step, {name}: {time.perf_counter() - t0:.1f} s (build + one step)")
    return out


def st1_card_vs_cpu(device, refs: "CpuReferences | None" = None):
    """Phase 7, last part: one stage-1 step of `st1_reduced_config` at B=2,
    same weights, from one batch made on the card (the kernel samples it):
    the loss terms and E0 gradients on the card, on the card with the eikonal
    double backward cut (the control) and on the CPU at ST1_CPU_THREADS
    threads (the reference, `st1_step` in a `CpuReferences` child),
    each compared with the reference. Returns the gate: a function that runs
    the card's steps, waits for the CPU's and compares (main calls it after
    phase 7's card work, beside which the reference runs)."""
    cfg = st1_reduced_config()
    with tf32_off():
        data = reduced_batch(st1_model(cfg, device)[0], device, pair_same_id=False)
    own = refs is None
    refs = refs or CpuReferences("7")
    job = refs.add("st1_step", cfg, "cpu", data)
    if own:
        refs.start()

    def gate() -> None:
        with tf32_off():
            runs = {"card": st1_step(cfg, device, data), "card, double backward cut": st1_step(cfg, device, data, True)}
        torch.cuda.empty_cache()
        runs["CPU"] = refs.result(job)
        m_ref, g_ref = runs["CPU"]
        log("  terms card / CPU: " + ", ".join(f"{k} {runs['card'][0][k]:.6g} / {m_ref[k]:.6g}" for k in m_ref))
        gaps = {}
        for name in ("card", "card, double backward cut"):
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

    return gate


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
    from e3dge_torch.training import steps

    model = seeded_e3dge(cfg, device)
    ml = to_device(*seeded_inputs(cfg, SEED), [], device)[1]
    lpips_fn, id_fn = seeded_perceptual(device)
    state = steps.create_train_state(model, trainable, ST2_LR, "adam", ema=True)
    return model, ml, lpips_fn, id_fn, state, seeded_discriminator(d_res, device)


def st2_expected(cfg) -> tuple[dict, dict, dict]:
    """A stage-2.2 iteration's field evaluations at cfg's dtypes: ({(entry,
    precision): launches} of the D half, of the E half, {(part, precision):
    twin evaluations} of the E half). The D's fake producer: a frozen-GAN
    sample (its render at `sample_field_dtype`, two SDF targets `highest`)
    and its `image2image` (the render with raw_h and the texture pass, at
    `field_dtype`). The E step: a sample as the D's, the ref render and the
    query render (raw_h kept) at `field_dtype`, under no_grad; the
    conditioned re-render, the twin's texture head on the query's raw_h."""
    from e3dge_torch.models.volume_renderer import field_precision

    sample, field = (field_precision(d) for d in (cfg.renderer.sample_field_dtype, cfg.renderer.field_dtype))
    d_half, e_half = defaultdict(int), defaultdict(int)
    for half in (d_half, e_half):
        half[("siren_field_full", sample)] += 1
        half[("siren_field_full", "highest")] += 2
        half[("siren_field_full", field)] += 1
    d_half[("siren_field_tex", field)] += 1
    e_half[("siren_field_full", field)] += 1
    return dict(d_half), dict(e_half), {("texture", field): 1}


def run_stage2(device, cfg=None, tag: str = "8", warmup: int = ST2_WARMUP, iters: int = ST2_ITERS,
               profile: bool = True) -> dict:
    """Phase 8 (13b at the stage scripts' dtypes, 13c with the bn netLocal):
    stage-2.2 training at stage2_config (64^2 x 24 field samples, SIREN 8 x
    256, IR-SE-50 at 256^2, 4-stack hourglass, decoder to 1024^2; f32 unless
    cfg says otherwise), B=4, the full-res D at 256^2: warmup + iters
    iterations of (D producer, D step, E step), each part timed by CUDA
    events and each half's field evaluations counted (the kernel's launches
    by precision, the twin's); the checks (finite terms, what moves and what
    stays, every BN's statistics moved, the EMA, an R1 step); with
    `profile`, a warm D step with R1 timed, a profile of two iterations and
    the texture twin's forward and backward timed alone. Returns the launch
    counts, the kernel check (phase 8's) and the figures."""
    from e3dge_torch.config import stage2_config
    from e3dge_torch.models.volume_renderer import field_precision
    from e3dge_torch.training import steps

    kernel = st2_kernel_check(device) if cfg is None else None
    cfg = cfg or stage2_config()
    want_d, want_e, want_twin = st2_expected(cfg)
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
        """(CUDA events, E metrics, D metrics, D-half launches, E-half
        launches, E-half twin evaluations)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(ST2_PARTS) + 1)]

        def d_half():
            ev[0].record()
            fakes, reals = steps.full_d_batch(model, ml, ST2_BATCH, d_res, gen)
            ev[1].record()
            d_metrics = d_step(reals, fakes)
            ev[2].record()
            return d_metrics

        def e_half():
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
            return metrics

        d_metrics, d_counts, d_twin = field_split(d_half)
        metrics, e_counts, e_twin = field_split(e_half)
        if d_twin:
            raise AssertionError(f"[{tag}] the D half ran the twin: {d_twin}")
        return ev, metrics, d_metrics, d_counts, e_counts, e_twin

    torch.cuda.reset_peak_memory_stats()
    parts, r1 = [], []
    for i in range(warmup + iters):
        before = {k: p.detach().clone() for k, p in state.params.items()} if i == 0 else None
        ev, metrics, d_metrics, d_counts, e_counts, e_twin = one_iter()
        if (d_counts, e_counts, e_twin) != (want_d, want_e, want_twin):
            raise AssertionError(f"[{tag}] stage-2 iteration {i} launched {d_counts} + {e_counts}, twin {e_twin}; "
                                 f"expected {want_d} + {want_e}, twin {want_twin}")
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
        if i >= warmup:
            parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(len(ST2_PARTS))])
        log(f"  iteration {i}{' (warm-up)' if i < warmup else ''}: "
            + ", ".join(f"{k} {v:.5g}" for k, v in vals.items()))
    peak = peak_gib()
    log(f"  [{tag}] per iteration, as expected: D half {split_text(want_d)}; E half {split_text(want_e)}, twin "
        f"{split_text(want_twin)}")
    if not (r1[0] > 0 and all(v == 0 for v in r1[1:])):
        raise AssertionError(f"lazy R1 not at D step 0 only: {r1}")
    parts = np.asarray(parts)
    total = parts.sum(axis=1)
    log(f"  [{tag}] ms per stage-2 iteration (B={ST2_BATCH}, CUDA events over {iters} iterations): median "
        f"{np.median(total):.2f}, min {total.min():.2f}, max {total.max():.2f}; median "
        + ", ".join(f"{name} {np.median(parts[:, j]):.2f}" for j, name in enumerate(ST2_PARTS))
        + f"; peak memory {peak:.2f} GiB")
    figures = {"ms": float(np.median(total)), "parts": dict(zip(ST2_PARTS, np.median(parts, axis=0).tolist())),
               "peak_gib": peak}
    if profile:
        r1_step(model, ml, d_res, gen, d_state, d_step, parts)
    check_stage2_state(model, sd0, d, d0, lpips_fn, id_fn, frozen_nets)
    if profile:
        wall_ms = figures["ms"]
        kernel_us, n_launch = device_kernels(lambda: one_iter(), 2)
        busy = sum(kernel_us.values()) / 2e3
        field = sum(us for name, us in kernel_us.items() if "siren_field" in name) / 2e3
        twin = twin_ms(model, ST2_BATCH, field_precision(cfg.renderer.field_dtype), texture=True)
        log(f"  device busy {busy:.3f} ms per iteration in {sum(n_launch.values()) // 2} launches (field kernel "
            f"{field:.3f} ms, {field / busy:.3f} of busy); busy share {busy / wall_ms:.3f} of the {wall_ms:.2f} ms "
            f"median iteration; the texture twin ({cfg.renderer.field_dtype}) forward + backward alone {twin:.3f} "
            f"ms, {twin / busy:.3f} of busy")
        for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]:
            log(f"  kernel {us / 2e3:8.4f} ms {n_launch[name] // 2:5d}x  {name[:100]}")
        figures.update(busy_ms=busy, field_ms=field, twin_ms=twin, twin_share=twin / busy)
    del model, state, lpips_fn, id_fn, d, d_state, sd0, frozen_nets
    torch.cuda.empty_cache()
    per_iter = {k: sum(n for (e, _), n in (*want_d.items(), *want_e.items()) if e == k) for k in ST2_E_LAUNCHES}
    return {"per_iter": per_iter, "launches": {k: v * iters for k, v in per_iter.items()}, "kernel": kernel,
            "ms": figures["ms"], "split": (want_d, want_e), "figures": figures}


def r1_step(model, ml, d_res: int, gen, d_state, d_step, parts) -> None:
    """Phase 8: a warm D step with the lazy R1 timed (CUDA events) beside the
    measured D steps without it, then profiled."""
    from e3dge_torch.training import steps

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


def check_stage2_state(model, sd0, d, d0, lpips_fn, id_fn, frozen_nets) -> None:
    """Phase 8's state checks after the iterations (--fix-ada): local and the
    fusion block moved, the aligner and E0 did not, every BatchNorm's running
    statistics moved (E0's, the aligner's and, for the bn netLocal, the local
    net's: train mode), the generator, volume D and perceptual nets
    bit-identical, no frozen gradient, the D moved."""
    sd = model.state_dict()
    tops = ("local", "fuse_sft_block", "grid_align", "encoder")
    moved = {top: sum(not torch.equal(p, sd0[f"{top}.{k}"]) for k, p in getattr(model, top).named_parameters())
             for top in tops}
    n_p = {top: sum(1 for _ in getattr(model, top).parameters()) for top in tops}
    bn = {top: [k for k in sd if k.startswith(f"{top}.") and "running_" in k] for top in tops}
    bn_moved = {top: sum(not torch.equal(sd[k], sd0[k]) for k in keys) for top, keys in bn.items() if keys}
    log(f"  parameters moved: {moved} of {n_p}; BN running statistics moved: {bn_moved} of "
        f"{ {top: len(keys) for top, keys in bn.items() if keys} }")
    if moved["local"] < n_p["local"] // 2 or moved["fuse_sft_block"] < n_p["fuse_sft_block"] // 2:
        raise AssertionError("local or fuse_sft_block did not move")
    if moved["grid_align"] or moved["encoder"]:
        raise AssertionError("the frozen aligner (--fix-ada) or E0 moved")
    if any(bn_moved[top] != len(bn[top]) for top in bn_moved):
        raise AssertionError("a BatchNorm's running statistics did not move (train mode)")
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


def st2_reduced_config():
    """stage2_config cut for the card-vs-CPU check as phase 7 cuts stage 1:
    the field at depth 8 and width 256 rendering 32^2, the decoder to 128^2,
    E0 and the E1 branch unchanged."""
    from e3dge_torch.config import _with, stage2_config

    return _with(stage2_config(), renderer=dict(out_im_res=32), decoder=dict(size=128, in_res=32),
                 encoder=dict(n_styles_decoder=6)).validate()


ST2_GATE_LAMBDAS = dict(ST2_LAMBDAS, hit_prob_consistency_lambda=0.1, depth_lambda=0.1)
ST2_GATE_TERMS = ("loss",) + ST2_TERMS + ("d_weight", "hit_prob_consistency", "depth_consistency")


def st2_step(cfg, dev, data: dict, cut: bool = False, plain: bool = False) -> tuple[dict, dict]:
    """One stage-2 cycle loss and backward of cfg at B=2 on dev from
    `reduced_batch`'s data with every branch on (`st2_card_vs_cpu`): (the
    loss terms, the trainable gradient on the CPU); `cut` detaches the SFT
    modulations before the re-render (the control), `plain` runs the plain
    field in place of the kernel. On the CPU, a job of the child of
    `start_cpu_reference`."""
    from unittest import mock

    from e3dge_torch.models import volume_renderer
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.training import steps

    dev = torch.device(dev)
    t0 = time.perf_counter()
    model, ml, lpips_fn, id_fn, state, d = st2_model(cfg, dev, steps.STAGE22_TRAINABLE, min(cfg.decoder.size, 256))
    b = {k: to_dev(v, dev) for k, v in data["batch"].items()}
    probe = [p for k, p in state.params.items() if k.startswith("local.")]
    render_cached = model.generator.render_cached

    def detached(styles, cached, conditions, **kw):
        return render_cached(styles, cached, tuple(t.detach() for t in conditions), **kw)

    with contextlib.ExitStack() as stack:
        if cut:
            stack.enter_context(mock.patch.object(model.generator, "render_cached", detached))
        if plain:
            stack.enter_context(mock.patch.object(volume_renderer, "siren_field_full", sf.siren_field_reference))
            stack.enter_context(mock.patch.object(volume_renderer, "siren_field_tex", sf.siren_field_tex_reference))
        loss, metrics, _ = steps.cycle_loss(model, b, ml, ST2_GATE_LAMBDAS, lpips_fn, id_fn, use_ref_view_weight=True,
                                            d_fn=d, adaptive_params=probe, noise=[n.to(dev) for n in data["noise"]])
    loss.backward()
    out = ({k: float(metrics[k].detach()) for k in ST2_GATE_TERMS},
           {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().float().cpu()
            for k, p in state.params.items()})
    name = ("CPU" if dev.type == "cpu" else "card, SFT detached" if cut else "card, plain field" if plain
            else "card")
    log(f"  reduced stage-2 step, {name}: {time.perf_counter() - t0:.1f} s (build + one step)")
    return out


def st2_card_vs_cpu(device, cfg=None, field_gap: bool = False, refs: "CpuReferences | None" = None):
    """Phase 8, last part (13c with the bn netLocal's cfg and field_gap): one
    stage-2 cycle loss and backward of `st2_reduced_config` (or cfg) at B=2
    from one batch made on the card, with every
    branch on (the adversarial term at the adaptive weight, the exact ref-view
    weighting, both consistency terms, the aligner trained): the loss terms
    and the trainable gradient on the card, on the card with the SFT
    modulations detached before the re-render (the control) and on the CPU at
    ST1_CPU_THREADS threads (the reference, `st2_step` in a `CpuReferences`
    child), within phase 7's limits. With field_gap, the step also
    runs on the card through the plain field in place of the kernel, and
    each leaf's limit grows by `leaf_limits`. Returns the gate, a function
    that runs the card's steps, waits for the CPU's and compares."""
    from e3dge_torch.training import steps

    cfg = cfg or st2_reduced_config()
    with tf32_off():
        model = st2_model(cfg, device, steps.STAGE22_TRAINABLE, min(cfg.decoder.size, 256))[0]
        data = reduced_batch(model, device, pair_same_id=True)
        del model
    own = refs is None
    refs = refs or CpuReferences("8")
    job = refs.add("st2_step", cfg, "cpu", data)
    if own:
        refs.start()

    def gate() -> None:
        with tf32_off():
            runs = {"card": st2_step(cfg, device, data), "card, SFT detached": st2_step(cfg, device, data, cut=True)}
            if field_gap:
                runs["card, plain field"] = st2_step(cfg, device, data, plain=True)
        torch.cuda.empty_cache()
        runs["CPU"] = refs.result(job)
        m_ref, g_ref = runs["CPU"]
        log("  terms card / CPU: " + ", ".join(f"{k} {runs['card'][0][k]:.6g} / {m_ref[k]:.6g}" for k in m_ref))
        limits = leaf_limits(leaf_gaps(runs["card"][1], runs["card, plain field"][1]) if field_gap else None, g_ref)
        if field_gap:
            k, gap, lim = worst_leaf(leaf_gaps(runs["card"][1], runs["card, plain field"][1]), {k: 1.0 for k in g_ref})
            log(f"  card through the kernel vs through the plain field: worst leaf {gap:.3e} at {k}; each leaf's "
                f"limit {ST1_TOL_LEAF:g} + {LEAF_FIELD_FACTOR:g}x its gap (largest {max(limits.values()):.3e})")
        gaps = {}
        for name in ("card", "card, SFT detached"):
            m, g = runs[name]
            term = max(abs(m[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-6) for k in m_ref)
            glob = grad_gap(g, g_ref)[0]
            gaps[name] = (term, glob, *worst_leaf(leaf_gaps(g, g_ref), limits))
            log(f"  {name} vs CPU at {ST1_CPU_THREADS} threads: worst term relative error {term:.3e}; trainable "
                f"gradient relative L2 {glob:.3e} over {len(g_ref)} leaves, worst leaf {gaps[name][3]:.3e} "
                f"[limit {gaps[name][4]:.3e}] at {gaps[name][2]}")
        term, glob, _, leaf, lim = gaps["card"]
        ok = term < ST1_TOL_TERM and glob < ST1_TOL_GRAD and leaf < lim
        each = f"{ST1_TOL_LEAF:g} + {LEAF_FIELD_FACTOR:g}x the field's gap" if field_gap else f"{ST1_TOL_LEAF:g}"
        log(f"  card vs CPU [terms < {ST1_TOL_TERM:g}, gradient < {ST1_TOL_GRAD:g}, each leaf < {each}]: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the stage-2 step disagrees between the card and the CPU")
        _, glob, _, leaf, lim = gaps["card, SFT detached"]
        seen = glob >= ST1_TOL_GRAD or leaf >= lim
        log(f"  control (SFT detached) {'fails' if seen else 'PASSES'} the gradient gate")
        if not seen:
            raise AssertionError("the gradient gate does not see the SFT modulations' gradient")

    return gate


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
def patched(obj, **fns):
    """obj's attributes replaced by fns[name](original) while active."""
    originals = {n: getattr(obj, n) for n in fns}
    for n, wrap in fns.items():
        setattr(obj, n, wrap(originals[n]))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(obj, n, fn)


def host_timed(record: dict, name: str):
    """A wrapper for `patched`: each call appends (its host-clock ms, the
    card synchronised at both ends; its field launches by (entry,
    precision)) to record[name]."""
    from e3dge_torch.ops import siren_field as sf

    def wrap(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            before = dict(sf.precision_launch_counts)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            record[name].append((ms, {k: v - before[k] for k, v in sf.precision_launch_counts.items()
                                      if v - before[k]}))
            return out
        return call
    return wrap


def host_ms(record: dict, name: str) -> float:
    """The ms of every call `host_timed` recorded under name."""
    return sum(ms for ms, _ in record[name])


def probed(names, record: list):
    """A `patched` context: while active, each Runner method in `names` is
    timed on the host clock around a synchronise and profiled
    (torch.profiler, CUDA activity only): its wall ms, device busy ms, field
    kernel ms and peak memory go to `record`."""
    from torch.profiler import ProfilerActivity, profile

    from e3dge_torch.runner import Runner

    def wrap(name):
        def deco(fn):
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
        return deco

    return patched(Runner, **{n: wrap(n) for n in names})


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


def perceptual_files(root: str) -> list[str]:
    """Seeded LPIPS and ArcFace .pth files in root holding a subset of their
    nets' keys (the LPIPS heads; ArcFace without its body), as the released
    files are read partially; returns the CLI flags that name them."""
    from e3dge_torch.training.perceptual import make_perceptual_fns

    paths = os.path.join(root, "lpips.pth"), os.path.join(root, "arcface.pth")
    if not os.path.exists(paths[1]):
        lp, idl = make_perceptual_fns("cpu", seed=SEED + 5)
        torch.save({k: v for k, v in lp.state_dict().items() if k.startswith("lin")}, paths[0])
        torch.save({k: v for k, v in idl.facenet.state_dict().items() if not k.startswith("body.")}, paths[1])
    return ["--lpips-ckpt", paths[0], "--arcface-ckpt", paths[1]]


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
    from PIL import Image

    from e3dge_torch.utils.editing import ATTRS

    cfg = demo_view_synthesis_config()
    data = write_folder(os.path.join(root, "imgs"), smooth_images(EVAL_IMAGES, cfg.pifu.load_size, SEED))
    perceptual = perceptual_files(root)
    rng = np.random.RandomState(SEED)
    for attr in ATTRS[:4]:
        for space, dim in (("renderer", cfg.renderer.style_dim), ("decoder", cfg.decoder.style_dim)):
            os.makedirs(os.path.join(root, "bounds", f"{space}_{attr}"))
            np.save(os.path.join(root, "bounds", f"{space}_{attr}", "boundary.npy"),
                    (rng.randn(1, dim) / np.sqrt(dim)).astype(np.float32))
    out = os.path.join(root, "out")
    base = ["--data", data, "--out", out, "--batch", str(EVAL_BATCH)]
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


def eval_validation(cfg, dev, folder: str, work_dir: str) -> dict:
    """`Runner.validation` of cfg at B=EVAL_BATCH over `folder` on dev with
    seeded weights and phase 4's seeded mean latents: its scores. On the
    CPU, a job of the child of `CpuReferences`."""
    from e3dge_torch.runner import Runner

    dev = torch.device(dev)
    _, ml = seeded_inputs(cfg, SEED)
    runner = Runner(seeded_e3dge(cfg, dev), ml, dev, work_dir=work_dir)
    return runner.validation(folder, batch_size=EVAL_BATCH)


def eval_card_vs_cpu(device, root: str, refs: "CpuReferences | None" = None):
    """Phase 9, second part: `Runner.validation` at `eval_reduced_config`,
    B=2 over 5 seeded PNGs (a ragged last batch), same weights, f32 with TF32
    off, on the card and on the CPU (ST1_CPU_THREADS threads, `eval_validation`
    in a `CpuReferences` child): loss_l2, mae, ssim and PSNR within EVAL_TOL. Two
    controls, each on the card, must fall
    outside: the field in bf16 (the serving kernel, a lower-precision
    render), and the last batch's padded row scored too (the folder with its
    last image repeated as a sixth, the fault the ragged batch's mask guards
    against). Returns the gate, a function that runs the card's calls, waits
    for the CPU's and compares."""
    from e3dge_torch.config import _with

    cfg = eval_reduced_config()
    imgs = smooth_images(EVAL_IMAGES, cfg.pifu.load_size, SEED + 1)
    folders = {"": write_folder(os.path.join(root, "cmp"), imgs),
               "padded": write_folder(os.path.join(root, "cmp_padded"), np.concatenate([imgs, imgs[-1:]]))}
    own = refs is None
    refs = refs or CpuReferences("9")
    job = refs.add("eval_validation", cfg, "cpu", folders[""], os.path.join(root, "cmp_cpu"))
    if own:
        refs.start()
    controls = ("card, the field in bf16", "card, the padded row scored")

    def show(name: str, score: dict, seconds: float) -> None:
        log(f"  validation on the {name}: {seconds:.1f} s, {score['num_images']} images; "
            + ", ".join(f"{k} {score[k]:.8f}" for k in EVAL_TOL))

    def gate() -> None:
        scores = {}
        with tf32_off():
            for name, folder, run_cfg in (
                    ("card", "", cfg),
                    (controls[0], "", _with(cfg, renderer=dict(field_dtype="bfloat16")).validate()),
                    (controls[1], "padded", cfg)):
                t0 = time.perf_counter()
                scores[name] = eval_validation(run_cfg, device, folders[folder],
                                               os.path.join(root, f"cmp_{len(scores)}"))
                show(name, scores[name], time.perf_counter() - t0)
        t0 = time.perf_counter()
        scores["CPU"] = refs.result(job)
        show("CPU", scores["CPU"], time.perf_counter() - t0)
        for name in ("card", *controls):
            gaps = {k: abs(scores[name][k] - scores["CPU"][k]) for k in EVAL_TOL}
            inside = all(gaps[k] <= EVAL_TOL[k] for k in EVAL_TOL)
            log(f"  {name} vs CPU: " + ", ".join(f"{k} {gaps[k]:.3e} [tol {EVAL_TOL[k]:g}]" for k in EVAL_TOL)
                + f": {'inside' if inside else 'outside'} the tolerance")
            if name == "card" and not inside:
                raise AssertionError("validation's scores disagree between the card and the CPU")
            if name != "card" and inside:
                raise AssertionError(f"the control ({name}) passes the card-vs-CPU gate")

    return gate


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
    host = defaultdict(list)
    launches = {}
    with patched(mesh, extract_mesh=host_timed(host, "extract_mesh"), rasterize=host_timed(host, "rasterize")):
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
            marching, raster = host_ms(host, "extract_mesh"), host_ms(host, "rasterize")
            native = marching + raster
            log(f"  {path}: {r['wall_ms']:.2f} ms wall under the profiler, {r['wall_ms'] / n_frames:.2f} ms per frame; "
                f"device busy {r['busy_ms']:.3f} ms (field kernel {r['field_ms']:.3f} ms); host mesh work "
                f"{native:.2f} ms (marching + welding {marching:.2f}, rasterizer {raster:.2f}), "
                f"{native / r['wall_ms']:.3f} of the wall against the device's {r['busy_ms'] / r['wall_ms']:.3f}; "
                f"peak memory {r['peak_gib']:.2f} GiB")
    del model, runner
    torch.cuda.empty_cache()
    return launches


# Phase 10: the trainer CLI (python -m e3dge_torch.training.train) with its
# services at stage2_config's full width, its --resume, and the NoW 3D eval
# (python -m e3dge_torch.eval --mode now) at demo_view_synthesis_config's
TR_ITERS, TR_DATA_IMAGES, TR_VAL_IMAGES = 4, 8, 5
# train_stage2.2.sh's switches, at phase 8's recipe (the D's lambda defaults
# to --adv-lambda, 0.01)
TR_FLAGS = ["--stage", "2.2", "--batch", str(ST2_BATCH), "--lr", str(ST2_LR), "--fix-ada", "--ema",
            "--pose-curriculum", "--adv-lambda", "0.01", "--r1", "60", "--d-reg-every", str(ST2_D_REG_EVERY),
            "--log-every", "1"]
# the resume gate: the spread of two uninterrupted runs on the card (grid
# sampling's backward accumulates by atomics, cuDNN's algorithms are not
# fixed) times RESUME_FACTOR, at least RESUME_FLOOR (relative)
RESUME_FACTOR, RESUME_FLOOR = 10.0, 1e-5
# runs of one recipe on one rank that give the card's spread (10b, and the
# rank reference of 11b and 12)
SPREAD_RUNS = 3
# phases 11b and 12 hold their rank runs to one-rank runs of phase 10b's
# recipe at this depth: each iteration lets Adam's steps on the volume D's
# near-zero gradients carry a rank run's other order of sums further from
# one rank (rank_spread.py measures it at any depth)
RANK_REF_ITERS = 2
NOW_SUBJECTS, NOW_IMAGES, NOW_SCAN_POINTS, NOW_BATCH = 2, 2, 62_500, 2
# field launches per NoW batch: the ref render (raw_h kept) and the SDF grid
NOW_LAUNCHES_PER_BATCH = {"siren_field_full": 2, "siren_field_tex": 0}
# now_scan_error on the first mesh and its scan, card against CPU: mean and
# median within NOW_TOL scan units (ICP's nearest-vertex argmin may break a
# tie differently); the control, the aligned mesh moved by 1 scan unit toward
# the scan's landmarks, falls outside
NOW_TOL = 1e-2


def dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs) / 2**20


def run_trainer(device, root: str, st2_ms: float) -> dict:
    """Phase 10a: `train.main` at stage2_config (phase 8's model and recipe),
    B=4, TR_ITERS iterations with --data (8 seeded 256^2 PNGs), --val-data (5),
    --saveimg-every 2, --val-every 4, --ckpt-every 2 and partial perceptual
    checkpoints, under the CUDA-only profiler. Checks: models_latest, its
    _old rotation and models_final, metrics.jsonl with one record per
    iteration, the panels and the scores entry; each iteration's field
    launches (phase 8's D 4 + 1 and E 5 + 0); the D's reals are the
    folder's batches. Reports ms per iteration beside phase 8's, a --data
    batch load, each checkpoint save (ms) and the checkpoints' MB, the
    validation call and a panel (ms, launches), the run's device busy share
    and peak memory. Returns the measured launches of the first iteration,
    the validation call and a panel."""
    from torch.profiler import ProfilerActivity, profile

    from e3dge_torch.config import stage2_config
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.runner import Runner
    from e3dge_torch.training import data, steps, train
    from e3dge_torch.utils import logger

    d_res = min(stage2_config().decoder.size, 256)
    reals = write_folder(os.path.join(root, "reals"), smooth_images(TR_DATA_IMAGES, 256, SEED + 7))
    val = write_folder(os.path.join(root, "val"), smooth_images(TR_VAL_IMAGES, 256, SEED + 8))
    batches = data.ImageFolderDataset(reals, size=d_res, thumb_size=min(64, d_res),
                                      rng=np.random.RandomState(SEED)).iter_batches(ST2_BATCH, SEED)
    expected, load_ms = [], []
    for _ in range(TR_ITERS):
        t0 = time.perf_counter()
        expected.append(next(batches)["image"])
        load_ms.append((time.perf_counter() - t0) * 1e3)
    work = os.path.join(root, "trainer")
    rec = defaultdict(list)
    start = [0.0]

    def split_now():
        torch.cuda.synchronize()
        return dict(sf.precision_launch_counts)

    def d_batch(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            sf.reset_launch_counts()
            start[0] = time.perf_counter()
            return fn(*args, **kwargs)
        return call

    def d_step(fn):
        def make(*args, **kwargs):
            step = fn(*args, **kwargs)

            def call(reals, fakes):
                rec["reals"].append(reals.detach().cpu().numpy())
                return step(reals, fakes)
            return call
        return make

    def log_hook(fn):
        def call(self, step, metrics):
            rec["iter"].append(((time.perf_counter() - start[0]) * 1e3, split_now()))
            return fn(self, step, metrics)
        return call

    argv = [*TR_FLAGS, "--iters", str(TR_ITERS), "--data", reals, "--val-data", val, "--saveimg-every", "2",
            "--val-every", "4", "--ckpt-every", "2", "--work-dir", work, *perceptual_files(root)]
    log(f"  [10a] python -m e3dge_torch.training.train {' '.join(argv[:-4])} (+ partial perceptual .pth files)")
    torch.cuda.reset_peak_memory_stats()
    with patched(steps, full_d_batch=d_batch, make_full_d_step=d_step), \
            patched(logger.MetricLogger, log=log_hook), \
            patched(Runner, save_checkpoint=host_timed(rec, "save"), validation=host_timed(rec, "val")), \
            patched(train, save_train_panel=host_timed(rec, "panel")), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = train.main(argv)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak = peak_gib()
    if rc != 0:
        raise AssertionError(f"the trainer exited {rc}")
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)) / 1e3
    if busy <= 0:
        raise AssertionError("the profiler saw no device time in the trainer")

    want = {("siren_field_full", "highest"): ST2_D_LAUNCHES["siren_field_full"] + ST2_E_LAUNCHES["siren_field_full"],
            ("siren_field_tex", "highest"): ST2_D_LAUNCHES["siren_field_tex"] + ST2_E_LAUNCHES["siren_field_tex"]}
    for i, (ms, split) in enumerate(rec["iter"]):
        got = {k: v for k, v in split.items() if v}
        log(f"  iteration {i}: {ms:.2f} ms (D producer to the E step's log), launches {split_text(split)}")
        if got != want:
            raise AssertionError(f"trainer iteration {i} launched {got}, expected phase 8's {want}")
    if len(rec["reals"]) != TR_ITERS or any(not np.array_equal(g, w) for g, w in zip(rec["reals"], expected)):
        raise AssertionError("the D's reals are not the --data folder's batches")
    log(f"  the D's reals: the --data folder's {TR_ITERS} batches of {ST2_BATCH}, equal")
    files = {
        "models_latest": os.path.isfile(os.path.join(work, "models_latest", "d_state.pt")),
        "models_latest_old": os.path.isfile(os.path.join(work, "models_latest_old", "state.pt")),
        "models_final": os.path.isfile(os.path.join(work, "models_final", "variables.pt")),
        "metrics.jsonl": sum(1 for _ in open(os.path.join(work, "metrics.jsonl"))) == TR_ITERS,
        "2 panels": sorted(os.listdir(os.path.join(work, "train", "images"))) == ["iter_0000002.png",
                                                                                 "iter_0000004.png"],
        "scores.json": len(json.load(open(os.path.join(work, "scores.json")))) == 1,
    }
    log(f"  artifacts: {files}")
    if not all(files.values()):
        raise AssertionError(f"trainer artifacts missing: {files}")
    scores = json.load(open(os.path.join(work, "scores.json")))[0]
    check_scores(scores, TR_VAL_IMAGES, "in-training validation")
    iter_ms = [ms for ms, _ in rec["iter"]]
    log(f"  ms per iteration (host clock, D producer to the log, under the CUDA-only profiler): median "
        f"{np.median(iter_ms):.2f}, min {min(iter_ms):.2f}, max {max(iter_ms):.2f}; phase 8's median "
        f"{st2_ms:.2f} (CUDA events, no profiler)")
    log(f"  --data batch load (Pillow, 4 x 256^2 PNG + flips + thumbs): median {np.median(load_ms):.2f} ms, "
        f"max {max(load_ms):.2f} ms")
    sizes = ", ".join(f"{d} {dir_mb(os.path.join(work, d)):.1f} MB"
                      for d in ("models_latest_old", "models_latest", "models_final"))
    log(f"  checkpoint saves: {', '.join(f'{ms:.2f}' for ms, _ in rec['save'])} ms; the directories: {sizes}")
    for key, what in (("val", "validation call (5 images, B=4)"), ("panel", "panel")):
        for ms, launches in rec[key]:
            log(f"  {what}: {ms:.2f} ms, launches {split_text(launches)}")
    log(f"  the trainer's call: {wall:.2f} ms wall (model build, seeding and mean latents included), device busy "
        f"{busy:.3f} ms, busy share {busy / wall:.3f}; peak memory {peak:.2f} GiB")
    shutil.rmtree(work)
    return {"iteration": {k: v for k, v in rec["iter"][0][1].items() if v}, "validation": rec["val"][0][1],
            "panel": rec["panel"][0][1]}


def _moments(opt: dict) -> list[torch.Tensor]:
    return [t for s in opt["state"].values() for k, t in s.items() if torch.is_tensor(t)]


def _st1_groups(work: str) -> dict[str, list[torch.Tensor]]:
    """A stage-1 run's models_final tensors by group: E0's parameters, its BN
    statistics, the optimizer's moments."""
    ck = os.path.join(work, "models_final")
    var = torch.load(os.path.join(ck, "variables.pt"), map_location="cpu", weights_only=True)
    st = torch.load(os.path.join(ck, "state.pt"), map_location="cpu", weights_only=True)
    return {"E0": [v for k, v in var.items() if k.startswith("encoder.") and "running_" not in k],
            "BN statistics": [v for k, v in var.items() if "running_" in k],
            "E optimizer": _moments(st["optimizer"])}


def _groups(work: str) -> dict[str, list[torch.Tensor]]:
    """A run's models_final tensors by group: the trained modules, the BN
    statistics, the E optimizer's moments, the EMA, the full-res D, its
    optimizer, the volume D and its optimizer."""
    ck = os.path.join(work, "models_final")
    load = lambda f: torch.load(os.path.join(ck, f), map_location="cpu", weights_only=True)  # noqa: E731
    var, st, ds = load("variables.pt"), load("state.pt"), load("d_state.pt")
    moments = _moments
    return {
        "local+fuse_sft_block": [v for k, v in var.items() if k.split(".")[0] in ("local", "fuse_sft_block")],
        "BN statistics": [v for k, v in var.items() if "running_" in k],
        "volume D": [v for k, v in var.items() if k.startswith("volume_discriminator.")],
        "E optimizer": moments(st["optimizer"]),
        "EMA": list(st["ema"].values()),
        "full-res D": list(ds["full"]["d"].values()),
        "full-res D optimizer": moments(ds["full"]["optimizer"]),
        "volume D optimizer": moments(ds["volume"]["optimizer"]),
    }


# a run's final-state groups, kept for the few runs a phase compares most
# (each loads ~1 GB of checkpoints): keyed by the groups function, the work
# directory and its checkpoint's modification time
_GROUPS_CACHE: OrderedDict = OrderedDict()
GROUPS_CACHE_SIZE = 6


def cached_groups(groups, work: str) -> dict:
    """groups(work), read once while the run's checkpoint is unchanged."""
    ck = os.path.join(work, "models_final", "variables.pt")
    key = (groups, work, os.stat(ck).st_mtime_ns if os.path.exists(ck) else None)
    if key not in _GROUPS_CACHE:
        _GROUPS_CACHE[key] = groups(work)
        while len(_GROUPS_CACHE) > GROUPS_CACHE_SIZE:
            _GROUPS_CACHE.popitem(last=False)
    _GROUPS_CACHE.move_to_end(key)
    return _GROUPS_CACHE[key]


def run_gap(a: str, b: str, first_step: int, groups=_groups, skip=()) -> tuple[float, float, str]:
    """(the largest relative gap of a logged metric from first_step on, the
    largest relative L2 gap of a final-state group, that group and that
    metric) of run a against run b; the metrics in `skip` are not read. A
    metric's gap is relative to its largest magnitude over run b's logged
    steps: the D scores cross zero, where a gap relative to the value itself
    reads its rounding."""
    recs = [{r["step"]: r for r in map(json.loads, open(os.path.join(w, "metrics.jsonl")))} for w in (a, b)]
    scale = {}
    for r in recs[1].values():
        for k, v in r.items():
            if k not in ("step", "time", *skip):
                scale[k] = max(scale.get(k, 1e-6), abs(v))
    loss, metric = max((abs(recs[0][s][k] - v) / scale[k], f"{k}@{s}") for s, r in recs[1].items()
                       if s >= first_step for k, v in r.items() if k in scale)
    ga, gb = cached_groups(groups, a), cached_groups(groups, b)
    gaps = {}
    for name, want in gb.items():
        x = torch.cat([t.double().flatten() for t in ga[name]])
        y = torch.cat([t.double().flatten() for t in want])
        gaps[name] = float((x - y).norm() / y.norm().clamp_min(1e-30))
    worst = max(gaps, key=gaps.get)
    return loss, gaps[worst], f"{worst}; metric {metric}"


def spread_limits(works: list[str], what: str, skip=(), groups=_groups) -> tuple[float, float]:
    """RESUME_FACTOR x the card's spread, at least RESUME_FLOOR: (metrics,
    final state), the spread being the largest `run_gap` among the pairs of
    `works`, runs of one recipe on one rank (one pair's gap is a single draw
    of the card's nondeterminism, and can fall far below the others)."""
    pairs = [run_gap(b, a, 1, groups, skip) for a, b in itertools.combinations(works, 2)]
    spread_loss, spread_state = (max(p[i] for p in pairs) for i in (0, 1))
    lim_loss, lim_state = (max(RESUME_FACTOR * x, RESUME_FLOOR) for x in (spread_loss, spread_state))
    log(f"  spread of {len(works)} {what}: metrics {spread_loss:.3e}, final state {spread_state:.3e} (pairs: "
        + "; ".join(f"{p[0]:.3e} / {p[1]:.3e} ({p[2]})" for p in pairs)
        + f"); limits {lim_loss:.3e} and {lim_state:.3e}")
    return lim_loss, lim_state


def rank_limits(works: list[str], what: str, groups=None) -> tuple[float, float]:
    """The limits of a gate that holds a run on several ranks or cards to one
    rank's (phases 11a, 11b, 12, `dp_scaling.py`, `sp_scaling.py`):
    `spread_limits` over `works`, at least SPREAD_RUNS one-rank runs of one
    recipe, the metrics that do not average over ranks not read. Fewer runs
    raise: one pair's gap is a single draw of the card's spread."""
    if len(works) < SPREAD_RUNS:
        raise ValueError(f"{what}: {len(works)} runs, the spread needs {SPREAD_RUNS}")
    return spread_limits(works, what, DP_NONLINEAR_METRICS, groups or _groups)


def st1_rank_limits(works: list[str]) -> tuple[float, float]:
    """Phase 11a's limits (metrics, final state) from its one-rank stage-1
    runs (`rank_limits` over E0, its BN statistics and Adam's moments)."""
    return rank_limits(works, f"11a one-rank runs ({DP_ST1_ITERS} iterations)", _st1_groups)


def run_resume(device, root: str) -> dict:
    """Phase 10b: `train.main` at phase 10a's configuration and switches
    plus --train-volume-d (both D states through the checkpoint), no
    --data: RANK_REF_ITERS iterations SPREAD_RUNS times (the card's spread,
    `spread_limits`), then half of them with --ckpt-every, then --resume to
    RANK_REF_ITERS, each in this process. The resumed run's logged
    metrics after the resume and its final state (trained modules, BN
    statistics, E optimizer moments, EMA, both Ds and their optimizers)
    against the first uninterrupted run, within RESUME_FACTOR x the spread
    (at least RESUME_FLOOR); a control resume that drops the E optimizer's
    state must fall outside. The uninterrupted runs are the one-rank
    reference of phases 11b and 12 (their flags, `rank_limits`): returns
    `one_rank_reference` of them, as `rank_reference` returns its own."""
    from e3dge_torch.training import steps, train

    argv = [*TR_FLAGS, "--train-volume-d", "--saveimg-every", "0", *perceptual_files(root)]
    half = RANK_REF_ITERS // 2
    runs = {}

    def run(name, *extra):
        t0 = time.perf_counter()
        work = os.path.join(root, "resume", name)
        if train.main([*argv, *extra, "--work-dir", work]) != 0:
            raise AssertionError(f"trainer run {name} failed")
        log(f"  [10b] run {name} ({' '.join(extra)}): {time.perf_counter() - t0:.1f} s")
        runs[name] = work
        return work

    wholes = [run(f"whole_{i}", "--iters", str(RANK_REF_ITERS)) for i in range(SPREAD_RUNS)]
    part = run("part", "--iters", str(half), "--ckpt-every", str(half))
    shutil.rmtree(os.path.join(part, "models_final"))  # the same state as models_latest
    latest = os.path.join(part, "models_latest")
    run("part", "--iters", str(RANK_REF_ITERS), "--resume", latest)

    def no_optimizer(fn):
        def load(self, sd):
            fn(self, {**sd, "optimizer": self.optimizer.state_dict()})
        return load

    with patched(steps.TrainState, load_state_dict=no_optimizer):
        run("control", "--iters", str(RANK_REF_ITERS), "--resume", latest)
    lim_loss, lim_state = spread_limits(wholes, "uninterrupted runs")
    for name in ("part", "control"):
        loss, state, where = run_gap(runs[name], wholes[0], half + 1)
        inside = loss <= lim_loss and state <= lim_state
        log(f"  {'resumed' if name == 'part' else 'control (E optimizer state dropped)'} vs uninterrupted: metrics "
            f"after the resume {loss:.3e} [limit {lim_loss:.3e}], final state {state:.3e} ({where}) "
            f"[limit {lim_state:.3e}]: {'inside' if inside else 'outside'}")
        if name == "part" and not inside:
            raise AssertionError("the resumed run drifts from the uninterrupted one")
        if name == "control" and state <= lim_state:
            raise AssertionError("the control resume without the optimizer state passes the resume gate")
    ref = one_rank_reference(wholes, argv)
    for work in set(runs.values()) - {wholes[0]}:
        shutil.rmtree(work)
    torch.cuda.empty_cache()  # the rank runs after it share the card with this process
    return ref


def one_rank_reference(works: list[str], argv: list[str]) -> dict:
    """The one-rank reference of phases 11b and 12 from SPREAD_RUNS runs of
    argv at RANK_REF_ITERS iterations (phase 10b's uninterrupted runs, or
    `rank_reference`'s): the first run's work directory, the flags and
    `rank_limits` over all the runs (psnr not read, as the rank gates do
    not read it)."""
    lim_loss, lim_state = rank_limits(works, f"one-rank runs ({RANK_REF_ITERS} iterations)")
    return {"work": works[0], "argv": [*argv, "--iters", str(RANK_REF_ITERS)], "lim_loss": lim_loss,
            "lim_state": lim_state}


def rank_reference(root: str) -> dict:
    """The one-rank reference of phases 11b and 12 when they run without
    phase 10 (`--phase 11`, `--phase 12`; the whole script takes phase 10b's
    uninterrupted runs, `run_resume`): phase 10b's flags at RANK_REF_ITERS
    iterations, run SPREAD_RUNS times in this process (the card's spread),
    as `one_rank_reference`."""
    from e3dge_torch.training import train

    argv = [*TR_FLAGS, "--train-volume-d", "--saveimg-every", "0", *perceptual_files(root)]
    works = [os.path.join(root, "dp", f"one_rank_{i}") for i in range(SPREAD_RUNS)]
    for work in works:
        t0 = time.perf_counter()
        if train.main([*argv, "--iters", str(RANK_REF_ITERS), "--work-dir", work]) != 0:
            raise AssertionError(f"the one-rank reference run {work} failed")
        log(f"  one rank, {os.path.basename(work)}: {time.perf_counter() - t0:.1f} s (in this process)")
    ref = one_rank_reference(works, argv)
    for work in works[1:]:
        shutil.rmtree(work)
    torch.cuda.empty_cache()  # the rank runs after it share the card with this process
    return ref


def write_now_layout(root: str) -> str:
    """A seeded NoW layout: NOW_SUBJECTS subjects x NOW_IMAGES JPEGs of
    1024x768 (smooth seeded images) with their face boxes, and per subject a
    scan .obj of NOW_SCAN_POINTS points on a head-sized ellipsoid (semi-axes
    150, 190, 120 units; above evaluate3d's 40,000 points, so its strided
    subsample runs) and a .pp of its 7 front-most points."""
    from PIL import Image

    rng = np.random.RandomState(SEED + 9)
    fr = os.path.join(root, "final_release_version")
    lines = []
    for s in range(NOW_SUBJECTS):
        subj = f"FaMoS_{s:03d}"
        for d in ("iphone_pictures", "detected_face"):
            os.makedirs(os.path.join(fr, d, subj), exist_ok=True)
        for i in range(NOW_IMAGES):
            rel = f"{subj}/IMG_{i:04d}.jpg"
            img = smooth_images(1, 1024, SEED + 10 + 2 * s + i)[0][:768]
            Image.fromarray(img).save(os.path.join(fr, "iphone_pictures", rel), quality=95)
            left, top = 300 + 40 * rng.rand(), 150 + 40 * rng.rand()
            np.save(os.path.join(fr, "detected_face", rel.replace(".jpg", ".npy")),
                    {"left": left, "right": left + 400, "top": top, "bottom": top + 420})
            lines.append(rel)
        pts = rng.randn(NOW_SCAN_POINTS, 3)
        pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * np.array([150.0, 190.0, 120.0])
        for d in ("scans", "scans_lmks_onlypp"):
            os.makedirs(os.path.join(root, d, subj), exist_ok=True)
        with open(os.path.join(root, "scans", subj, "natural_head_rotation.000001.obj"), "w") as f:
            f.write("".join(f"v {x:.4f} {y:.4f} {z:.4f}\n" for x, y, z in pts))
        front = pts[np.argsort(-pts[:, 2])[:7]]
        with open(os.path.join(root, "scans_lmks_onlypp", subj, "natural_head_rotation.000001_picked_points.pp"),
                  "w") as f:
            f.write("<!DOCTYPE PickedPoints>\n<PickedPoints>\n" + "".join(
                f' <point x="{x:.4f}" y="{y:.4f}" z="{z:.4f}" active="1" name="{i}"/>\n'
                for i, (x, y, z) in enumerate(front)) + "</PickedPoints>\n")
    with open(os.path.join(root, "imagepathsvalidation.txt"), "w") as f:
        f.write("\n".join(lines))
    return root


def now_kernel_check(device) -> dict:
    """The field kernel at the NoW batch's SDF grid (B=2, zero dirs) against
    its plain version, timed beside its bound; the batch's ref render (B=2
    with raw_h) is phase 9's validation render."""
    return {"NoW SDF grid": {"entry": "siren_field_full", "precision": "highest", "batch": NOW_BATCH, "n": N_FULL,
                             "sdf_only": True, **check_and_time_full("NoW SDF grid, zero dirs", NOW_BATCH, N_FULL,
                                                                     False, "highest", device, sdf_only=True)}}


def run_now(device, root: str) -> dict:
    """Phase 10c: `eval.main --mode now` at demo_view_synthesis_config, f32,
    batch 2, on `write_now_layout`: the field launches per batch asserted,
    a mesh per image, finite mean / median / std, ms per image split into
    inversion + mesh, ICP and scan-to-mesh; then `now_scan_error` on the
    first mesh and its subsampled scan, card against CPU within NOW_TOL,
    with the control outside, the CPU's run (`now_scan_error_run`) in a
    `CpuReferences` child. Returns the measured launches per batch by
    (entry, precision) and the card-vs-CPU gate, a function that waits for
    the CPU's run and compares (main runs 10c first and this gate after 10a
    and 10b, beside whose card work the reference runs)."""
    from e3dge_torch import eval as teval
    from e3dge_torch.training import eval3d
    from e3dge_torch.utils.mesh import load_obj, load_obj_vertices

    data = write_now_layout(os.path.join(root, "now"))
    out = os.path.join(root, "now_out")
    host = defaultdict(list)
    record = []
    n_images = NOW_SUBJECTS * NOW_IMAGES
    argv = ["--data", data, "--mode", "now", "--batch", str(NOW_BATCH), "--out", out]
    log(f"  [10c] python -m e3dge_torch.eval {' '.join(argv)}")
    with patched(eval3d, icp_align=host_timed(host, "icp"), scan_to_mesh_distance=host_timed(host, "scan_to_mesh")), \
            probed(("evaluate3d",), record):
        rc, counts, split = counted_split(lambda: teval.main(argv))
    if rc != 0:
        raise AssertionError(f"eval --mode now exited {rc}")
    batches = -(-n_images // NOW_BATCH)
    want = {(k, "highest"): v * batches for k, v in NOW_LAUNCHES_PER_BATCH.items()}
    log(f"  launch counts over the call: {counts}; by precision: {split_text(split)}")
    if {k: v for k, v in split.items() if v} != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"eval now launched {split}, expected {want}")
    meshes = os.path.join(out, "now_meshes")
    scores = json.load(open(os.path.join(meshes, "now_scores.json")))
    objs = sorted(os.path.join(d, f) for d, _, fs in os.walk(meshes) for f in fs if f.endswith(".obj"))
    n_verts = [len(load_obj(p)[0]) for p in objs]
    log(f"  {len(objs)} meshes ({n_verts} vertices); scores {scores}")
    if len(objs) != n_images or scores["num_scored"] != n_images or \
            not all(math.isfinite(scores[k]) for k in ("mean", "median", "std")):
        raise AssertionError(f"eval now: {len(objs)} meshes, scores {scores}")
    (r,) = record
    icp, s2m = host_ms(host, "icp"), host_ms(host, "scan_to_mesh")
    rest = r["wall_ms"] - icp - s2m
    log(f"  evaluate3d: {r['wall_ms']:.2f} ms wall under the profiler for {n_images} images, "
        f"{r['wall_ms'] / n_images:.2f} ms per image: inversion + mesh + I/O {rest / n_images:.2f}, ICP "
        f"{icp / n_images:.2f}, scan-to-mesh {s2m / n_images:.2f}; device busy "
        f"{r['busy_ms']:.3f} ms (field kernel {r['field_ms']:.3f} ms), busy share {r['busy_ms'] / r['wall_ms']:.3f}; "
        f"peak memory {r['peak_gib']:.2f} GiB")

    subj = os.path.basename(os.path.dirname(objs[0]))
    verts, faces = load_obj(objs[0])
    scan = load_obj_vertices(os.path.join(data, "scans", subj, "natural_head_rotation.000001.obj"))
    scan = scan[:: len(scan) // 40000 + 1]
    lms = eval3d.parse_picked_points(os.path.join(data, "scans_lmks_onlypp", subj,
                                                  "natural_head_rotation.000001_picked_points.pp"))

    toward = lms.mean(0) - scan.mean(0)  # toward the cropped face region

    def moved(fn):
        def call(*args, **kwargs):
            s_, r_, t_ = fn(*args, **kwargs)
            return s_, r_, t_ + toward / np.linalg.norm(toward)
        return call

    refs = CpuReferences("10c")
    job = refs.add("now_scan_error_run", verts, faces, scan, lms, "cpu")
    refs.start()
    results = {}
    for name, shift in (("card", False), ("card, mesh moved 1 unit", True)):
        with patched(eval3d, icp_align=moved) if shift else contextlib.nullcontext():
            results[name] = now_scan_error_run(verts, faces, scan, lms, device, name)

    def gate() -> None:
        results["CPU"] = refs.result(job)
        for name in ("card", "card, mesh moved 1 unit"):
            gaps = [abs(a - b) for a, b in zip(results[name], results["CPU"])]
            inside = max(gaps) <= NOW_TOL
            log(f"  {name} vs CPU: mean {gaps[0]:.3e}, median {gaps[1]:.3e} scan units [tol {NOW_TOL:g}]: "
                f"{'inside' if inside else 'outside'}")
            if (name == "card") != inside:
                raise AssertionError(f"now_scan_error card-vs-CPU gate: {name} "
                                     f"{'outside' if name == 'card' else 'inside'}")

    return {k: v // batches for k, v in split.items()}, gate


def now_scan_error_run(verts, faces, scan, lms, dev, name: str = "CPU") -> tuple[float, float]:
    """10c's `now_scan_error` of a mesh and its scan on dev: (mean, median)
    over the scan points. On the CPU, a job of the child of `CpuReferences`."""
    from e3dge_torch.training import eval3d

    t0 = time.perf_counter()
    d = eval3d.now_scan_error(verts, faces, scan, scan_lms=lms, device=dev)
    out = (float(d.mean()), float(np.median(d)))
    log(f"  now_scan_error on the {name}: mean {out[0]:.6f}, median {out[1]:.6f} over {len(d)} scan points, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return out


# Phase 11: data parallelism across ranks (e3dge_torch.parallel) on the one
# card: each multi-rank run is a process group of this script's --rank-child
# under torchrun, with its own time limit
DP_RANKS, DP_ST1_ITERS, DP_TIMEOUT = 2, 2, 420
# the stage-1 trainer run of 11a and 11d (stage1_config, B=4, phase 7's Adam
# and lambdas through train.main)
DP_ST1_FLAGS = ["--stage", "1", "--batch", str(ST1_BATCH), "--lr", str(ST1_LR), "--log-every", "1",
                "--saveimg-every", "0"]
# 11c: the flagship's bf16 image2image at B=2 across 2 ranks (B=1 each)
# against one rank inverting the same rows at B=1 within phase 5's
# card-vs-CPU limit, and against one rank's B=2 call within phase 5's bf16
# limit (mean |a - b| / max |b|): bf16 convolutions at B=2 and at B=1 round
# differently (0.148 max abs on an H100 at the flagship's 1024^2 output)
DP_SERVE_BATCH, TOL_DP_SERVING = 2, TOL_CARD_VS_CPU
# logged metrics that are not means over the batch: across ranks they are
# the mean of the ranks' values (the reference's reduce_loss_dict), not the
# global batch's
DP_NONLINEAR_METRICS = ("psnr",)


def dp_kernel_cases() -> tuple:
    """The `highest` launch shapes the per-rank batch (B / DP_RANKS) gives the
    trainer: (label, B, N, SDF-only). The stage-2 sample renders, the stage-1
    sample render and the SDF targets; the query render, the texture pass
    and the ref render at B=2 are phase 9's shapes."""
    from e3dge_torch.config import stage1_config, stage2_config

    b = ST1_BATCH // DP_RANKS
    c1, c2 = stage1_config().renderer, stage2_config().renderer
    return (("per-rank stage-2 sample render", b, c2.out_im_res ** 2 * c2.n_samples, False),
            ("per-rank stage-1 sample render", b, c1.out_im_res ** 2 * c1.n_samples, False),
            ("per-rank near-surface SDF targets", b, c1.out_im_res ** 2, True),
            ("per-rank uniform SDF targets", b, c1.uniform_grid_sampling_num, True))


def dp_kernel_check(device) -> dict:
    """`siren_field_full` in `highest` at `dp_kernel_cases()` against its
    plain version, timed beside the bound; {label: figures}."""
    out = {}
    for label, batch, n, sdf_only in dp_kernel_cases():
        r = check_and_time_full(label, batch, n, False, "highest", device, sdf_only=sdf_only)
        out[label] = {"entry": "siren_field_full", "precision": "highest", "batch": batch, "n": n,
                      "sdf_only": sdf_only, **r}
    return out


def dp_serving_inputs(device):
    """11c's model and inputs: the flagship on phase 4's seeded weights, 2
    seeded 256^2 images, phase 4's seeded mean latents, seeded noise for 2."""
    from e3dge_torch.config import flagship_config
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.utils.weights import init_weights

    cfg = flagship_config()
    model = E3DGE(cfg, device=device)
    init_weights(model, SEED)
    images = torch.from_numpy(np.random.RandomState(SEED + 11).uniform(-1, 1, (DP_SERVE_BATCH, 3, 256, 256))
                              .astype(np.float32))
    _, ml, noise = to_device(images, seeded_inputs(cfg, SEED)[1], decoder_noise(cfg, DP_SERVE_BATCH, SEED), device)
    return model, images.to(device), ml, noise


def wrap_collectives(mesh, counts: dict) -> None:
    """mesh's gradient all-reduce, metric reduction and broadcast wrapped:
    each call counted, and each tensor it changed (at world 1 they must be
    exact identities) counted in counts["changed"]."""
    grads, metrics, bcast = mesh.all_reduce_grads, mesh.reduce_metrics, mesh.broadcast_

    def check(before, after):
        counts["calls"] += 1
        counts["changed"] += sum(not torch.equal(a, b) for a, b in zip(before, after))

    def all_reduce_grads(params, world):
        params = list(params)
        before = [p.grad.clone() for p in params if p.grad is not None]
        grads(params, world)
        check(before, [p.grad for p in params if p.grad is not None])

    def reduce_metrics(m, world):
        out = metrics(m, world)
        check([torch.as_tensor(v, dtype=torch.float32).cpu() for v in m.values()],
              [torch.as_tensor(v, dtype=torch.float32).cpu() for v in out.values()])
        return out

    def broadcast_(tensors, world):
        tensors = list(tensors)
        before = [t.detach().clone() for t in tensors]
        bcast(tensors, world)
        check(before, tensors)

    mesh.all_reduce_grads, mesh.reduce_metrics, mesh.broadcast_ = all_reduce_grads, reduce_metrics, broadcast_


def profile_window(spec: dict, rank: int, report: dict) -> None:
    """With SPEC's "profile_from" (an iteration), rank 0 of a trainer run
    profiles the card (torch.profiler, CUDA activity) from the first draw of
    that iteration to the final save and adds to `report` the window's host
    ms, device busy ms, NCCL kernel ms and field kernel ms per iteration
    ("window")."""
    from torch.profiler import ProfilerActivity, profile

    from e3dge_torch.runner import Runner
    from e3dge_torch.training import train

    first = spec.get("profile_from")
    if first is None or rank != 0:
        return
    iters = int(spec["argv"][spec["argv"].index("--iters") + 1]) - first
    prof = profile(activities=[ProfilerActivity.CUDA])
    window = {}
    stream, save = train.stream_generator, Runner.save_checkpoint

    def generator(device, *keys):
        if keys[1:] == (first, train.D_STREAM) and not window:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        return stream(device, *keys)

    def final_save(self, *args, **kwargs):
        if window and "ms" not in window:
            torch.cuda.synchronize()
            window["ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()
            kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(ev, "is_user_annotation", False) and "memcpy" not in ev.name.lower()
                       and "memset" not in ev.name.lower()]
            busy = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3
            nccl = sum(ev.time_range.elapsed_us() for ev in kernels if "nccl" in ev.name.lower()) / 1e3
            field = sum(ev.time_range.elapsed_us() for ev in kernels if "siren_field" in ev.name) / 1e3
            report["window"] = {"ms_per_iter": window["ms"] / iters, "busy_ms_per_iter": busy / iters,
                                "nccl_ms_per_iter": nccl / iters, "field_ms_per_iter": field / iters,
                                "kernels": len(kernels)}
        return save(self, *args, **kwargs)

    train.stream_generator, Runner.save_checkpoint = generator, final_save


def rank_child(spec_path: str) -> int:
    """One rank of a multi-rank run of phase 11 or dp_scaling.py (`python -m
    torch.distributed.run ... chip_smoke.py --rank-child SPEC`, or alone for
    a world of one): SPEC's control applied (BN sync, gradient averaging or
    the sp gradient sum off), the field launch counts set to 0, `train.main(argv)` (profiled
    with SPEC's "profile_from", `profile_window`) or the data-parallel
    serving call run, and the rank's launches, seconds and (serving) images
    written to SPEC's out directory."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.parallel import mesh
    from e3dge_torch.runner import Runner
    from e3dge_torch.training import train

    spec = json.load(open(spec_path))
    rank = int(os.environ.get("RANK", "0"))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.benchmark = False
    if spec.get("control") == "bn_sync_off":
        mesh.mean_over_ranks = lambda x: x
    elif spec.get("control") == "grad_average_off":
        mesh.all_reduce_grads = lambda params, world: None
    elif spec.get("control") == "sp_grad_sum_off":
        mesh.gather_rays = sp_gather_without_grad_sum(mesh)
    report = {"rank": rank}
    init = mesh.init_distributed

    def recorded_init(*args, **kwargs):
        world = init(*args, **kwargs)
        report.update(world_size=world.size, backend=torch.distributed.get_backend() if world.group else None)
        return world

    mesh.init_distributed = recorded_init
    if spec.get("check_collectives"):
        wrap_collectives(mesh, report.setdefault("collectives", {"calls": 0, "changed": 0}))
    if spec["kind"] == "train":
        profile_window(spec, rank, report)
        torch.cuda.synchronize()
        sf.reset_launch_counts()
        t0 = time.perf_counter()
        rc = train.main(spec["argv"])
        torch.cuda.synchronize()
    else:
        world = mesh.init_distributed(spec["backend"])
        try:
            model, images, ml, noise = dp_serving_inputs(world.device)
            runner = Runner(model, ml, world.device, work_dir=spec["out"], world=world)
            with torch.no_grad():
                runner.image2image(images, noise=noise)  # warm-up
                torch.cuda.synchronize()
                sf.reset_launch_counts()
                t0 = time.perf_counter()
                gen = runner.image2image(images, noise=noise)["res_render_out"]["gen_imgs"]
                torch.cuda.synchronize()
            report["call_ms"] = (time.perf_counter() - t0) * 1e3
            if world.is_main:
                np.save(os.path.join(spec["out"], "gen_imgs.npy"), gen.float().cpu().numpy())
            rc = 0
        finally:
            mesh.shutdown(world)
    report.update(rc=rc, seconds=time.perf_counter() - t0, peak_gib=peak_gib(),
                  launches={f"{e}/{p}": n for (e, p), n in sf.precision_launch_counts.items() if n})
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return rc


def start_ranks(root: str, name: str, spec: dict, nproc: int | None = DP_RANKS, cards: str | None = None) -> dict:
    """Start a multi-rank run: `nproc` ranks of `chip_smoke.py --rank-child
    SPEC` under torchrun (--standalone), or one process without torchrun (nproc
    None), in a session of its own, on `cards` (CUDA_VISIBLE_DEVICES; None:
    all). SPEC is `spec` with its out directory root/dp/name, which also
    takes the output, and this process's TF32 flags."""
    out = os.path.join(root, "dp", name)
    os.makedirs(out, exist_ok=True)
    spec_path = os.path.join(out, "spec.json")
    spec = {**spec, "out": out, "tf32": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]}
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    me = os.path.abspath(__file__)
    launcher = [] if nproc is None else ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc)]
    env = {**os.environ, **({"CUBLAS_WORKSPACE_CONFIG": ":4096:8"} if spec.get("deterministic") else {}),
           **({"CUDA_VISIBLE_DEVICES": cards} if cards is not None else {})}
    log_file = open(os.path.join(out, "output.log"), "w")
    proc = subprocess.Popen([sys.executable, *launcher, me, "--rank-child", spec_path], cwd=os.path.dirname(me),
                            env=env, stdout=log_file, stderr=subprocess.STDOUT, start_new_session=True)
    CHILDREN.append(proc)
    return {"name": name, "proc": proc, "out": out, "log": log_file, "nproc": nproc or 1, "t0": time.perf_counter()}


def wait_ranks(run: dict, timeout: float = DP_TIMEOUT) -> list[dict]:
    """The ranks' reports once the run exits 0 within `timeout` seconds of
    its start; past it the whole session is killed and the phase fails, as
    it does on a non-zero exit (with the run's last output)."""
    proc, t_wait = run["proc"], time.perf_counter()
    try:
        proc.wait(timeout=max(timeout - (time.perf_counter() - run["t0"]), 1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        raise AssertionError(f"run {run['name']}: still running after {timeout} s, killed") from None
    finally:
        run["log"].close()
        wall_add("ranks_s", time.perf_counter() - run["t0"])
        wall_add("ranks_wait_s", time.perf_counter() - t_wait)
    text = open(os.path.join(run["out"], "output.log")).read()
    if proc.returncode != 0:
        raise AssertionError(f"run {run['name']} exited {proc.returncode}:\n{text[-4000:]}")
    log(f"  {run['name']}: {time.perf_counter() - run['t0']:.1f} s; "
        + "; ".join(line.split(" {")[0] for line in text.splitlines() if line.startswith(("iter ", "resumed"))))
    return [json.load(open(os.path.join(run["out"], f"rank{r}.json"))) for r in range(run["nproc"])]


def per_iteration(reports: list[dict], iters: int) -> dict:
    """Each rank's field launches per iteration, by entry/precision."""
    per = [{k: v / iters for k, v in r["launches"].items()} for r in reports]
    if any(p != per[0] for p in per):
        raise AssertionError(f"the ranks launched the field differently: {per}")
    return per[0]


def dp_gate(label: str, got: str, want: str, first_step: int, groups, lim_loss: float, lim_state: float,
            control: str | None = None, ranks: str = "2 ranks") -> dict:
    """`run_gap` of run `got` (and of the control, which must fall outside)
    against `want`, the batch-mean metrics within lim_loss and the final
    state within lim_state."""
    out = {}
    for name, work in (("ranks", got), ("control", control)):
        if work is None:
            continue
        loss, state, where = run_gap(work, want, first_step, groups, skip=DP_NONLINEAR_METRICS)
        inside = loss <= lim_loss and state <= lim_state
        log(f"  {label}, {ranks if name == 'ranks' else 'control'} vs one rank: metrics {loss:.3e} [limit "
            f"{lim_loss:.3e}], final state {state:.3e} ({where}) [limit {lim_state:.3e}]: "
            f"{'inside' if inside else 'outside'}")
        if name == "ranks" and not inside:
            raise AssertionError(f"{label}: {ranks} drift from one rank")
        if name == "control" and state <= lim_state:
            raise AssertionError(f"{label}: the control passes the gate")
        out[name] = {"metrics": loss, "state": state, "where": where}
    return out


def run_dp(device, root: str, ref: dict) -> dict:
    """Phase 11, on the one card. a. `train.main` at stage1_config, B=4,
    DP_ST1_ITERS iterations: one rank SPREAD_RUNS times (the card's spread), then 2 ranks
    over gloo with CUDA tensors and a control with the BN sync off: the
    batch-mean metrics and the final state (E0, BN statistics, Adam moments)
    each within RESUME_FACTOR x the spread of SPREAD_RUNS one-rank runs
    (`st1_rank_limits`, at least RESUME_FLOOR) and the control outside. b.
    the one-rank reference's run (`ref`,
    `rank_reference`) on 2 ranks and a control with the gradient averaging
    off, against its first run within its limits, the control outside. c.
    the flagship's bf16 image2image of 2 images on 2 ranks against one rank
    inverting the same rows (TOL_DP_SERVING) and its B=2 call
    (TOL_BF16_VS_F32_REL). d. one stage-1 iteration at world 1 under nccl
    (torchrun, one rank) against two processes without a process group, all
    in deterministic mode: every collective of the nccl rank an exact
    identity, the forward (metrics, BN statistics) equal, the backward's
    state within RESUME_FACTOR x the two runs' spread (the stage-1 backward
    keeps atomics that no mode removes). Each multi-rank run's field launches per
    iteration per rank; the per-rank launch shapes against their plain
    versions. Returns the launches and the shapes."""
    from e3dge_torch.runner import Runner
    from e3dge_torch.training import train

    t_phase = time.perf_counter()
    shapes = dp_kernel_check(device)
    gloo = ["--dist-backend", "gloo"]

    # a. stage 1
    st1 = [*DP_ST1_FLAGS, "--iters", str(DP_ST1_ITERS), *perceptual_files(root)]
    ones = [f"st1_one_{i}" for i in range(SPREAD_RUNS)]
    a_work = {n: os.path.join(root, "dp", n) for n in (*ones, "st1_ranks", "st1_bn_off")}
    ranks = start_ranks(root, "st1_ranks", {"kind": "train", "argv": [*st1, *gloo, "--work-dir",
                                                                       a_work["st1_ranks"]]})
    bn_off = start_ranks(root, "st1_bn_off", {"kind": "train", "control": "bn_sync_off",
                                              "argv": [*st1, *gloo, "--work-dir", a_work["st1_bn_off"]]})
    for name in ones:
        t0 = time.perf_counter()
        if train.main([*st1, "--work-dir", a_work[name]]) != 0:
            raise AssertionError(f"phase 11a run {name} failed")
        log(f"  [11a] one rank, {name}: {time.perf_counter() - t0:.1f} s (in this process)")
    st1_reports = wait_ranks(ranks)
    wait_ranks(bn_off)
    log(f"  11a cudnn.benchmark {torch.backends.cudnn.benchmark}")
    lim_loss, lim = st1_rank_limits([a_work[n] for n in ones])
    gate_a = dp_gate("11a stage 1", a_work["st1_ranks"], a_work[ones[0]], 1, _st1_groups, lim_loss, lim,
                     a_work["st1_bn_off"])
    gate_a["limits"] = {"metrics": lim_loss, "state": lim}
    st1_per_iter = per_iteration(st1_reports, DP_ST1_ITERS)
    log(f"  11a field launches per iteration per rank: {st1_per_iter}")

    # b. stage 2.2, the one-rank reference's flags
    st2_iters = int(ref["argv"][ref["argv"].index("--iters") + 1])
    b_work = {n: os.path.join(root, "dp", n) for n in ("st2_ranks", "st2_grads_off")}
    ranks = start_ranks(root, "st2_ranks", {"kind": "train", "argv": [*ref["argv"], *gloo, "--work-dir",
                                                                       b_work["st2_ranks"]]})
    grads_off = start_ranks(root, "st2_grads_off", {"kind": "train", "control": "grad_average_off",
                                                    "argv": [*ref["argv"], *gloo, "--work-dir",
                                                             b_work["st2_grads_off"]]})
    st2_reports = wait_ranks(ranks)
    wait_ranks(grads_off)
    gate_b = dp_gate("11b stage 2.2", b_work["st2_ranks"], ref["work"], 1, _groups, ref["lim_loss"],
                     ref["lim_state"], b_work["st2_grads_off"])
    st2_per_iter = per_iteration(st2_reports, st2_iters)
    log(f"  11b field launches per iteration per rank: {st2_per_iter}")
    for work in (*a_work.values(), *b_work.values()):
        shutil.rmtree(work)

    # c. serving, beside d's three runs (started first: they take the longest)
    torch.cuda.empty_cache()
    one_iter = [*DP_ST1_FLAGS, "--iters", "1", *perceptual_files(root)]
    d_work = {n: os.path.join(root, "dp", n) for n in ("nccl_world1", "no_group_a", "no_group_b")}
    d_runs = [start_ranks(root, "nccl_world1", {"kind": "train", "deterministic": True, "check_collectives": True,
                                                "argv": [*one_iter, "--dist-backend", "nccl", "--work-dir",
                                                         d_work["nccl_world1"]]}, nproc=1)]
    d_runs += [start_ranks(root, n, {"kind": "train", "deterministic": True,
                                     "argv": [*one_iter, "--work-dir", d_work[n]]}, nproc=None)
               for n in ("no_group_a", "no_group_b")]
    serve = start_ranks(root, "serve_ranks", {"kind": "serve", "backend": "gloo"})
    model, images, ml, noise = dp_serving_inputs(device)
    runner = Runner(model, ml, device, work_dir=os.path.join(root, "dp"))

    def gen_imgs(imgs, maps) -> np.ndarray:
        return runner.image2image(imgs, noise=maps)["res_render_out"]["gen_imgs"].float().cpu().numpy()

    with torch.no_grad():
        batch = gen_imgs(images, noise)
        rows = np.concatenate([gen_imgs(images[i:i + 1], [n[i:i + 1] for n in noise]) for i in range(DP_SERVE_BATCH)])
    del model, runner
    serve_reports = wait_ranks(serve)
    got = np.load(os.path.join(root, "dp", "serve_ranks", "gen_imgs.npy"))
    check_image(torch.from_numpy(got), batch.shape, "11c gen_imgs across ranks")
    err = float(np.abs(got - rows).max())
    rel = float(np.abs(got - batch).mean() / np.abs(batch).max())
    log(f"  11c flagship bf16 image2image, B={DP_SERVE_BATCH} over {DP_RANKS} ranks: vs one rank inverting the same "
        f"rows at B=1, max abs {err:.3e} [limit {TOL_DP_SERVING:g}]; vs one rank at B={DP_SERVE_BATCH}, mean "
        f"relative {rel:.3e} [limit {TOL_BF16_VS_F32_REL:g}], max abs {float(np.abs(got - batch).max()):.3e} (one "
        f"rank's rows at B=1 vs its B={DP_SERVE_BATCH} call: {float(np.abs(rows - batch).max()):.3e}); per rank "
        f"{[round(r['call_ms'], 2) for r in serve_reports]} ms a call (2 ranks sharing the card over gloo), "
        f"launches {serve_reports[0]['launches']}")
    if not (err <= TOL_DP_SERVING and rel <= TOL_BF16_VS_F32_REL):
        raise AssertionError("11c: image2image across ranks disagrees with one rank")

    # d. NCCL at world 1 (its runs started with c's)
    (nccl, alone, _) = (wait_ranks(r)[0] for r in d_runs)
    nondet = sorted({line.split("does not have a deterministic")[0].split()[-1] for n in d_work
                     for line in open(os.path.join(root, "dp", n, "output.log"))
                     if "does not have a deterministic" in line})
    coll = nccl.get("collectives", {})
    log(f"  11d one iteration at world 1, deterministic mode: backend {nccl.get('backend')} (world "
        f"{nccl.get('world_size')}) vs {alone.get('backend')} (no process group); the nccl rank's collectives "
        f"{coll}; ops without a deterministic version: {nondet}")
    if nccl.get("backend") != "nccl" or alone.get("backend") is not None:
        raise AssertionError(f"11d: backends {nccl.get('backend')} and {alone.get('backend')}")
    if not coll.get("calls") or coll.get("changed"):
        raise AssertionError(f"11d: the collectives at world 1 are not exact identities: {coll}")
    recs = {n: {k: v for k, v in json.loads(open(os.path.join(w, "metrics.jsonl")).readline()).items() if k != "time"}
            for n, w in d_work.items()}
    ga, gb, gc = (_st1_groups(d_work[n]) for n in d_work)
    bn_equal = all(torch.equal(x, y) for x, y in zip(ga["BN statistics"], gb["BN statistics"]))
    _, spread, where = run_gap(d_work["no_group_b"], d_work["no_group_a"], 1, _st1_groups)
    _, gap, at = run_gap(d_work["nccl_world1"], d_work["no_group_a"], 1, _st1_groups)
    lim = max(RESUME_FACTOR * spread, RESUME_FLOOR)
    log(f"  11d the forward (logged metrics, BN statistics) equal to the run without a group: "
        f"{recs['nccl_world1'] == recs['no_group_a']}, {bn_equal}; the backward's state (E0, the moments): gap "
        f"{gap:.3e} ({at}), two runs without a group {spread:.3e} ({where}) [limit {lim:.3e}]")
    if recs["nccl_world1"] != recs["no_group_a"] or not bn_equal or gap > lim:
        raise AssertionError("11d: world 1 under nccl differs from the run without a process group")
    for work in d_work.values():
        shutil.rmtree(work)
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    return {"shapes": shapes, "launches": {"dp_stage1_iteration_per_rank": st1_per_iter,
                                           "dp_stage2_iteration_per_rank": st2_per_iter,
                                           "dp_serving_per_rank": serve_reports[0]["launches"]},
            "gates": {"11a": gate_a, "11b": gate_b, "11c": {"rows_max_abs": err, "batch_mean_rel": rel}}}


# Phase 12: the sp (ray) axis on the one card: the one-rank reference's
# stage-2.2 run (phase 10b's flags, stage2_config, B=4, TF32 off,
# RANK_REF_ITERS iterations) on a 1x2 and a 2x2 dp x sp world over gloo,
# each a torchrun group of --rank-child, against the reference's first run
# within its limits (RESUME_FACTOR x the card's own spread), each with a
# control
SP_MESHES = (("12a", 1, 2), ("12b", 2, 2))
# the per-rank launch shapes are also checked for the four-card 1x4 world
# of sp_scaling.py
SP_SHAPE_MESHES = ((1, 2), (2, 2), (1, 4))


def sp_gather_without_grad_sum(mesh):
    """Phase 12's control: `mesh.gather_rays` whose backward keeps the rank's
    own rays' gradient instead of summing it over the sp group."""
    gather = mesh.gather_rays

    def gather_rays(x, dim=1):
        w = mesh.ray_split()
        if w is None:
            return x
        mine = mesh._placed(x, dim, w.sp_rank, w.sp)
        return gather(x.detach(), dim) + (mine - mine.detach())

    return gather_rays


def sp_kernel_cases() -> list:
    """The `highest` launch shapes of the ray-split cycle step per rank at
    stage2_config, global B=ST2_BATCH, on SP_SHAPE_MESHES that no earlier
    phase checks: (label, B, N, raw_h, SDF-only). Each rank renders H/sp of
    the image's ray rows (the sample, ref and query renders; the query render
    writes raw_h) and queries the SDF targets of its share (the near-surface
    points of its rows, 1/sp of the uniform points). The D producers run
    whole: phase 8's and 11's shapes."""
    from e3dge_torch.config import stage2_config

    c = stage2_config().renderer
    n_img = c.out_im_res ** 2 * c.n_samples
    # phase 8's and 11's SDF targets
    seen = {(ST2_BATCH, c.out_im_res ** 2, False, True), (ST2_BATCH, c.uniform_grid_sampling_num, False, True),
            (ST2_BATCH // 2, c.out_im_res ** 2 // 2, False, True)}
    cases = []
    for dp, sp in SP_SHAPE_MESHES:
        b = ST2_BATCH // dp
        for label, n, raw_h, sdf in (("ray-split sample / ref render", n_img // sp, False, False),
                                     ("ray-split query render, raw_h out", n_img // sp, True, False),
                                     ("near-surface SDF targets", c.out_im_res ** 2 // sp, False, True),
                                     ("uniform SDF targets", c.uniform_grid_sampling_num // sp, False, True)):
            if (b, n, raw_h, sdf) not in seen:
                seen.add((b, n, raw_h, sdf))
                cases.append((f"{dp}x{sp} {label}", b, n, raw_h, sdf))
    return cases


def sp_kernel_check(device) -> dict:
    """`siren_field_full` in `highest` at `sp_kernel_cases()` against its
    plain version, timed beside the bound; {label: figures}."""
    out = {}
    for label, batch, n, raw_h, sdf_only in sp_kernel_cases():
        r = check_and_time_full(label, batch, n, False, "highest", device, sdf_only=sdf_only, raw_h=raw_h)
        out[label] = {"entry": "siren_field_full", "precision": "highest", "batch": batch, "n": n, "raw_h": raw_h,
                      "sdf_only": sdf_only, **r}
    return out


def run_sp(device, root: str, ref: dict) -> dict:
    """Phase 12, on the one card: the one-rank reference's run (`ref`,
    `rank_reference`: its flags, its first run and both limits) through
    `train.main --sp 2` on a 1x2 (12a) and a 2x2 (12b) world over gloo with
    CUDA tensors, each beside a control with the sp gradient sum off
    (`sp_gather_without_grad_sum`): the batch-mean metrics and the final
    state against the reference's first run within its limits, each control
    outside; each world's field launches per rank per iteration. 12c: the per-rank launch shapes against their plain
    versions, timed beside their bounds. Returns the launches, gates and
    shapes."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks and controls of 12b, 8 processes, share the card with this one
    shapes = sp_kernel_check(device)
    iters = int(ref["argv"][ref["argv"].index("--iters") + 1])
    launches, gates = {}, {}
    for label, dp, sp in SP_MESHES:
        name = f"{dp}x{sp}"
        work = {k: os.path.join(root, "dp", f"sp_{name}_{k}") for k in ("ranks", "control")}
        argv = [*ref["argv"], "--dist-backend", "gloo", "--sp", str(sp)]
        runs = [start_ranks(root, f"sp_{name}_{k}", {"kind": "train", "argv": [*argv, "--work-dir", work[k]],
                                                     **({"control": "sp_grad_sum_off"} if k == "control" else {})},
                            nproc=dp * sp) for k in work]
        reports = wait_ranks(runs[0])
        wait_ranks(runs[1])
        gates[label] = dp_gate(f"{label} stage 2.2 on {name}", work["ranks"], ref["work"], 1, _groups,
                               ref["lim_loss"], ref["lim_state"], work["control"], ranks=f"{name} ranks")
        launches[f"sp_{name}_stage2_iteration_per_rank"] = per_iteration(reports, iters)
        log(f"  {label} field launches per iteration per rank: {launches[f'sp_{name}_stage2_iteration_per_rank']}; "
            f"rank seconds {[round(r['seconds'], 1) for r in reports]}, peak GiB "
            f"{[round(r['peak_gib'], 2) for r in reports]}")
        for w in work.values():
            shutil.rmtree(w)
    log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return {"shapes": shapes, "launches": launches, "gates": gates}


# Phase 13: the JAX stage scripts' bf16 recipe (train_stage1.sh:12-13,
# train_stage2.2.sh:12-13: --sample-field-dtype, --dtype and --field-dtype
# bfloat16) at phases 7's and 8's full widths, and the config-selected
# variants: the bn netLocal (netLocal_type HGPIFuNetGANResidual) in phase 8's
# iteration, the raw-density renderer (with_sdf False) in the flagship's
# image2image. The bf16 loss against the f32 loss of one batch and weights
# within BF16_VS_F32_LOSS (tests/test_precision.py:159, :196).
BF16_VS_F32_LOSS = 0.15
BN_NETLOCAL = dict(netLocal_type="HGPIFuNetGANResidual")
# the raw-density renderer integrates with beta = 1: the seeded sdf head
# (weights within +-0.006) gives densities that vary by ~0.1 along a ray,
# which beta = 1 integrates into flat weights and a depth map flat to 1e-4;
# the head is scaled so the density varies on beta's scale, as
# tests/test_torch_variants.py scales it
RAW_DENSITY_SDF_GAIN = 30.0
# the reduced bf16 step's card-vs-CPU limits: BF16_GATE_FACTOR x the CPU's
# own bf16-vs-f32 gap. The card's bf16 step and the CPU's are two roundings
# of one f32 step, each about that gap from it, so about sqrt(2) x the gap
# from each other when the roundings are independent (on an H100, 0.96x and
# 1.00x it on E0's gradient and on its 3D terms' part)
BF16_GATE_FACTOR = 2.0


def bf16_recipe(cfg):
    """cfg at the stage scripts' three dtypes."""
    from e3dge_torch.config import _with

    bf16 = _with(cfg, renderer=dict(sample_field_dtype="bfloat16", field_dtype="bfloat16"))
    return dataclasses.replace(bf16, dtype="bfloat16").validate()


def bn_netlocal(cfg):
    from e3dge_torch.config import _with

    return _with(cfg, pifu=BN_NETLOCAL).validate()


def bf16_kernel_cases() -> tuple:
    """The bf16 recipe's `serving` launch shapes new to phase 13: (label,
    entry, B, N, raw_h). Stage 1's sample render (B=4 x 64^2 x 18); stage
    2's sample and ref renders (B=4 x 64^2 x 24), its query render and the D
    producer's image2image render (raw_h out) and the producer's texture
    pass (SFT in)."""
    from e3dge_torch.config import stage1_config, stage2_config

    c1, c2 = stage1_config().renderer, stage2_config().renderer
    n1, n2 = c1.out_im_res ** 2 * c1.n_samples, c2.out_im_res ** 2 * c2.n_samples
    return (("13a stage-1 bf16 sample render", "siren_field_full", ST1_BATCH, n1, False),
            ("13b stage-2 bf16 sample / ref render", "siren_field_full", ST2_BATCH, n2, False),
            ("13b stage-2 bf16 query / D producer render, raw_h out", "siren_field_full", ST2_BATCH, n2, True),
            ("13b stage-2 bf16 D producer texture pass", "siren_field_tex", ST2_BATCH, n2, False))


def bf16_kernel_check(device) -> dict:
    """`serving` at each of `bf16_kernel_cases()` against its plain version,
    timed beside the bound; {label: figures}."""
    out = {}
    for label, entry, batch, n, raw_h in bf16_kernel_cases():
        if entry == "siren_field_tex":
            r = check_and_time_tex(label, batch, n, "serving", device)
        else:
            r = check_and_time_full(label, batch, n, False, "serving", device, raw_h=raw_h)
        out[label] = {"entry": entry, "precision": "serving", "batch": batch, "n": n, "raw_h": raw_h, **r}
    return out


def step_loss(stage: str, model, batch, ml, lpips_fn, id_fn, noise, d=None, cut: bool = False):
    """(loss, metrics) of one stage-1 step (`stage1_loss`, the stage-1
    lambdas) or one stage-2.2 step (`cycle_loss`, phase 8's recipe, the
    full-res D's term at the fixed weight) on a given batch; `cut` plants
    phase 7's control (the eikonal double backward cut) or phase 8's (the
    SFT modulations detached before the re-render)."""
    from unittest import mock

    from e3dge_torch.training import steps

    if stage == "1":
        eikonal = steps.eikonal_term
        ctx = mock.patch.object(steps, "eikonal_term", lambda r, p, s, create_graph=False: eikonal(r, p, s, False))
        with ctx if cut else contextlib.nullcontext():
            loss, metrics, _ = steps.stage1_loss(model, batch, ml, steps.STAGE1_LAMBDAS, lpips_fn, id_fn, noise=noise)
        return loss, metrics
    render_cached = model.generator.render_cached

    def detached(styles, cached, conditions, **kw):
        return render_cached(styles, cached, tuple(t.detach() for t in conditions), **kw)

    with mock.patch.object(model.generator, "render_cached", detached) if cut else contextlib.nullcontext():
        loss, metrics, _ = steps.cycle_loss(model, batch, ml, ST2_LAMBDAS, lpips_fn, id_fn, d_fn=d, noise=noise)
    return loss, metrics


def stage_model(stage: str, cfg, device, fix_ada: bool = True):
    """(model, mean latents, lpips_fn, id_fn, trained parameters, the full-res
    D or None): phase 7's or phase 8's seeded build (`st1_model`,
    `st2_model`; with fix_ada the aligner frozen, as the recipe freezes it,
    else trained, as phase 8's reduced gate trains it)."""
    from e3dge_torch.training import steps

    if stage == "1":
        model, ml, lpips_fn, id_fn, state = st1_model(cfg, device)
        return model, ml, lpips_fn, id_fn, state.params, None
    model, ml, lpips_fn, id_fn, state, d = st2_model(cfg, device, steps.stage22_trainable(fix_ada),
                                                     min(cfg.decoder.size, 256))
    return model, ml, lpips_fn, id_fn, state.params, d


def bf16_vs_f32_loss(device, stage: str) -> dict:
    """13a / 13b: the stage's loss (`stage1_loss`, `cycle_loss`) at full
    width, B=4, on one batch made by the bf16 recipe's model (the serving
    kernel samples it) from the same seeded weights, in the bf16 recipe and
    in f32: the relative gap below BF16_VS_F32_LOSS."""
    from e3dge_torch.config import stage1_config, stage2_config
    from e3dge_torch.training import steps

    base = stage1_config() if stage == "1" else stage2_config()
    losses, data = {}, {}
    for name, cfg in (("bf16", bf16_recipe(base)), ("f32", base)):
        model, ml, lpips_fn, id_fn, _, d = stage_model(stage, cfg, device)
        if not data:
            gen = torch.Generator(device).manual_seed(SEED + 13)
            data["noise"] = steps.decoder_noise(model, 4, gen)
            data["batch"] = model.synthetic_sample(4, 1.0, pair_same_id=stage != "1", generator=gen,
                                                   noise=data["noise"])
        loss, _ = step_loss(stage, model, data["batch"], ml, lpips_fn, id_fn, data["noise"], d)
        losses[name] = float(loss.detach())
        del model, lpips_fn, id_fn, d, loss
        torch.cuda.empty_cache()
    rel = abs(losses["bf16"] - losses["f32"]) / abs(losses["f32"])
    log(f"  [13{'a' if stage == '1' else 'b'}] loss on one batch and weights, full width: bf16 recipe "
        f"{losses['bf16']:.6g}, f32 {losses['f32']:.6g}, relative {rel:.3e} [< {BF16_VS_F32_LOSS:g}]")
    if not rel < BF16_VS_F32_LOSS:
        raise AssertionError("the bf16 recipe's loss drifted from f32")
    return {**losses, "rel": rel}


def bf16_step(stage: str, cfg, dev, data: dict, cut: bool = False) -> tuple[dict, dict]:
    """One step's loss and backward of `bf16_card_vs_cpu` (stage_model of
    cfg with the aligner trained, `step_loss`) on dev from `reduced_batch`'s
    data: (the loss terms, {part: its gradient on the trained parameters, on
    the CPU}). On the CPU, a job of the child of `CpuReferences`."""
    dev = torch.device(dev)
    parts = BF16_GATE_PARTS[stage]
    terms = ("loss",) + (ST1_TERMS if stage == "1" else ST2_TERMS)
    t0 = time.perf_counter()
    model, ml, lpips_fn, id_fn, params, d = stage_model(stage, cfg, dev, fix_ada=False)
    b = {k: to_dev(v, dev) for k, v in data["batch"].items()}
    loss, metrics = step_loss(stage, model, b, ml, lpips_fn, id_fn, [n.to(dev) for n in data["noise"]], d, cut=cut)
    grads = {}
    for part in parts:
        g = torch.autograd.grad(metrics[part], list(params.values()), retain_graph=part != parts[-1],
                                allow_unused=True)
        grads[part] = {k: (torch.zeros_like(p) if gk is None else gk).detach().float().cpu()
                       for (k, p), gk in zip(params.items(), g)}
    name = ("CPU" if cfg.dtype == "bfloat16" else "CPU f32") if dev.type == "cpu" else (
        "card, control" if cut else "card")
    log(f"  [{'13a' if stage == '1' else '13b'}] reduced bf16 step, {name}: {time.perf_counter() - t0:.1f} s "
        "(build + one step)")
    return {k: float(metrics[k].detach()) for k in terms}, grads


# the gradients held by the reduced bf16 gate: the whole loss's and, in stage
# 1, its 3D shape terms' (the SDF targets' and the eikonal double backward's:
# E0's whole gradient in bf16 moves by as much as the eikonal part weighs)
BF16_GATE_PARTS = {"1": ("loss", "loss_shape"), "2": ("loss",)}


def bf16_card_vs_cpu(device, stage: str, refs: "CpuReferences"):
    """13a / 13b, last part: one step's loss and backward of phase 7's or 8's
    reduced config (8's at the recipe's switches, the aligner trained) in
    the bf16 recipe, on the card
    and on the CPU (ST1_CPU_THREADS threads, `bf16_step` in phase 13's `CpuReferences`
    child), from one batch made on the card by the bf16 model, TF32
    off. The limits are BF16_GATE_FACTOR x the CPU's
    own bf16-vs-f32 gap on that batch: the worst term's relative gap and the
    trained gradient's relative L2 over all leaves, in stage 1 also the
    gradient of the 3D shape terms alone. The card's bf16 run against the
    CPU's must stay within each; the control (phase 7's or 8's) must fall
    outside one. Returns the gate, a function that runs the card's steps,
    waits for the CPU's, compares and returns the gaps and limits."""
    tag = "13a" if stage == "1" else "13b"
    base = st1_reduced_config() if stage == "1" else st2_reduced_config()
    # stage 2 at train_stage2.2.sh's switches (no ref-view weighting, no
    # consistency terms, the fixed D weight), the aligner trained
    parts = BF16_GATE_PARTS[stage]
    with tf32_off():  # on the card, by the bf16 model
        data = reduced_batch(stage_model(stage, bf16_recipe(base), device, fix_ada=False)[0], device,
                             pair_same_id=stage != "1")
    jobs = [refs.add("bf16_step", stage, bf16_recipe(base), "cpu", data),
            refs.add("bf16_step", stage, base, "cpu", data)]

    def gate() -> dict:
        with tf32_off():
            runs = {"card": bf16_step(stage, bf16_recipe(base), device, data),
                    "card, control": bf16_step(stage, bf16_recipe(base), device, data, cut=True)}
        torch.cuda.empty_cache()
        runs["CPU"], runs["CPU f32"] = (refs.result(j) for j in jobs)

        def gap(a, b) -> dict:
            """The worst term's relative gap and each gradient's relative L2."""
            (ma, ga), (mb, gb) = runs[a], runs[b]
            return {"term": max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-6) for k in mb),
                    **{f"gradient of {p}": grad_gap(ga[p], gb[p])[0] for p in parts}}

        spread = gap("CPU", "CPU f32")
        limits = {k: BF16_GATE_FACTOR * v for k, v in spread.items()}
        log(f"  [{tag}] the CPU's bf16-vs-f32 gap: " + ", ".join(f"{k} {v:.3e}" for k, v in spread.items())
            + f"; limits {BF16_GATE_FACTOR:g}x")
        out = {"cpu_bf16_vs_f32": spread, "limits": limits}
        for name in ("card", "card, control"):
            out[name] = got = gap(name, "CPU")
            inside = all(got[k] <= limits[k] for k in limits)
            log(f"  [{tag}] {name} vs CPU (bf16 recipe): " + ", ".join(
                f"{k} {got[k]:.3e} [limit {limits[k]:.3e}]" for k in limits)
                + f": {'inside' if inside else 'outside'}")
            if name == "card" and not inside:
                raise AssertionError(f"{tag}: the bf16 step disagrees between the card and the CPU")
            if name != "card" and inside:
                raise AssertionError(f"{tag}: the control passes the bf16 card-vs-CPU gate")
        return out

    return gate


def raw_density_gain(model) -> None:
    """13c's seeded weights: the sdf head scaled by RAW_DENSITY_SDF_GAIN."""
    with torch.no_grad():
        model.generator.renderer.network.sigma_linear.weight.mul_(RAW_DENSITY_SDF_GAIN)


def raw_density_f32_config():
    """13c's raw-density flagship (with_sdf False) in f32."""
    from e3dge_torch.config import _with, flagship_config

    cfg = _with(flagship_config(), renderer=dict(with_sdf=False, field_dtype="float32"))
    return dataclasses.replace(cfg, dtype="float32").validate()


def raw_density_gate(refs: "CpuReferences") -> tuple:
    """Queue 13c's raw-density CPU reference on phase 13's `CpuReferences`."""
    return refs, refs.add("f32_image2image_cpu", raw_density_f32_config(), "raw_density_gain")


def run_raw_density(device, cpu: tuple | None = None) -> dict:
    """13c: `image2image` of the flagship config with with_sdf False (the
    raw-density renderer, beta = 1) on seeded weights, its sdf head scaled by
    RAW_DENSITY_SDF_GAIN: in bf16 on the card one launch of each kernel entry
    and a finite, non-constant 1024^2 image, ms per inversion; then f32 on
    the card against the CPU within phase 5's TOL_CARD_VS_CPU."""
    from e3dge_torch.config import _with, flagship_config
    from e3dge_torch.models.e3dge import E3DGE
    from e3dge_torch.utils.weights import init_weights

    cfg = _with(flagship_config(), renderer=dict(with_sdf=False)).validate()
    model = E3DGE(cfg)
    init_weights(model, SEED)
    raw_density_gain(model)
    if hasattr(model.generator.renderer, "sigmoid_beta"):
        raise AssertionError("a raw-density renderer registered sigmoid_beta")
    images, ml, noise = to_device(*seeded_inputs(cfg, SEED), decoder_noise(cfg, 1, SEED), device)
    out, counts = counted(lambda: model.image2image(images, ml, noise=noise))
    log(f"  [13c] raw-density image2image (flagship, bf16): launches {counts}")
    if counts != {"siren_field_full": 1, "siren_field_tex": 1}:
        raise AssertionError(f"raw-density image2image did not launch each field kernel once: {counts}")
    check_image(out["res_render_out"]["gen_imgs"].cpu(), (1, 3, 1024, 1024), "13c raw-density gen_imgs")
    ms, lo, hi = median_call_ms(lambda: model.image2image(images, ml, noise=noise), calls=5, warmup=1)
    log(f"  [13c] raw-density image2image: median {ms:.2f} ms per inversion over 5 calls (min {lo:.2f}, max {hi:.2f})")
    del model, out
    torch.cuda.empty_cache()
    refs, job = cpu or (None, None)
    f32_card_vs_cpu(raw_density_f32_config(), device, weights="raw_density_gain", refs=refs, job=job)
    torch.cuda.empty_cache()
    return {"launches": counts, "ms": ms}


def beside(tag: str, bf16: dict, f32: dict | None) -> None:
    """Log a bf16 run's figures beside the f32 phase's from this run."""
    def fmt(fig):
        parts = ", ".join(f"{k} {v:.2f}" for k, v in fig["parts"].items())
        return (f"{fig['ms']:.2f} ms ({parts}), busy {fig['busy_ms']:.3f} ms, field kernel {fig['field_ms']:.3f} ms, "
                f"twin {fig['twin_ms']:.3f} ms ({fig['twin_share']:.3f} of busy), peak {fig['peak_gib']:.2f} GiB")

    log(f"  [{tag}] bf16 recipe: {fmt(bf16)}")
    log(f"  [{tag}] f32 (this run): {fmt(f32) if f32 else 'not run in this call'}")


def bf16_gates(device, refs: "CpuReferences") -> dict:
    """Phase 13's card-vs-CPU gates with their batches made on the card and
    their CPU references queued on `refs` (main queues them on phase 7's
    child, which runs them beside phases 7 to 10): 13a's and 13b's reduced
    bf16 steps, 13c's bn step and its raw-density image2image."""
    return {"1": bf16_card_vs_cpu(device, "1", refs), "2": bf16_card_vs_cpu(device, "2", refs),
            "bn": st2_card_vs_cpu(device, bn_netlocal(st2_reduced_config()), field_gap=True, refs=refs),
            "raw": raw_density_gate(refs)}


def run_bf16_and_variants(device, st1_f32: dict | None = None, st2_f32: dict | None = None,
                          gates: dict | None = None) -> dict:
    """Phase 13: a. stage 1 at the bf16 recipe (`run_stage1` of
    bf16_recipe(stage1_config)), its loss against f32 on one batch, its
    reduced step card vs CPU; b. stage 2.2 the same (`run_stage2`); each
    beside phase 7's / 8's f32 figures when given; c. one stage-2.2 iteration
    with the bn netLocal (its BN statistics move, phase 8's launches) and
    its reduced cycle loss card vs CPU (phase 8's gate and control), the
    raw-density image2image. `gates`: `bf16_gates` made earlier, else made
    here with a child of their own. Returns the launches, shapes and
    figures."""
    from e3dge_torch.config import stage1_config, stage2_config

    t_phase = time.perf_counter()
    with torch.no_grad():
        shapes = bf16_kernel_check(device)
    if gates is None:  # the reduced gates' CPU references start first and run beside 13a-c
        refs = CpuReferences("13")
        gates = bf16_gates(device, refs)
        refs.start()
    log("  [13a] stage 1, bf16 recipe, stage1_config at full width")
    st1 = run_stage1(device, bf16_recipe(stage1_config()), tag="13a")
    beside("13a stage-1 step", st1["figures"], st1_f32 and st1_f32["figures"])
    loss1 = bf16_vs_f32_loss(device, "1")
    gate1 = gates["1"]()
    log("  [13b] stage 2.2, bf16 recipe, stage2_config at full width")
    st2 = run_stage2(device, bf16_recipe(stage2_config()), tag="13b")
    beside("13b stage-2.2 iteration", st2["figures"], st2_f32 and st2_f32["figures"])
    loss2 = bf16_vs_f32_loss(device, "2")
    gate2 = gates["2"]()
    log("  [13c] the bn netLocal: one stage-2.2 iteration at stage2_config, phase 8's recipe")
    bn = run_stage2(device, bn_netlocal(stage2_config()), tag="13c", warmup=0, iters=1, profile=False)
    gates["bn"]()
    log("  [13c] the raw-density renderer: flagship image2image")
    raw = run_raw_density(device, gates["raw"])
    log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
    return {"shapes": shapes, "stage1": st1, "stage2": st2, "bn": bn, "raw": raw,
            "gates": {"13a": {"loss": loss1, **gate1}, "13b": {"loss": loss2, **gate2}}}


# Phase 14: the long tail (the modules only the JAX tests reach) on the card,
# each card-vs-CPU gate taking its gap by magnitude (`mag_gap`, run_gap's
# rule) against a limit 10x the matching CPU test's tolerance, each with a
# control that must fail it. The secant search through query_sdf is the
# field kernel's path here: one launch at B x H*W*24 points, then 8 at B x H*W
LT_SECANT_COARSE, LT_SECANT_STEPS = 24, 8
LT_SECANT_LAUNCHES = {"siren_field_full": 1 + LT_SECANT_STEPS, "siren_field_tex": 0}
# tests/test_torch_geometry_extras.py: the secant's z 1e-4, forward_ddf 1e-5,
# mlp_init_pass's gradient 1e-4 of its scale; test_torch_encoder_variants.py
# and test_torch_align_extras.py: 1e-4 of scale; x10
LT_TOL = {"secant z": 1e-3, "forward_ddf": 1e-4, "mlp_init loss": 1e-3, "mlp_init gradient": 1e-3,
          "encoder codes": 1e-3, "align outputs": 1e-3}
# a coarse sample within this of the level can pick another bracket (the
# kernel's sdf within KERNEL_TOLERANCE's 1e-4 of the plain field's)
LT_AMBIGUOUS = 1e-4
# calc_losses' scores card vs CPU: EVAL_TOL's (phase 9) per metric; the
# perceptual modes 10x the CPU test's 1e-4 of scale
LT_CALC_TOL = {"l2": EVAL_TOL["loss_l2"], "mae_ref": EVAL_TOL["mae"], "ssim": EVAL_TOL["ssim"],
               "ssim_ref": EVAL_TOL["ssim"], "psnr": EVAL_TOL["psnr"], "lpips": 1e-3, "id": 1e-3}
LT_GALLERY = (2, 8, 64)  # images, views, frame size


def mag_gap(got, want) -> float:
    """max |got - want| over max |want| (run_gap's rule: a gap by magnitude)."""
    got, want = (torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).double().cpu() for x in (got, want))
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def lt_renderer(cfg, dev):
    """(the renderer of cfg on dev with seeded weights, a camera at azimuth
    0.1 and elevation 0.05 at cfg's resolution, seeded styles [1, D+1, 256])."""
    from e3dge_torch.models.volume_renderer import VolumeFeatureRenderer
    from e3dge_torch.render.camera import camera_params_from_angles
    from e3dge_torch.utils.weights import init_weights

    r = VolumeFeatureRenderer(cfg).to(dev)
    init_weights(r, SEED)
    cam = camera_params_from_angles(torch.tensor([0.1], device=dev), torch.tensor([0.05], device=dev), cfg.out_im_res)
    styles = torch.from_numpy((0.3 * np.random.RandomState(SEED + 14).randn(1, cfg.depth + 1, cfg.style_dim))
                              .astype(np.float32)).to(dev)
    return r, cam, styles


def twin_sdf(renderer, styles):
    """The eager twin's SDF at world points [B, ..., 3] (the renderer's
    warp, backbone and sdf head; no kernel on any device)."""
    net = renderer.network

    def fn(p):
        q = (p * (1.0 / renderer.camera_dist_radius)).reshape(p.shape[0], -1, 3)
        return net.geo_head(net.backbone(q, styles)).reshape(*p.shape[:-1], 1)

    return fn


def lt_secant_level(dev) -> float:
    """14a's SDF level: the 5th percentile of the twin's coarse samples over
    the flagship renderer's rays (about half the rays hit)."""
    return lt_secant(dev, "twin", None, steps=0)["level"]


def lt_secant(dev, route: str = "kernel", level: float | None = None, steps: int = LT_SECANT_STEPS) -> dict:
    """14a: `find_surface_secant` over the flagship renderer's 64^2 rays (B=1,
    LT_SECANT_COARSE + steps samples) at the SDF `level` with sdf_fn its
    query_sdf (route "kernel": the field kernel on the card, "plain": the
    kernel's plain version in its place) or the eager twin ("twin", the CPU
    reference), without grad. level None: `lt_secant_level`'s. Returns z,
    hit, the coarse samples' distance to the level, the level and the
    launches."""
    from unittest import mock

    from e3dge_torch.config import flagship_config
    from e3dge_torch.models import volume_renderer
    from e3dge_torch.ops import siren_field as sf
    from e3dge_torch.render.rays import find_surface_secant, get_rays

    dev = torch.device(dev)
    cfg = flagship_config().renderer
    r, cam, styles = lt_renderer(cfg, dev)
    rays_o, rays_d, _ = get_rays(cam.focal, cam.poses, cfg.out_im_res)
    near, far = cam.near.reshape(1, 1, 1), cam.far.reshape(1, 1, 1)
    t = torch.linspace(0.0, 1.0, LT_SECANT_COARSE, device=dev)
    z = near[..., None] * (1 - t) + far[..., None] * t
    fn = twin_sdf(r, styles) if route == "twin" else (lambda p: r.query_sdf(p, styles))
    with torch.no_grad():
        coarse = twin_sdf(r, styles)(rays_o[..., None, :] + rays_d[..., None, :] * z[..., None])[..., 0]
        if level is None:
            level = float(torch.quantile(coarse.flatten().cpu(), 0.05))
        with mock.patch.object(volume_renderer, "siren_field_full", sf.siren_field_reference) if route == "plain" \
                else contextlib.nullcontext():
            (zs, hit), counts = counted(lambda: find_surface_secant(fn, rays_o, rays_d, near, far, LT_SECANT_COARSE,
                                                                    steps, level)) \
                if dev.type == "cuda" else ((find_surface_secant(fn, rays_o, rays_d, near, far, LT_SECANT_COARSE,
                                                                 steps, level)), {})
    return {"z": zs.cpu(), "hit": hit.cpu(), "near_level": (coarse - level).abs().amin(-1).cpu(), "level": level,
            "launches": counts}


def lt_mlp_init(dev, offset_sampling: bool | None = None) -> dict:
    """14a: `mlp_init_pass` of stage1_config's renderer (B=1, its 64^2 x 18
    samples) with grad on the twin, from a seeded jitter draw: the loss
    mean((sdf - target)^2) and its gradient on the field's parameters.
    offset_sampling overrides the config's grid (the control)."""
    from e3dge_torch.config import stage1_config

    dev = torch.device(dev)
    cfg = stage1_config().renderer
    if offset_sampling is not None:
        cfg = dataclasses.replace(cfg, offset_sampling=offset_sampling)
    r, cam, styles = lt_renderer(cfg, dev)
    t_rand = torch.from_numpy(np.random.RandomState(SEED + 15).uniform(
        size=(1, cfg.out_im_res, cfg.out_im_res, cfg.n_samples)).astype(np.float32)).to(dev)
    sdf, target = r.mlp_init_pass(cam, styles, t_rand=t_rand)
    loss = torch.mean((sdf - target) ** 2)
    loss.backward()
    return {"loss": float(loss.detach()), "grad": {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
                                          for k, p in r.network.named_parameters()}}


def lt_forward_ddf(dev, roll_styles: bool = False) -> dict:
    """14a: `SirenGenerator.forward_ddf` at 8 x 256 (the eager twin on every
    device) on 4,096 seeded points, feat_layer 2 with multi_layer (layers
    2..7 and the view features). roll_styles shifts the W+ rows by one (the
    control)."""
    from e3dge_torch.models.siren import SirenGenerator
    from e3dge_torch.utils.weights import init_weights

    dev = torch.device(dev)
    net = SirenGenerator(8, 256, 256).to(dev)
    init_weights(net, SEED)
    rng = np.random.RandomState(SEED + 16)
    pts = torch.from_numpy(rng.uniform(-1, 1, (1, 4096, 3)).astype(np.float32)).to(dev)
    views = torch.nn.functional.normalize(torch.from_numpy(rng.randn(1, 4096, 3).astype(np.float32)), dim=-1).to(dev)
    styles = torch.from_numpy((0.3 * rng.randn(1, 9, 256)).astype(np.float32)).to(dev)
    if roll_styles:
        styles = styles.roll(1, dims=1)
    with torch.no_grad():
        out = net.forward_ddf(pts, views, styles, feat_layer=2, multi_layer=True)
    return {k: v.cpu() for k, v in out.items()}


def lt_encoder_inputs(name: str) -> tuple:
    """14b's input of `set_encoder(name)` at the flagship's EncoderConfig, B=1:
    256^2 for the IR-SE-50 family and the D-backbone encoders (FullEncoder
    pools its own 64^2 thumb), 64^2 thumbs for the volume-D encoders."""
    res = 64 if name in ("VolumeRenderDiscriminatorEncoder", "VolumeStyleEncoder") else 256
    return (torch.from_numpy(np.random.RandomState(SEED + 17).uniform(-1, 1, (1, 3, res, res)).astype(np.float32)),)


def lt_encoder(name: str, dev, stage: int | None = None) -> list:
    """14b: `set_encoder(name, flagship EncoderConfig)` with seeded weights in
    eval mode on dev: its [renderer, decoder] W+ codes (None where it has
    none) on the CPU. stage is e4e's per-call progressive stage."""
    from e3dge_torch.config import flagship_config
    from e3dge_torch.models.encoders.factory import set_encoder
    from e3dge_torch.utils.weights import init_weights

    dev = torch.device(dev)
    kw = {"VolumeRenderDiscriminatorEncoder": dict(init_size=64), "VolumeStyleEncoder": dict(init_size=64)}.get(
        name, dict(input_size=256, channel_multiplier=2) if name in ("StyleGANEncoder", "DEncoder", "FullEncoder")
        else {})
    enc = set_encoder(name, flagship_config().encoder, **kw)
    init_weights(enc, SEED)
    enc = enc.to(dev).eval()
    with torch.no_grad():
        out = enc(*(x.to(dev) for x in lt_encoder_inputs(name)), **({} if stage is None else {"stage": stage}))
    return [None if o is None else o.float().cpu() for o in out]


def lt_encoders(dev) -> dict:
    """14b's every `set_encoder` name, on dev (the CPU reference's job)."""
    from e3dge_torch.models.encoders.factory import ENCODERS

    return {name: lt_encoder(name, dev) for name in ENCODERS}


def lt_align(dev) -> dict:
    """14c: the align ablation blocks at their constructor widths on maps of
    the flagship E1's sizes, seeded weights, eval mode: ResidualEncoder
    (512 x 64^2 conditions) on a 256^2 residual, FeatureAligner on 256^2
    residual, depth, thumb and hourglass-width (256) ref features; the
    conv blocks at the hourglass width on 64^2 feature maps. Returns each
    block's outputs on the CPU, and the DemodulatedConv2d's convolution
    without its demodulation (the control) under "DemodulatedConv2d, plain"."""
    from e3dge_torch.config import flagship_config
    from e3dge_torch.models import align
    from e3dge_torch.utils.weights import init_weights

    dev = torch.device(dev)
    c = flagship_config().pifu.hourglass_dim
    rng = np.random.RandomState(SEED + 18)

    def x(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    res, depth, thumb, ref = x(1, 3, 256, 256), x(1, 1, 256, 256), x(1, 3, 256, 256), x(1, c, 256, 256)
    f1, f2, mask = x(1, c, 64, 64), x(1, c, 64, 64), torch.sigmoid(x(1, 1, 64, 64))
    cases = {
        "ResidualEncoder": (align.ResidualEncoder(), (res,), {}),
        "FeatureAligner": (align.FeatureAligner(ref_feats_dim=c), (res, depth, ref, thumb), {}),
        "DemodulatedConv2d": (align.DemodulatedConv2d(c, c, 3, padding=1), (f1,), {}),
        "ConvResBlock": (align.ConvResBlock(c, c), (f1,), {}),
        "FuseSftBlock": (align.FuseSftBlock(2 * c, c), (f1, f2), {"w": 0.5}),
        "ResidualConvBlock": (align.ResidualConvBlock(c, c), (f1,), {}),
        "AlignInpainterFusionBlock": (align.AlignInpainterFusionBlock(c), (f1, f2, mask), {}),
    }
    out = {}
    for name, (block, args, kw) in cases.items():
        init_weights(block, SEED)
        with torch.no_grad():
            got = block.to(dev).eval()(*args, **kw)
        out[name] = [t.cpu() for t in (got if isinstance(got, tuple) else (got,))]
        if name == "DemodulatedConv2d":
            with torch.no_grad():
                out["DemodulatedConv2d, plain"] = [torch.nn.functional.conv2d(f1, block.weight[0], padding=1).cpu()]
    return out


def lt_calc_losses(dev, res_dir: str, gt_dir: str, out: str) -> dict:
    """14d: `python -m e3dge_torch.tools.calc_losses` in every mode on dev
    (seeded perceptual nets): {mode: {image: score}}."""
    from e3dge_torch.tools import calc_losses

    scores = {}
    for mode in calc_losses.MODES:
        argv = ["--mode", mode, "--data-path", res_dir, "--gt-path", gt_dir, "--out", out, "--device", str(dev)]
        if calc_losses.main(argv) != 0:
            raise AssertionError(f"calc_losses --mode {mode} failed")
        scores[mode] = json.load(open(os.path.join(out, f"scores_{mode}.json")))
    return scores


def lt_gate(label: str, gap: float, limit: float, control: float | None = None) -> None:
    """The card within `limit` of the CPU, and the control (if given)
    outside it; logged."""
    ok = gap <= limit and math.isfinite(gap)
    text = f"  [{label}] card vs CPU: {gap:.3e} [limit {limit:g}] {'ok' if ok else 'FAIL'}"
    if control is not None:
        text += f"; control {control:.3e}: {'outside' if control > limit else 'INSIDE'}"
    log(text)
    if not ok:
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    if control is not None and not control > limit:
        raise AssertionError(f"{label}: the control passes the gate")


def secant_gap(got: dict, want: dict) -> tuple[float, int, int]:
    """(z's gap by magnitude on the rays both hit with no coarse sample
    within LT_AMBIGUOUS of the level, the rays whose hit differs with no such
    sample, the rays compared)."""
    clear = (got["near_level"] > LT_AMBIGUOUS) & (want["near_level"] > LT_AMBIGUOUS)
    both = got["hit"] & want["hit"] & clear
    differ = int(((got["hit"] != want["hit"]) & clear).sum())
    return mag_gap(got["z"][both], want["z"][both]), differ, int(both.sum())


def long_tail_card(device, root: str) -> dict:
    """Phase 14: the modules of `e3dge_tpu/` that only the JAX tests reach,
    on the card at full width, TF32 off, f32; each against the CPU (the
    jobs of one `CpuReferences` child, started once the secant's level is
    known and read after all of the card's work) by `mag_gap`:
    a. `find_surface_secant` through the flagship renderer's query_sdf (the
    field kernel: LT_SECANT_LAUNCHES per call, its new launch shapes checked
    and timed), z and hit against the CPU's twin and the card's plain field,
    a control at 0 secant steps; `mlp_init_pass` at stage1_config with grad
    (loss, field gradient; control: the stratified grid); `forward_ddf` at
    8 x 256 (control: W+ rows shifted); b. every `set_encoder` name at the
    flagship EncoderConfig (control: e4e at stage 0); c. the align blocks
    (control: DemodulatedConv2d without demodulation); d. `calc_losses` in
    every mode on 5 seeded 256^2 pairs (control: two ground truths swapped)
    and `gallery_video` written and read back (control: no --bounce, half
    the frames). This part starts the CPU references and runs the card's
    side; `long_tail_gates` reads the references and holds each gate (main
    runs phase 13 between them, beside the references)."""
    from e3dge_torch.config import flagship_config
    from e3dge_torch.models.encoders.factory import ENCODERS
    from e3dge_torch.tools import calc_losses, gallery_video

    t_phase = time.perf_counter()
    folders = {k: write_folder(os.path.join(root, k), smooth_images(5, 256, SEED + 19 + i))
               for i, k in enumerate(("results", "gt"))}
    swapped = os.path.join(root, "gt_swapped")
    shutil.copytree(folders["gt"], swapped)
    os.replace(os.path.join(swapped, "0.png"), os.path.join(swapped, "tmp.png"))
    os.replace(os.path.join(swapped, "1.png"), os.path.join(swapped, "0.png"))
    os.replace(os.path.join(swapped, "tmp.png"), os.path.join(swapped, "1.png"))
    card = {}
    with tf32_off():
        level = lt_secant_level(device)
        refs = CpuReferences("14")
        jobs = {"secant": refs.add("lt_secant", "cpu", "twin", level), "mlp_init": refs.add("lt_mlp_init", "cpu"),
                "forward_ddf": refs.add("lt_forward_ddf", "cpu"), "encoders": refs.add("lt_encoders", "cpu"),
                "align": refs.add("lt_align", "cpu"),
                "calc_losses": refs.add("lt_calc_losses", "cpu", folders["results"], folders["gt"],
                                        os.path.join(root, "scores_cpu"))}
        refs.start()
        # a. the secant's launch shapes, then every card run of the phase
        res, n_coarse = flagship_config().renderer.out_im_res, LT_SECANT_COARSE
        shapes = {}
        for label, n in (("14a secant coarse samples", res * res * n_coarse), ("14a secant step", res * res)):
            shapes[label] = check_and_time_full(label, 1, n, False, "highest", device, sdf_only=True)
            shapes[label].update(entry="siren_field_full", precision="highest", batch=1, n=n, sdf_only=True)
        card["secant"] = {route: lt_secant(device, route, level) for route in ("kernel", "plain")}
        card["secant"]["control"] = lt_secant(device, "kernel", level, steps=0)
        if card["secant"]["kernel"]["launches"] != LT_SECANT_LAUNCHES:
            raise AssertionError(f"14a: the secant launched {card['secant']['kernel']['launches']}, expected "
                                 f"{LT_SECANT_LAUNCHES}")
        card["mlp_init"] = {"run": lt_mlp_init(device), "control": lt_mlp_init(device, offset_sampling=False)}
        card["forward_ddf"] = {"run": lt_forward_ddf(device), "control": lt_forward_ddf(device, roll_styles=True)}
        card["encoders"] = {name: lt_encoder(name, device) for name in ENCODERS}
        card["e4e stage 0"] = lt_encoder("Encoder4Editing", device, stage=0)
        torch.cuda.empty_cache()
        card["align"] = lt_align(device)
    card["calc_losses"] = lt_calc_losses(device, folders["results"], folders["gt"], os.path.join(root, "scores_card"))
    calc_losses.main(["--mode", "l2", "--data-path", folders["results"], "--gt-path", swapped, "--out",
                      os.path.join(root, "scores_swapped"), "--device", "cuda"])
    card["calc_losses control"] = json.load(open(os.path.join(root, "scores_swapped", "scores_l2.json")))
    b, v, size = LT_GALLERY
    frames = np.stack([np.stack([smooth_images(1, size, SEED + 30 + 10 * i + j)[0].transpose(2, 0, 1)
                                 for j in range(v)]) for i in range(b)]).astype(np.float32) / 127.5 - 1.0
    np.save(os.path.join(root, "frames.npy"), frames)
    videos = {}
    for name, extra in (("bounce", ["--bounce"]), ("control, no --bounce", [])):
        out = os.path.join(root, f"gallery_{len(videos)}.mp4")
        gallery_video.main(["--frames", os.path.join(root, "frames.npy"), "--cols", "2", "--fps", "8", "--out", out,
                            *extra])
        videos[name] = read_video(out)
    log(f"  [14] the card's runs: {time.perf_counter() - t_phase:.1f} s")
    return {"card": card, "refs": refs, "jobs": jobs, "level": level, "shapes": shapes, "videos": videos,
            "t": time.perf_counter() - t_phase}


def long_tail_gates(state: dict) -> dict:
    """Phase 14's gates: each of `long_tail_card`'s card results against its
    CPU reference (`run_long_tail`). Returns the launches and the shapes."""
    t_phase = time.perf_counter()
    card, refs, jobs, level = state["card"], state["refs"], state["jobs"], state["level"]
    b, v, size = LT_GALLERY

    # the gates, each against its CPU reference
    cpu, sec = refs.result(jobs["secant"]), card["secant"]
    gap, differ, n = secant_gap(sec["kernel"], cpu)
    log(f"  [14a] secant at level {level:.4e} (the card's twin's coarse 5th percentile): {int(cpu['hit'].sum())} of "
        f"{cpu['hit'].numel()} rays hit on the CPU, {int(sec['kernel']['hit'].sum())} on the card; {n} compared, "
        f"{int((cpu['near_level'] <= LT_AMBIGUOUS).sum())} with a coarse sample within {LT_AMBIGUOUS:g} of the "
        f"level left out; launches {sec['kernel']['launches']}")
    g_plain, d_plain, _ = secant_gap(sec["kernel"], sec["plain"])
    log(f"  [14a] card (kernel) vs the card's plain field: z {g_plain:.3e}, hits differing {d_plain}")
    if differ or d_plain or not n:
        raise AssertionError(f"14a: hit masks differ on {differ} / {d_plain} rays with no ambiguous sample")
    lt_gate("14a secant z", max(gap, g_plain), LT_TOL["secant z"], secant_gap(sec["control"], cpu)[0])
    want, got = refs.result(jobs["mlp_init"]), card["mlp_init"]

    def grad_of(run):
        return torch.cat([g.flatten() for g in run["grad"].values()])

    lt_gate("14a mlp_init_pass loss", mag_gap(got["run"]["loss"], want["loss"]), LT_TOL["mlp_init loss"],
            mag_gap(got["control"]["loss"], want["loss"]))
    lt_gate("14a mlp_init_pass field gradient", mag_gap(grad_of(got["run"]), grad_of(want)),
            LT_TOL["mlp_init gradient"], mag_gap(grad_of(got["control"]), grad_of(want)))
    want, got = refs.result(jobs["forward_ddf"]), card["forward_ddf"]
    lt_gate("14a forward_ddf", max(mag_gap(got["run"][k], want[k]) for k in want), LT_TOL["forward_ddf"],
            max(mag_gap(got["control"][k], want[k]) for k in want))
    want = refs.result(jobs["encoders"])
    gaps = {}
    for name, ref in want.items():
        out = card["encoders"][name]
        if any((o is None) != (r is None) for o, r in zip(out, ref)):
            raise AssertionError(f"14b {name}: the card's codes and the CPU's differ in kind")
        gaps[name] = max(mag_gap(o, r) for o, r in zip(out, ref) if r is not None)
    log("  [14b] W+ codes card vs CPU: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    lt_gate("14b encoders", max(gaps.values()), LT_TOL["encoder codes"],
            max(mag_gap(o, r) for o, r in zip(card["e4e stage 0"], want["Encoder4Editing"])))
    want, got = refs.result(jobs["align"]), card["align"]
    want.pop("DemodulatedConv2d, plain")
    control = mag_gap(got.pop("DemodulatedConv2d, plain")[0], want["DemodulatedConv2d"][0])
    gaps = {k: max(mag_gap(o, r) for o, r in zip(got[k], want[k])) for k in want}
    log("  [14c] outputs card vs CPU: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    lt_gate("14c align blocks", max(gaps.values()), LT_TOL["align outputs"], control)
    want, got = refs.result(jobs["calc_losses"]), card["calc_losses"]
    worst = {m: max(abs(got[m][k] - want[m][k]) for k in want[m]) for m in want}
    log("  [14d] calc_losses card vs CPU, largest gap per mode: "
        + ", ".join(f"{m} {v:.2e} [tol {LT_CALC_TOL[m]:g}]" for m, v in worst.items()))
    if any(not worst[m] <= LT_CALC_TOL[m] for m in worst):
        raise AssertionError("14d: calc_losses disagrees between the card and the CPU")
    control = max(abs(card["calc_losses control"][k] - want["l2"][k]) for k in want["l2"])
    lt_gate("14d calc_losses l2", worst["l2"], LT_CALC_TOL["l2"], control)
    n, shape = state["videos"]["bounce"]
    want_n, want_shape = 2 * v, (size, 2 * size, 3)
    log(f"  [14d] gallery video: {n} frames of {shape} read back [want {want_n} of {want_shape}]; control "
        f"{state['videos']['control, no --bounce'][0]} frames")
    if (n, shape) != (want_n, want_shape) or state["videos"]["control, no --bounce"][0] == want_n:
        raise AssertionError("14d: the gallery video does not read back as written, or its control passes")
    log(f"  phase 14: {state['t'] + time.perf_counter() - t_phase:.1f} s (card {state['t']:.1f} s, gates "
        f"{time.perf_counter() - t_phase:.1f} s)")
    return {"shapes": state["shapes"],
            "launches": {"long_tail_secant": sec["kernel"]["launches"]["siren_field_full"]}}


def run_long_tail(device, root: str) -> dict:
    """Phase 14 in one piece: `long_tail_card`, then `long_tail_gates`."""
    return long_tail_gates(long_tail_card(device, root))


def read_video(path: str) -> tuple[int, tuple]:
    """(frames, the first frame's shape) of a video `write_video` wrote (an
    .mp4 by OpenCV, else a .gif by Pillow)."""
    if not os.path.exists(path):
        from PIL import Image

        im = Image.open(os.path.splitext(path)[0] + ".gif")
        return im.n_frames, np.asarray(im.convert("RGB")).shape
    import cv2

    cap = cv2.VideoCapture(path)
    n, shape = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n, shape = n + 1, shape or frame.shape
    cap.release()
    return n, shape


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from e3dge_torch.ops import siren_field as sf

    device = torch.device("cuda")
    t_start = time.perf_counter()
    phase("1-3")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    path, build_log = sf.build_library()
    log(f"[2] field kernels built in {time.perf_counter() - t0:.1f} s: {path.name}")
    check_build(path, build_log)

    log(f"[3] field kernel vs its plain version on the card (at {time.perf_counter() - t_start:.1f} s)")
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

    phase("4")
    log(f"[4] image2image, flagship config on seeded weights (at {time.perf_counter() - t_start:.1f} s)")
    counts, inv_ms, bf16_img, flagship = run_flagship(device)

    phase("5")
    log(f"[5] f32 image2image, card vs CPU; bf16 vs f32 (at {time.perf_counter() - t_start:.1f} s)")
    f32_card, f32_img, f32_gate = run_card_vs_cpu(device, bf16_img)

    phase("6")
    log(f"[6] the other inference paths, flagship config (at {time.perf_counter() - t_start:.1f} s)")
    with torch.no_grad():
        paths = run_paths(device, flagship, f32_card, f32_img, bf16_img)
    paths["image2image"] = counts
    del flagship, f32_card
    torch.cuda.empty_cache()
    phase("5")
    log(f"[5] f32 image2image, card vs CPU: the CPU reference that ran beside phase 6 (at "
        f"{time.perf_counter() - t_start:.1f} s)")
    f32_gate()

    phase("7")
    log(f"[7] stage-1 training, stage1_config at full width (at {time.perf_counter() - t_start:.1f} s)")
    with tempfile.TemporaryDirectory(prefix="e3dge_eval_") as root:
        # the CPU references of phases 7, 8, 9 and 13 in one child, in the order their gates read
        # them: it runs beside phases 7 to 10 (13's rank phases 11 and 12 are CPU-bound)
        refs = CpuReferences("7-13")
        st1_gate = st1_card_vs_cpu(device, refs)
        st2_gate = st2_card_vs_cpu(device, refs=refs)
        ev_gate = eval_card_vs_cpu(device, root, refs)
        p13_gates = bf16_gates(device, refs)
        refs.start()
        st1 = run_stage1(device)
        st1_gate()

        phase("8")
        log(f"[8] stage-2.2 training, stage2_config at full width (at {time.perf_counter() - t_start:.1f} s)")
        st2 = run_stage2(device)
        st2_gate()

        phase("9")
        log(f"[9] the eval entry point, demo_view_synthesis_config at full width (at "
            f"{time.perf_counter() - t_start:.1f} s)")
        ev_kernel = eval_kernel_check(device)
        ev = run_eval(device, root)
        ev_gate()
        ev.update(run_host_videos(device, root))
    ev_shapes = [{"label": label, **r} for label, r in ev_kernel.items()]

    phase("10")
    log(f"[10] the trainer CLI with its services, --resume, and the NoW 3D eval (at {time.perf_counter() - t_start:.1f} s)")
    with tempfile.TemporaryDirectory(prefix="e3dge_train_") as root:
        log(f"  {shutil.disk_usage(root).free / 2**30:.1f} GiB free under {root} (the checkpoints take ~6 GiB)")
        # 10c first: its CPU reference runs beside 10a's and 10b's card work
        ev_shapes += [{"label": label, **r} for label, r in now_kernel_check(device).items()]
        now, now_gate = run_now(device, root)
        tr = run_trainer(device, root, st2["ms"])
        rank_ref = run_resume(device, root)
        log(f"[10c] now_scan_error, card vs CPU: the CPU reference that ran beside 10a and 10b (at "
            f"{time.perf_counter() - t_start:.1f} s)")
        now_gate()

        phase("11")
        log(f"[11] data parallelism across ranks on the one card (at {time.perf_counter() - t_start:.1f} s)")
        dp = run_dp(device, root, rank_ref)

        phase("12")
        log(f"[12] the sp (ray) axis: ray-split cycle steps on 1x2 and 2x2 worlds on the one card (at "
            f"{time.perf_counter() - t_start:.1f} s)")
        spr = run_sp(device, root, rank_ref)
        shutil.rmtree(rank_ref["work"])
    ev_shapes += [{"label": label, **r} for label, r in dp["shapes"].items()]
    ev_shapes += [{"label": label, **r} for label, r in spr["shapes"].items()]
    dp["launches"].update(spr["launches"])

    with tempfile.TemporaryDirectory(prefix="e3dge_long_tail_") as lt_root:
        phase("14")
        log(f"[14] the long tail: geometry extras, encoder variants, align blocks, offline tools; the card's "
            f"runs, whose CPU references run beside phase 13 (at {time.perf_counter() - t_start:.1f} s)")
        lt_state = long_tail_card(device, lt_root)

        phase("13")
        log(f"[13] the stage scripts' bf16 recipe and the config-selected variants (at "
            f"{time.perf_counter() - t_start:.1f} s)")
        p13 = run_bf16_and_variants(device, st1, st2, p13_gates)
        ev_shapes += [{"label": label, **r} for label, r in p13["shapes"].items()]

        phase("14")
        log(f"[14] the long tail's gates (at {time.perf_counter() - t_start:.1f} s)")
        p14 = long_tail_gates(lt_state)
    ev_shapes += [{"label": label, **r} for label, r in p14["shapes"].items()]

    def p13_launches(entry, precision):
        """Phase 13's launches of one entry in one precision, per step or
        iteration of each of its training paths and per raw-density call."""
        key = (entry, precision)
        d_bf16, e_bf16 = p13["stage2"]["split"]
        d_bn, e_bn = p13["bn"]["split"]
        return {"stage1_step_bf16": p13["stage1"]["split"].get(key, 0),
                "stage2_iteration_bf16": d_bf16.get(key, 0) + e_bf16.get(key, 0),
                "stage2_iteration_bn_netlocal": d_bn.get(key, 0) + e_bn.get(key, 0),
                "image2image_raw_density": p13["raw"]["launches"][entry] if precision == "serving" else 0}

    def trainer_launches(entry, precision):
        """Phase 10's measured launches of one entry in one precision, by
        path (the trainer and the NoW eval run f32: `highest`)."""
        key = (entry, precision)
        return {"trainer_iteration": tr["iteration"].get(key, 0), "trainer_validation": tr["validation"].get(key, 0),
                "trainer_panel": tr["panel"].get(key, 0), "eval_now_batch": now.get(key, 0)}

    def eval_launches(entry, precision):
        """Phase 9's measured launches of one entry in one precision, by path."""
        return {f"eval_{m}" if m in EVAL_LAUNCHES else m: split[(entry, precision)] for m, split in ev.items()}

    def dp_launches(entry, precision):
        """Phase 11's and 12's launches per rank of one entry in one
        precision: per iteration of the trainer's stages, per serving call."""
        return {path: per.get(f"{entry}/{precision}", 0) for path, per in dp["launches"].items()}

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
        kernels[-1]["launches_by_path"].update(trainer_launches(name, "serving"))
        kernels[-1]["launches_by_path"].update(dp_launches(name, "serving"))
        kernels[-1]["launches_by_path"].update(p13_launches(name, "serving"))
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
                             **eval_launches("siren_field_full", "highest"),
                             **trainer_launches("siren_field_full", "highest"),
                             **dp_launches("siren_field_full", "highest"),
                             **p13_launches("siren_field_full", "highest"),
                             **p14["launches"]},
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
                             **eval_launches("siren_field_tex", "highest"),
                             **trainer_launches("siren_field_tex", "highest"),
                             **dp_launches("siren_field_tex", "highest"),
                             **p13_launches("siren_field_tex", "highest"),
                             "long_tail_secant": 0},
    })
    log(f"image2image ms per inversion (flagship bf16, B=1): {inv_ms:.4f}; all phases {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(wall_table()))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def phase_only(phase: str) -> int:
    """Phases 1 and 2, the one-rank reference of 11b and 12
    (`rank_reference`) and phase 11 or 12 alone, or phases 1, 2 and 13 or
    14, for iterating on it: `python3 chip_smoke.py --phase 11` (or 12, 13,
    14; 13 without phases 7 and 8, so without their f32 figures beside its
    own)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from e3dge_torch.ops import siren_field as sf

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sf.build_library()
    # TF32 off, as phase 3 leaves it for the phases after it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if phase == "14":
        log("[14] phase 14 alone")
        with tempfile.TemporaryDirectory(prefix="e3dge_long_tail_") as root:
            out = run_long_tail(device, root)
        print(json.dumps({"phase14": out}))
        print(smi)
        return 0
    if phase == "13":
        log("[13] phase 13 alone")
        out = run_bf16_and_variants(device)
        print(json.dumps({"phase13": {"gates": out["gates"], "raw_density": out["raw"],
                                      "figures": {k: out[k]["figures"] for k in ("stage1", "stage2")}},
                          "shapes": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                                     for k, v in out["shapes"].items()}}))
        print(smi)
        return 0
    run = {"11": run_dp, "12": run_sp}[phase]
    with tempfile.TemporaryDirectory(prefix="e3dge_train_") as root:
        log("[11] the one-rank reference runs")
        ref = rank_reference(root)
        log(f"[{phase}] phase {phase} alone")
        out = run(device, root, ref)
    print(json.dumps({f"phase{phase}": {k: out[k] for k in ("launches", "gates")},
                      "shapes": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                                 for k, v in out["shapes"].items()}}))
    print(smi)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-child":
        sys.exit(rank_child(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--cpu-reference":
        sys.exit(cpu_reference_child(sys.argv[2]))
    try:
        if len(sys.argv) == 3 and sys.argv[1] == "--phase" and sys.argv[2] in ("11", "12", "13", "14"):
            sys.exit(phase_only(sys.argv[2]))
        sys.exit(main())
    finally:
        stop_children()
