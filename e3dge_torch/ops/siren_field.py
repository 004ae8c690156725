"""The FiLM-SIREN field: the hand-written Hopper kernel's wrapper, its plain
version, and the host helpers.

Counterpart of `e3dge_tpu/ops/pallas/siren_kernel.py` (`_siren_kernel`,
launched by `siren_query_fused`; host helpers `pack_siren_params` and
`film_vectors`). The kernels are `e3dge_torch/csrc/siren_field_sm90.cu`
(`serving`: wgmma on bf16 operands) and `e3dge_torch/csrc/siren_field.cu`
(`highest`: wgmma on TF32 operands, each f32 product as three TF32 products
of pre-split hi and lo parts), both fed by a bulk-copy ring of weight stages
(`csrc/sm90_ring.cuh`), built with nvcc for sm_90a at first use into one
library in `e3dge_torch/_build/` (rebuilt when a source's hash changes) and
bound through ctypes.

Two entries, both the port of the one TPU kernel:
  * `siren_field_full` — the whole field over [B, N] points in one launch, with
    the local SFT optional and the backbone hidden `raw_h` an optional output;
  * `siren_field_tex`  — the kernel's tail (SFT, view layer, rgb) on a cached
    `raw_h`: the texture-only re-render of `render_from_backbone`.

Each takes the plain version (`siren_field_reference` /
`siren_field_tex_reference`) only for tensors on the CPU. For CUDA tensors it
launches the kernel or raises; there is no fallback.

Neither entry has a backward, as the JAX kernel has none (the JAX renderer
takes it only when not training and differentiates its XLA network). So on any
device each entry refuses, before it runs, an operand that requires grad while
grad mode is on: a caller that needs gradients evaluates the eager twin
(`models/siren.py`), which is the renderer's rule (`VolumeFeatureRenderer._field`).

Precision follows the field dtype: "highest" (f32 operands and accumulation,
the 256x256 products as 3xTF32 split products to f32 accuracy, `sin`; io
tensors f32) for `field_dtype="float32"`, "serving" (bf16-rounded matmul
operands, f32 accumulation, `fast_sin`; raw_h/alpha/lbeta/feat in bf16) for
`field_dtype="bfloat16"`.

Two notes carried over from the JAX kernel's tests (`tests/test_pallas_siren.py`),
whose comments disagree with the code they test: the JAX kernel's default
precision is "highest" (`siren_kernel.py:185`), not "high"; and the sdf head
reads the UNMODULATED backbone h — the SFT modulates the texture branch only
(`siren_kernel.py:98-101`). Both hold here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Mapping

import torch

from e3dge_torch.ops.fast_math import fast_sin

PRECISIONS = ("highest", "serving")
KERNEL_WIDTH = 256  # the hidden width the kernels are built for
# The serving kernel's weight stages: 256 outputs x 64 inputs of bf16 (one
# 128-byte row per output), 32 KB, in the 128-byte swizzle wgmma reads.
STAGE_K = 64
SWIZZLE_CHUNKS = 8  # 16-byte chunks of a 128-byte row
# The highest kernel's weight stages, 32 KB each in the same swizzle, one
# 128-byte row (32 f32 bit patterns) per output: per layer, W/16 stages whose
# rows hold 16 inputs' TF32 hi parts then their lo parts (the pass of small
# products), then W/32 stages whose rows hold 32 inputs' hi parts (the pass of
# big products). Within each block of 8 inputs a row holds input TF32_PERM[k]
# at place k: the wgmma A fragment of a thread (logical k = q, q+4) then reads
# the columns 2q, 2q+1 its accumulator holds.
TF32_STAGE_K = 16
TF32_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_layer_stages(width: int) -> int:
    """Ring stages per layer of the highest kernel at a width."""
    return width // TF32_STAGE_K + width // (2 * TF32_STAGE_K)

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "siren_field_sm90.cu", _PKG / "csrc" / "siren_field.cu")
HEADERS = (_PKG / "csrc" / "sm90_ring.cuh",)  # included by both sources
BUILD_DIR = _PKG / "_build"

# launches of each kernel entry; the wrappers add one per launch and nowhere else
launch_counts = {"siren_field_full": 0, "siren_field_tex": 0}
# the same launches split by precision, added to on the same two lines
precision_launch_counts = {(entry, p): 0 for entry in launch_counts for p in ("serving", "highest")}

# How far the kernel may stray from its plain version on the same inputs:
# (max abs, mean abs) per precision and kind of output. "hidden" outputs are
# feat and raw_h (sines, in [-1, 1]); "head" outputs are rgb and sdf (~0.05
# under the SIREN init). highest: f32-level products (three TF32 products per
# f32 product) summed in another order by the tensor cores' accumulator,
# whose last-bit differences the sin(30 x) layers amplify (H100 readings: max
# 3.8e-5 hidden, 1.3e-6 head, at B=4 x 98,304 points). serving: where another
# summation order flips one bf16 rounding, the activation moves one bf16 step
# (2^-8 near 1) and the next layer's FiLM gain (~30) amplifies it, so single
# hidden values stray by up to ~0.04 while their mean stays ~3e-4, and the
# heads by up to ~2e-3, mean ~2e-5 (H100 readings).
# Each limit sits well above its readings and well below what a wrong or
# zeroed output gives (a zeroed head: mean ~0.04; a zeroed hidden: ~0.6).
KERNEL_TOLERANCE = {
    "highest": {"hidden": (1e-4, 1e-4), "head": (1e-4, 1e-4)},
    "serving": {"hidden": (0.1, 1e-3), "head": (5e-3, 2e-4)},
}


def kernel_errors(got: torch.Tensor, want: torch.Tensor, kind: str, precision: str) -> tuple[float, float, bool]:
    """(max abs, mean abs, within KERNEL_TOLERANCE) of a kernel output against
    the plain version's; a non-finite error is never within."""
    d = (got.float() - want.float()).abs()
    mx, mean = float(d.max()), float(d.mean())
    tol_max, tol_mean = KERNEL_TOLERANCE[precision][kind]
    return mx, mean, mx <= tol_max and mean <= tol_mean


def reset_launch_counts() -> None:
    for counts in (launch_counts, precision_launch_counts):
        for k in counts:
            counts[k] = 0


def io_dtype(precision: str) -> torch.dtype:
    """dtype of the kernel's weights and per-point io tensors for a precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.bfloat16 if precision == "serving" else torch.float32


# ----------------------------------------------------------------- host helpers


def _swizzle128(rows: torch.Tensor) -> torch.Tensor:
    """[out, stages, 128-byte row] -> [stages, out, row] with, within row n,
    the 16-byte chunk c at chunk c ^ (n % 8): the 128-byte swizzle, K-major."""
    n, nst, per_row = rows.shape
    x = rows.reshape(n, nst, SWIZZLE_CHUNKS, -1).transpose(0, 1)
    place = torch.arange(n, device=rows.device)[:, None] % SWIZZLE_CHUNKS
    src = torch.arange(SWIZZLE_CHUNKS, device=rows.device)[None, :] ^ place  # chunk stored at each place
    x = x.gather(2, src[None, :, :, None].expand(x.shape))
    return x.reshape(nst, n, per_row).contiguous()


def sw128_stages(weight: torch.Tensor) -> torch.Tensor:
    """An nn.Linear weight [out, in] -> its wgmma B-operand stages [in/64, out,
    64] in bf16: stage s holds inputs 64s .. 64s+63, one 128-byte row per
    output (K-major), in the 128-byte swizzle (`_swizzle128`). Each stage is
    one contiguous 32 KB (for out = 256) bulk copy into shared memory."""
    n, k = weight.shape
    if k % STAGE_K:
        raise ValueError(f"input width {k} is not a multiple of {STAGE_K}")
    return _swizzle128(weight.detach().to(torch.bfloat16).reshape(n, k // STAGE_K, STAGE_K))


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits; ties away from zero),
    as f32 with the low 13 bits zero: `cvt.rna.tf32.f32` for finite x."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = rna(x), lo = rna(x - hi): hi + lo carries x to
    ~2^-22 relative, and hi.hi + lo.hi + hi.lo is an f32-level product."""
    hi = rna_tf32(x)
    return hi, rna_tf32(x.float() - hi)


def tf32_stages(weight: torch.Tensor) -> torch.Tensor:
    """An nn.Linear weight [out, in] -> the highest kernel's B-operand stages
    [in/16 + in/32, out, 32] of f32 bit patterns (`tf32_split` parts, each
    8-input block in TF32_PERM order), one 128-byte row per output in the
    128-byte swizzle (`_swizzle128`): stage s < in/16 holds the hi parts of
    inputs 16s .. 16s+15 then their lo parts; stage in/16 + t the hi parts of
    inputs 32t .. 32t+31. Each stage is one 32 KB (for out = 256) bulk copy."""
    n, k = weight.shape
    if k % (2 * TF32_STAGE_K):
        raise ValueError(f"input width {k} is not a multiple of {2 * TF32_STAGE_K}")
    perm = torch.tensor(TF32_PERM, device=weight.device)
    hi, lo = tf32_split(weight.detach().float().reshape(n, k // 8, 8)[:, :, perm].reshape(n, k))
    small = torch.cat([hi.reshape(n, -1, TF32_STAGE_K), lo.reshape(n, -1, TF32_STAGE_K)], dim=2)
    return torch.cat([_swizzle128(small), _swizzle128(hi.reshape(n, -1, 2 * TF32_STAGE_K))])


def pack_siren_params(params: Mapping[str, torch.Tensor], depth: int, precision: str) -> dict:
    """SirenGenerator parameters (its state_dict names: `pts_linears.{i}.weight`,
    `views_linears.weight`, `rgb_linear.weight`, ...) -> the kernels' operand
    pack. Matmul weights are transposed to input-major [in, out] (rgb stays
    [3, W]) in the precision's io dtype, which the plain version reads;
    biases stay f32. Where the width allows, the pack
    also holds the kernel's weight stages: `wring` for layers 1..D-1 and
    `wvring` for the view layer's h part; in `serving` bf16 `sw128_stages`
    ([D-1, W/64, W, 64], [W/64, W, 64]), in `highest` f32 `tf32_stages`
    ([D-1, S, W, 32], [S, W, 32], S = `tf32_layer_stages(W)`)."""
    dt = io_dtype(precision)
    p = {k: v.detach() for k, v in params.items()}
    width = p["pts_linears.0.weight"].shape[0]
    wv = p["views_linears.weight"]  # [W, W + 3]

    def w(t):
        return t.to(dt).contiguous()

    pack = {
        "w0t": w(p["pts_linears.0.weight"].t()),                                   # [3, W]
        "wst": w(torch.stack([p[f"pts_linears.{i}.weight"].t() for i in range(1, depth)])),
        "bst": torch.stack([p[f"pts_linears.{i}.bias"] for i in range(depth)]).float().contiguous(),
        "wvht": w(wv[:, :width].t()),                                              # [W, W]
        "wvdt": w(wv[:, width:].t()),                                              # [3, W]
        "bv": p["views_linears.bias"].float().contiguous(),
        "wsig": w(p["sigma_linear.weight"][0]),                                    # [W]
        "wrgb": w(p["rgb_linear.weight"]),                                         # [3, W]
        "bheads": torch.cat([p["rgb_linear.bias"], p["sigma_linear.bias"]]).float().contiguous(),
    }
    stages, k = (sw128_stages, STAGE_K) if precision == "serving" else (tf32_stages, 2 * TF32_STAGE_K)
    if width % k == 0:
        pack["wring"] = torch.stack([stages(p[f"pts_linears.{i}.weight"]) for i in range(1, depth)])
        pack["wvring"] = stages(wv[:, :width])
    return pack


def film_vectors(
    params: Mapping[str, torch.Tensor], styles: torch.Tensor, depth: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-layer FiLM frequency / phase from W+ styles, in f32, outside the kernel.

    styles: [B, D+1, style_dim] (row i drives layer i, the last row the view
    layer) or [B, style_dim] broadcast. Returns gamma, beta each [B, D+1, W]:
    gamma = 15 * (s W_g^T + b_g) + 30, beta = 0.25 * (s W_b^T + b_b)."""
    s_all = styles.float()
    names = [f"pts_linears.{i}" for i in range(depth)] + ["views_linears"]
    gammas, betas = [], []
    for i, name in enumerate(names):
        s = s_all[:, min(i, s_all.shape[1] - 1)] if s_all.ndim == 3 else s_all
        g = s @ params[f"{name}.gamma.weight"].float().t() + params[f"{name}.gamma.bias"].float()
        b = s @ params[f"{name}.beta.weight"].float().t() + params[f"{name}.beta.bias"].float()
        gammas.append(15.0 * g + 30.0)
        betas.append(0.25 * b)
    return torch.stack(gammas, 1).contiguous(), torch.stack(betas, 1).contiguous()


# -------------------------------------------------------------- plain version


def _mm(a: torch.Tensor, w: torch.Tensor, serving: bool) -> torch.Tensor:
    """a [..., K] f32 @ w [K, M]: bf16-rounded operands with f32 accumulation in
    serving (products of bf16 values are exact in f32), plain f32 otherwise."""
    if serving:
        a = a.to(torch.bfloat16).float()
    return a @ w.float()


def _act(x: torch.Tensor, serving: bool) -> torch.Tensor:
    """FiLM activation, rounded to the io precision as the kernel stores it."""
    return fast_sin(x).to(torch.bfloat16).float() if serving else torch.sin(x)


def _tex_reference(h, dirs, pack, gamma_v, beta_v, alpha, lbeta, serving):
    if alpha is not None:
        h = (alpha.float() + 1.0) * h + lbeta.float()
    zv = _mm(h, pack["wvht"], serving) + _mm(dirs.float(), pack["wvdt"], serving) + pack["bv"]
    feat = _act(gamma_v[:, None] * zv + beta_v[:, None], serving)
    rgb = _mm(feat, pack["wrgb"].t(), serving) + pack["bheads"][:3]
    return feat, rgb


def siren_field_reference(
    pts: torch.Tensor,
    dirs: torch.Tensor,
    pack: dict,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    alpha: torch.Tensor | None = None,
    lbeta: torch.Tensor | None = None,
    *,
    precision: str = "highest",
    return_raw_h: bool = False,
):
    """Plain PyTorch version of `siren_field_full`, the same arithmetic in the
    same places. Returns (feat [B, N, W], rgb_sdf [B, N, 4] f32, raw_h or None);
    feat/raw_h in the precision's io dtype."""
    serving = precision == "serving"
    dt = io_dtype(precision)
    depth = pack["bst"].shape[0]
    h = _act(gamma[:, 0:1] * (_mm(pts.float(), pack["w0t"], serving) + pack["bst"][0]) + beta[:, 0:1], serving)
    for i in range(1, depth):
        z = _mm(h, pack["wst"][i - 1], serving) + pack["bst"][i]
        h = _act(gamma[:, i : i + 1] * z + beta[:, i : i + 1], serving)
    sdf = _mm(h, pack["wsig"][:, None], serving) + pack["bheads"][3]
    feat, rgb = _tex_reference(h, dirs, pack, gamma[:, depth], beta[:, depth], alpha, lbeta, serving)
    raw_h = h.to(dt) if return_raw_h else None
    return feat.to(dt), torch.cat([rgb, sdf], dim=-1), raw_h


def siren_field_tex_reference(
    raw_h: torch.Tensor,
    dirs: torch.Tensor,
    pack: dict,
    gamma_v: torch.Tensor,
    beta_v: torch.Tensor,
    alpha: torch.Tensor | None = None,
    lbeta: torch.Tensor | None = None,
    *,
    precision: str = "highest",
):
    """Plain PyTorch version of `siren_field_tex`. Returns (feat [B, N, W] in the
    io dtype, rgb [B, N, 3] f32)."""
    serving = precision == "serving"
    feat, rgb = _tex_reference(raw_h.float(), dirs, pack, gamma_v, beta_v, alpha, lbeta, serving)
    return feat.to(io_dtype(precision)), rgb


# ----------------------------------------------------------------- the kernel


_lib = None


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the field kernel")


def build_library() -> tuple[Path, str]:
    """Compile csrc/*.cu for sm_90a into one library in _build/ unless one built
    from the same source and header bytes is there: one nvcc per source, all
    started together, then a link. Returns (library path, compiler log)."""
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in (*SOURCES, *HEADERS))).hexdigest()[:16]
    lib = BUILD_DIR / f"libsiren_field_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    if any(proc.returncode for proc in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *flags, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, log


def _library():
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr, n_int in (("siren_field_full", 18, 3), ("siren_field_tex", 13, 2),
                                   ("siren_field_full_sm90", 18, 3), ("siren_field_tex_sm90", 13, 2)):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * n_ptr + [i] * n_int + [vp]
            fn.restype = i
        _lib = lib
    return _lib


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:  # 16-byte vector loads and bulk copies
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_pack(pack: dict, depth: int, width: int, precision: str, device, tex: bool = False) -> None:
    """The pack entries the precision's kernel reads (`tex`: the texture entry's)."""
    f32, dt = torch.float32, io_dtype(precision)
    stage = (width // STAGE_K, width, STAGE_K) if precision == "serving" else \
        (tf32_layer_stages(width), width, 2 * TF32_STAGE_K)
    _check("wvring", pack["wvring"], stage, dt, device)
    _check("wvdt", pack["wvdt"], (3, width), dt, device)
    _check("bv", pack["bv"], (width,), f32, device)
    _check("wrgb", pack["wrgb"], (3, width), dt, device)
    _check("bheads", pack["bheads"], (4,), f32, device)
    if tex:
        return
    _check("w0t", pack["w0t"], (3, width), dt, device)
    _check("bst", pack["bst"], (depth, width), f32, device)
    _check("wsig", pack["wsig"], (width,), dt, device)
    _check("wring", pack["wring"], (depth - 1, *stage), dt, device)


def _refuse_grad(entry: str, tensors, pack: dict) -> None:
    """Raise if grad mode is on and an operand (a pack tensor included)
    requires grad: the kernel has no backward, so its outputs would be cut off
    from the graph without a word."""
    if not torch.is_grad_enabled():
        return
    named = [*tensors, *pack.items()]
    hit = [name for name, t in named if isinstance(t, torch.Tensor) and t.requires_grad]
    if hit:
        raise RuntimeError(
            f"{entry} has no backward (the JAX kernel has none), but {', '.join(hit)} require grad: "
            "run it under torch.no_grad() or evaluate the differentiable twin (models/siren.py)"
        )


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the field kernel takes CPU or CUDA tensors, got {t.device}")
    return t.device


def siren_field_full(
    pts: torch.Tensor,
    dirs: torch.Tensor,
    pack: dict,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    alpha: torch.Tensor | None = None,
    lbeta: torch.Tensor | None = None,
    *,
    precision: str = "highest",
    return_raw_h: bool = False,
):
    """The whole field for pts/dirs [B, N, 3] f32 with FiLM vectors gamma/beta
    [B, D+1, W] f32 and optional SFT alpha/lbeta [B, N, W] (io dtype).
    Returns (feat [B, N, W] io dtype, rgb_sdf [B, N, 4] f32, raw_h or None).
    Raises on an operand that requires grad under grad mode (no backward)."""
    _refuse_grad("siren_field_full", (("pts", pts), ("dirs", dirs), ("gamma", gamma), ("beta", beta),
                                      ("alpha", alpha), ("lbeta", lbeta)), pack)
    if pts.device.type == "cpu":
        return siren_field_reference(
            pts, dirs, pack, gamma, beta, alpha, lbeta, precision=precision, return_raw_h=return_raw_h
        )
    device = _cuda_device(pts)
    dt = io_dtype(precision)
    b, n, _ = pts.shape
    depth, width = pack["bst"].shape
    if width != KERNEL_WIDTH:
        raise ValueError(f"the field kernel is built for width {KERNEL_WIDTH}, got {width}")
    if depth < 1 or n < 1 or b > 65535:
        raise ValueError(f"unsupported field shape: depth={depth}, B={b}, N={n}")
    if (alpha is None) != (lbeta is None):
        raise ValueError("alpha and lbeta go together")
    f32 = torch.float32
    _check("pts", pts, (b, n, 3), f32, device)
    _check("dirs", dirs, (b, n, 3), f32, device)
    _check("gamma", gamma, (b, depth + 1, width), f32, device)
    _check("beta", beta, (b, depth + 1, width), f32, device)
    if alpha is not None:
        _check("alpha", alpha, (b, n, width), dt, device)
        _check("lbeta", lbeta, (b, n, width), dt, device)
    _check_pack(pack, depth, width, precision, device)

    feat = torch.empty(b, n, width, device=device, dtype=dt)
    rgb_sdf = torch.empty(b, n, 4, device=device, dtype=f32)
    raw_h = torch.empty(b, n, width, device=device, dtype=dt) if return_raw_h else None
    lib = _library()
    fn = lib.siren_field_full_sm90 if precision == "serving" else lib.siren_field_full
    with torch.cuda.device(device):
        err = fn(
            _ptr(pts), _ptr(dirs), _ptr(pack["w0t"]), _ptr(pack["wring"]), _ptr(pack["bst"]),
            _ptr(pack["wvring"]), _ptr(pack["wvdt"]), _ptr(pack["bv"]), _ptr(pack["wsig"]),
            _ptr(pack["wrgb"]), _ptr(pack["bheads"]), _ptr(gamma), _ptr(beta),
            _ptr(alpha), _ptr(lbeta), _ptr(feat), _ptr(rgb_sdf), _ptr(raw_h),
            b, n, depth, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"siren_field_full launch failed: CUDA error {err}")
    launch_counts["siren_field_full"] += 1
    precision_launch_counts[("siren_field_full", precision)] += 1
    return feat, rgb_sdf, raw_h


def siren_field_tex(
    raw_h: torch.Tensor,
    dirs: torch.Tensor,
    pack: dict,
    gamma_v: torch.Tensor,
    beta_v: torch.Tensor,
    alpha: torch.Tensor | None = None,
    lbeta: torch.Tensor | None = None,
    *,
    precision: str = "highest",
):
    """SFT + view layer + rgb head on a cached backbone hidden raw_h [B, N, W]
    (io dtype), with the view layer's FiLM vectors gamma_v/beta_v [B, W] f32.
    Returns (feat [B, N, W] io dtype, rgb [B, N, 3] f32). Raises on an operand
    that requires grad under grad mode (no backward)."""
    _refuse_grad("siren_field_tex", (("raw_h", raw_h), ("dirs", dirs), ("gamma_v", gamma_v),
                                     ("beta_v", beta_v), ("alpha", alpha), ("lbeta", lbeta)), pack)
    if raw_h.device.type == "cpu":
        return siren_field_tex_reference(
            raw_h, dirs, pack, gamma_v, beta_v, alpha, lbeta, precision=precision
        )
    device = _cuda_device(raw_h)
    dt = io_dtype(precision)
    b, n, width = raw_h.shape
    if width != KERNEL_WIDTH:
        raise ValueError(f"the field kernel is built for width {KERNEL_WIDTH}, got {width}")
    if n < 1 or b > 65535:
        raise ValueError(f"unsupported field shape: B={b}, N={n}")
    if (alpha is None) != (lbeta is None):
        raise ValueError("alpha and lbeta go together")
    f32 = torch.float32
    _check("raw_h", raw_h, (b, n, width), dt, device)
    _check("dirs", dirs, (b, n, 3), f32, device)
    _check("gamma_v", gamma_v, (b, width), f32, device)
    _check("beta_v", beta_v, (b, width), f32, device)
    if alpha is not None:
        _check("alpha", alpha, (b, n, width), dt, device)
        _check("lbeta", lbeta, (b, n, width), dt, device)
    _check_pack(pack, 0, width, precision, device, tex=True)

    feat = torch.empty(b, n, width, device=device, dtype=dt)
    rgb = torch.empty(b, n, 3, device=device, dtype=f32)
    lib = _library()
    fn = lib.siren_field_tex_sm90 if precision == "serving" else lib.siren_field_tex
    with torch.cuda.device(device):
        err = fn(
            _ptr(raw_h), _ptr(dirs), _ptr(pack["wvring"]), _ptr(pack["wvdt"]),
            _ptr(pack["bv"]), _ptr(pack["wrgb"]), _ptr(pack["bheads"]), _ptr(gamma_v), _ptr(beta_v),
            _ptr(alpha), _ptr(lbeta), _ptr(feat), _ptr(rgb),
            b, n, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"siren_field_tex launch failed: CUDA error {err}")
    launch_counts["siren_field_tex"] += 1
    precision_launch_counts[("siren_field_tex", precision)] += 1
    return feat, rgb
