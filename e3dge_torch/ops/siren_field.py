"""The FiLM-SIREN field: the hand-written Hopper kernel's wrapper, its plain
version, and the host helpers.

Counterpart of `e3dge_tpu/ops/pallas/siren_kernel.py` (`_siren_kernel`,
launched by `siren_query_fused`; host helpers `pack_siren_params` and
`film_vectors`). The kernel itself is `e3dge_torch/csrc/siren_field.cu`, built
with nvcc for sm_90a at first use into `e3dge_torch/_build/` (rebuilt when the
source's hash changes) and bound through ctypes.

Two entries, both the port of the one TPU kernel:
  * `siren_field_full` — the whole field over [B, N] points in one launch, with
    the local SFT optional and the backbone hidden `raw_h` an optional output;
  * `siren_field_tex`  — the kernel's tail (SFT, view layer, rgb) on a cached
    `raw_h`: the texture-only re-render of `render_from_backbone`.

Each takes the plain version (`siren_field_reference` /
`siren_field_tex_reference`) only for tensors on the CPU. For CUDA tensors it
launches the kernel or raises; there is no fallback.

Precision follows the field dtype: "highest" (f32 operands, f32 FMA, `sin`; io
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
KERNEL_WIDTH = 256  # the hidden width csrc/siren_field.cu is built for

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "siren_field.cu"
BUILD_DIR = _PKG / "_build"

# launches of each kernel entry; the wrappers add one per launch and nowhere else
launch_counts = {"siren_field_full": 0, "siren_field_tex": 0}

# How far the kernel may stray from its plain version on the same inputs:
# (max abs, mean abs) per precision and kind of output. "hidden" outputs are
# feat and raw_h (sines, in [-1, 1]); "head" outputs are rgb and sdf (~0.05
# under the SIREN init). highest: the same f32 math in another summation order,
# whose last-bit differences the sin(30 x) layers amplify (H100 readings: max
# 2.1e-5). serving: where another summation order flips one bf16 rounding, the
# activation moves one bf16 step (2^-8 near 1) and the next layer's FiLM gain
# (~30) amplifies it, so single hidden values stray by up to ~0.04 while their
# mean stays ~3e-4, and the heads by up to ~2e-3, mean ~2e-5 (H100 readings).
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
    for k in launch_counts:
        launch_counts[k] = 0


def io_dtype(precision: str) -> torch.dtype:
    """dtype of the kernel's weights and per-point io tensors for a precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.bfloat16 if precision == "serving" else torch.float32


# ----------------------------------------------------------------- host helpers


def pack_siren_params(params: Mapping[str, torch.Tensor], depth: int, precision: str) -> dict:
    """SirenGenerator parameters (its state_dict names: `pts_linears.{i}.weight`,
    `views_linears.weight`, `rgb_linear.weight`, ...) -> the kernel's operand
    pack. Matmul weights are transposed to input-major [in, out] (rgb stays
    [3, W]) in the precision's io dtype; biases stay f32."""
    dt = io_dtype(precision)
    p = {k: v.detach() for k, v in params.items()}
    width = p["pts_linears.0.weight"].shape[0]
    wv = p["views_linears.weight"]  # [W, W + 3]

    def w(t):
        return t.to(dt).contiguous()

    return {
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


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the field kernel")


def build_library() -> tuple[Path, str]:
    """Compile csrc/siren_field.cu for sm_90a into _build/ unless a library built
    from the same source bytes is there. Returns (library path, compiler log)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libsiren_field_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.siren_field_full.argtypes = [vp] * 18 + [i, i, i, i, vp]
        lib.siren_field_full.restype = i
        lib.siren_field_tex.argtypes = [vp] * 13 + [i, i, i, vp]
        lib.siren_field_tex.restype = i
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


def _check_pack(pack: dict, depth: int, width: int, dt: torch.dtype, device) -> None:
    f32 = torch.float32
    _check("w0t", pack["w0t"], (3, width), dt, device)
    _check("wst", pack["wst"], (depth - 1, width, width), dt, device)
    _check("bst", pack["bst"], (depth, width), f32, device)
    _check("wvht", pack["wvht"], (width, width), dt, device)
    _check("wvdt", pack["wvdt"], (3, width), dt, device)
    _check("bv", pack["bv"], (width,), f32, device)
    _check("wsig", pack["wsig"], (width,), dt, device)
    _check("wrgb", pack["wrgb"], (3, width), dt, device)
    _check("bheads", pack["bheads"], (4,), f32, device)


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
    Returns (feat [B, N, W] io dtype, rgb_sdf [B, N, 4] f32, raw_h or None)."""
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
    _check_pack(pack, depth, width, dt, device)

    feat = torch.empty(b, n, width, device=device, dtype=dt)
    rgb_sdf = torch.empty(b, n, 4, device=device, dtype=f32)
    raw_h = torch.empty(b, n, width, device=device, dtype=dt) if return_raw_h else None
    lib = _library()
    with torch.cuda.device(device):
        err = lib.siren_field_full(
            _ptr(pts), _ptr(dirs), _ptr(pack["w0t"]), _ptr(pack["wst"]), _ptr(pack["bst"]),
            _ptr(pack["wvht"]), _ptr(pack["wvdt"]), _ptr(pack["bv"]), _ptr(pack["wsig"]),
            _ptr(pack["wrgb"]), _ptr(pack["bheads"]), _ptr(gamma), _ptr(beta),
            _ptr(alpha), _ptr(lbeta), _ptr(feat), _ptr(rgb_sdf), _ptr(raw_h),
            b, n, depth, int(precision == "serving"), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"siren_field_full launch failed: CUDA error {err}")
    launch_counts["siren_field_full"] += 1
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
    Returns (feat [B, N, W] io dtype, rgb [B, N, 3] f32)."""
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
    _check("wvht", pack["wvht"], (width, width), dt, device)
    _check("wvdt", pack["wvdt"], (3, width), dt, device)
    _check("bv", pack["bv"], (width,), f32, device)
    _check("wrgb", pack["wrgb"], (3, width), dt, device)
    _check("bheads", pack["bheads"], (4,), f32, device)

    feat = torch.empty(b, n, width, device=device, dtype=dt)
    rgb = torch.empty(b, n, 3, device=device, dtype=f32)
    lib = _library()
    with torch.cuda.device(device):
        err = lib.siren_field_tex(
            _ptr(raw_h), _ptr(dirs), _ptr(pack["wvht"]), _ptr(pack["wvdt"]), _ptr(pack["bv"]),
            _ptr(pack["wrgb"]), _ptr(pack["bheads"]), _ptr(gamma_v), _ptr(beta_v),
            _ptr(alpha), _ptr(lbeta), _ptr(feat), _ptr(rgb),
            b, n, int(precision == "serving"), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"siren_field_tex launch failed: CUDA error {err}")
    launch_counts["siren_field_tex"] += 1
    return feat, rgb
