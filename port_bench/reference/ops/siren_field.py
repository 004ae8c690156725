"""The FiLM-SIREN field in plain PyTorch: a frozen copy of the plain
version in `e3dge_torch/ops/siren_field.py` (`siren_field_reference`,
`siren_field_tex_reference`, `pack_siren_params`, `film_vectors`).

`siren_field_full` and `siren_field_tex` keep the port's signatures and its
refusal of a grad-requiring operand (the renderer routes those to the eager
twin), but always evaluate the plain version, on any device: the reference
launches no kernel. The pack holds no kernel weight stages.
"""

from __future__ import annotations

from typing import Mapping

import torch

from port_bench.reference.ops.fast_math import fast_sin

PRECISIONS = ("highest", "serving")


def io_dtype(precision: str) -> torch.dtype:
    """dtype of the kernel's weights and per-point io tensors for a precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.bfloat16 if precision == "serving" else torch.float32


def pack_siren_params(params: Mapping[str, torch.Tensor], depth: int, precision: str) -> dict:
    """SirenGenerator parameters (its state_dict names: `pts_linears.{i}.weight`,
    `views_linears.weight`, `rgb_linear.weight`, ...) -> the kernels' operand
    pack. Matmul weights are transposed to input-major [in, out] (rgb stays
    [3, W]) in the precision's io dtype, which the plain version reads;
    biases stay f32."""
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


def _refuse_grad(entry: str, tensors, pack: dict) -> None:
    """Raise if grad mode is on and an operand requires grad, as the port's
    entries do (they have no backward)."""
    if not torch.is_grad_enabled():
        return
    named = [*tensors, *pack.items()]
    hit = [name for name, t in named if isinstance(t, torch.Tensor) and t.requires_grad]
    if hit:
        raise RuntimeError(f"{entry} has no backward, but {', '.join(hit)} require grad")


def siren_field_full(pts, dirs, pack, gamma, beta, alpha=None, lbeta=None, *, precision="highest",
                     return_raw_h=False):
    """`siren_field_reference` on any device, behind the port's grad refusal."""
    _refuse_grad("siren_field_full", (("pts", pts), ("dirs", dirs), ("gamma", gamma), ("beta", beta),
                                      ("alpha", alpha), ("lbeta", lbeta)), pack)
    return siren_field_reference(pts, dirs, pack, gamma, beta, alpha, lbeta, precision=precision,
                                 return_raw_h=return_raw_h)


def siren_field_tex(raw_h, dirs, pack, gamma_v, beta_v, alpha=None, lbeta=None, *, precision="highest"):
    """`siren_field_tex_reference` on any device, behind the port's grad refusal."""
    _refuse_grad("siren_field_tex", (("raw_h", raw_h), ("dirs", dirs), ("gamma_v", gamma_v),
                                     ("beta_v", beta_v), ("alpha", alpha), ("lbeta", lbeta)), pack)
    return siren_field_tex_reference(raw_h, dirs, pack, gamma_v, beta_v, alpha, lbeta, precision=precision)
