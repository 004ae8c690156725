"""Losses and metrics — counterpart of `e3dge_tpu/training/losses.py`
(reference `project/losses/`): 2D reconstruction (MSE, LPIPS, ArcFace ID; MAE,
PSNR, SSIM metrics), 3D shape supervision, GAN losses and regularisers.
Images are NCHW; the reference conventions of the printed metrics are kept
(`ssim_ref`, `mae_ref`) beside the standard forms."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------- primitives


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def mse(a, b):
    return torch.mean((a - b) ** 2)


def smooth_l1(pred, target, beta: float = 1.0):
    """torch F.smooth_l1_loss written out as the JAX function (criterion3d_rec)."""
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def psnr(pred, target, max_val: float = 1.0):
    """kornia.metrics.psnr; inputs in [0, 1]."""
    m = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(m, min=1e-12))


def _gaussian_kernel(window: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(window, device=device, dtype=torch.float32) - window // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def _ssim_map(pred, target, max_val: float, window: int, padding: str):
    """SSIM map over NCHW batches with gaussian (sigma 1.5) local statistics:
    "valid" is the standard form, "same" reflect-pads first (kornia's border)."""
    c = pred.shape[1]
    k = _gaussian_kernel(window, 1.5, pred.device).expand(c, 1, window, window)
    if padding == "same":
        p = window // 2
        pred = F.pad(pred, (p, p, p, p), mode="reflect")
        target = F.pad(target, (p, p, p, p), mode="reflect")

    def filt(x):
        return F.conv2d(x, k, groups=c)

    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu_p, mu_t = filt(pred), filt(target)
    mu_p2, mu_t2, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    s_p = filt(pred * pred) - mu_p2
    s_t = filt(target * target) - mu_t2
    s_pt = filt(pred * target) - mu_pt
    return (2 * mu_pt + c1) * (2 * s_pt + c2) / ((mu_p2 + mu_t2 + c1) * (s_p + s_t + c2))


def ssim(pred, target, max_val: float = 1.0, window: int = 11, per_sample: bool = False):
    """Standard mean SSIM (11 x 1.5 gaussian, valid padding) on [0, 1] inputs."""
    m = _ssim_map(pred, target, max_val, window, "valid")
    return m.mean(dim=(1, 2, 3)) if per_sample else m.mean()


def ssim_ref(pred, target, window: int = 5, per_sample: bool = False):
    """The reference's printed "SSIM": 1 - kornia.losses.ssim_loss(pred, gt, 5)
    on RAW [-1, 1] tensors, i.e. mean((1 + ssim_map) / 2) with a window-5
    gaussian and reflect padding (builder.py:171,182)."""
    half = (1.0 + _ssim_map(pred, target, 1.0, window, "same")) / 2.0
    return half.mean(dim=(1, 2, 3)) if per_sample else half.mean()


def mae_ref(pred, target, per_sample: bool = False):
    """The reference's printed "mae": L1 on RAW [-1, 1] tensors (builder.py:179)."""
    if per_sample:
        return torch.abs(pred - target).mean(dim=(1, 2, 3))
    return l1(pred, target)


# --------------------------------------------------------------- GAN losses


def d_logistic_loss(real_pred, fake_pred):
    """softplus(-real) + softplus(fake) (gan_loss.py)."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    return F.softplus(-fake_pred).mean()


def d_r1_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor], real_imgs: torch.Tensor) -> torch.Tensor:
    """R1 gradient penalty E[||grad_x D(x)||^2] on reals; the graph is kept so
    the penalty trains D."""
    with torch.enable_grad():
        x = real_imgs.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(d_fn(x).sum(), x, create_graph=True)
    return (grad**2).sum() / real_imgs.shape[0]


def hit_prob_consistency_loss(hit_prob_pred, hit_prob_gt):
    """BCE against detached reference hit probabilities (ConsistencyLoss,
    losses/geometry_loss.py:21-53)."""
    p0, p1 = hit_prob_gt.detach(), hit_prob_pred
    bce = -p0 * torch.log(p1 + 1e-5) - (1.0 - p0) * torch.log(1.0 - p1 + 1e-5)
    return bce.mean(dim=-2).mean()


def depth_consistency_loss(depth_pred, depth_gt, beta: float = 0.05):
    """Smooth-L1 depth consistency (DepthLoss, geometry_loss.py:57-80)."""
    return smooth_l1(depth_pred, depth_gt.detach(), beta=beta)


# ------------------------------------------------------- composite criteria


def calc_2d_rec_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    lambdas: dict[str, float],
    lpips_fn: Callable | None = None,
    id_fn: Callable | None = None,
    gt_for_id: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """MSE + LPIPS + ID loss with MAE/PSNR/SSIM metrics (builder.py:130-186),
    images in [-1, 1]. lpips_fn(pred, gt) -> scalar; id_fn(pred, gt) -> (loss,
    sim). The metrics are reported, not optimised (detached)."""
    loss_dict = {}
    l2 = mse(pred, gt)
    loss = lambdas.get("l2_lambda", 1.0) * l2
    loss_dict["loss_l2"] = l2
    if lpips_fn is not None and lambdas.get("lpips_lambda", 0.0) > 0:
        lp = lpips_fn(pred, gt)
        loss = loss + lambdas["lpips_lambda"] * lp
        loss_dict["loss_lpips"] = lp
    if id_fn is not None and lambdas.get("id_lambda", 0.0) > 0:
        id_loss, id_sim = id_fn(pred, gt_for_id if gt_for_id is not None else gt)
        loss = loss + lambdas["id_lambda"] * id_loss
        loss_dict["loss_id"] = id_loss
        loss_dict["id_sim"] = id_sim
    with torch.no_grad():
        pred01, gt01 = (pred + 1.0) / 2.0, (gt + 1.0) / 2.0
        loss_dict["mae"] = mae_ref(pred, gt)
        loss_dict["mae_std"] = l1(pred01, gt01)
        loss_dict["psnr"] = psnr(pred01, gt01)
        loss_dict["ssim"] = ssim_ref(pred, gt)
        loss_dict["ssim_std"] = ssim(pred01, gt01)
    loss_dict["loss_2d"] = loss
    return loss, loss_dict

