"""3D evaluation metrics of the port; counterpart of
`e3dge_tpu/training/eval3d.py` (reference NoW / DECA eval, trainer.py:
2103-2208): the point-set and depth-map metrics in torch, and the NoW
point-to-scan score, the self-contained equivalent of the official
now_evaluation step the reference defers to (trainer.py:2205-2207).

The score similarity-aligns the predicted mesh to the scan (Umeyama on the 7
landmarks when both sides have them, else ICP from a centroid and RMS-scale
start), crops the scan around the face, and measures each scan point's
distance to the mesh: its nearest vertex (torch, chunked pairwise on
`device`), refined by the exact point-to-triangle distance over that
vertex's incident faces (numpy, f64). Alignment is f64 numpy as in the JAX
package; the nearest-vertex searches are f32.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from e3dge_torch.utils.device import resolve_device

# ICP: Umeyama steps, and source points sampled (targets: 4x as many)
ICP_ITERS, ICP_SAMPLE = 30, 4096
# the face region of the scan kept for the score, in scan units (mm for NoW)
CROP_RADIUS = 100.0


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer of [Na, 3] and [Nb, 3] point sets (squared distances)."""
    d2 = ((a[:, None] - b[None]) ** 2).sum(-1)
    return d2.min(dim=1).values.mean() + d2.min(dim=0).values.mean()


def batched_chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x [B, M, 3] -> [B] chamfer distances."""
    d2 = ((a[:, :, None] - b[:, None]) ** 2).sum(-1)
    return d2.min(dim=2).values.mean(dim=1) + d2.min(dim=1).values.mean(dim=1)


def depth_error(pred_depth: torch.Tensor, gt_depth: torch.Tensor, mask: torch.Tensor | None = None) -> dict:
    """Masked L1 and RMSE between depth maps of matching shapes."""
    diff = pred_depth - gt_depth
    if mask is None:
        return {"depth_l1": diff.abs().mean(), "depth_rmse": torch.sqrt((diff**2).mean())}
    denom = torch.clamp(mask.sum(), min=1.0)
    return {"depth_l1": (diff.abs() * mask).sum() / denom, "depth_rmse": torch.sqrt((diff**2 * mask).sum() / denom)}


def normal_consistency(pred_normals: torch.Tensor, gt_normals: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cosine similarity of normal maps [..., 3], masked if given."""

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)

    cos = (unit(pred_normals) * unit(gt_normals)).sum(-1)
    if mask is None:
        return cos.mean()
    m = mask.reshape(cos.shape)
    return (cos * m).sum() / torch.clamp(m.sum(), min=1.0)


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform of [N, 3] correspondences src ->
    dst (Umeyama 1991), f64: (s, R [3, 3], t [3]) with dst ~ s * src @ R.T + t."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src))) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def _nearest_vertex_dist(points: torch.Tensor, verts: torch.Tensor, chunk: int = 2048):
    """([Np] distances, [Np] indices) of each point's nearest vertex, in
    chunks of `chunk` points on the tensors' device."""
    d2, idx = [], []
    for p in points.split(chunk):
        d = ((p[:, None] - verts[None]) ** 2).sum(-1)  # [chunk, Nv]
        m = d.min(dim=1)
        d2.append(m.values)
        idx.append(m.indices)
    return torch.sqrt(torch.cat(d2)), torch.cat(idx)


def _point_triangle_dist(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Exact distances from points [N, 3] to their candidate triangles [N, K,
    3, 3], the least over K (Ericson 5.1.5: barycentric clamping region by
    region), f64 numpy."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac = b - a, c - a
    ap, bp, cp = p[:, None] - a, p[:, None] - b, p[:, None] - c
    d1 = np.einsum("nkd,nkd->nk", ab, ap)
    d2 = np.einsum("nkd,nkd->nk", ac, ap)
    d3 = np.einsum("nkd,nkd->nk", ab, bp)
    d4 = np.einsum("nkd,nkd->nk", ac, bp)
    d5 = np.einsum("nkd,nkd->nk", ab, cp)
    d6 = np.einsum("nkd,nkd->nk", ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-30)
    v = np.clip(vb / denom, 0.0, 1.0)
    w = np.clip(vc / denom, 0.0, 1.0)
    closest = a + v[..., None] * ab + w[..., None] * ac
    closest = np.where((d1 <= 0)[..., None] & (d2 <= 0)[..., None], a, closest)
    closest = np.where((d3 >= 0)[..., None] & (d4 <= d3)[..., None], b, closest)
    closest = np.where((d6 >= 0)[..., None] & (d5 <= d6)[..., None], c, closest)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ab = np.clip(d1 / np.maximum(d1 - d3, 1e-30), 0, 1)
    closest = np.where(on_ab[..., None], a + t_ab[..., None] * ab, closest)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_ac = np.clip(d2 / np.maximum(d2 - d6, 1e-30), 0, 1)
    closest = np.where(on_ac[..., None], a + t_ac[..., None] * ac, closest)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    t_bc = np.clip((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-30), 0, 1)
    closest = np.where(on_bc[..., None], b + t_bc[..., None] * (c - b), closest)
    return np.linalg.norm(p[:, None] - closest, axis=-1).min(axis=1)


def _incident_faces(faces: np.ndarray, n_verts: int, max_incident: int) -> tuple[np.ndarray, np.ndarray]:
    """(table [V, max_incident] of each vertex's first incident faces, in face
    order and padded with face 0; counts [V], capped at max_incident)."""
    flat = faces.reshape(-1)
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(n_verts))
    rank = np.arange(len(flat)) - starts[flat[order]]
    keep = rank < max_incident
    table = np.zeros((n_verts, max_incident), np.int64)
    table[flat[order][keep], rank[keep]] = order[keep] // 3
    counts = np.minimum(np.bincount(flat, minlength=n_verts), max_incident)
    return table, counts


def scan_to_mesh_distance(scan_points: np.ndarray, verts: np.ndarray, faces: np.ndarray, max_incident: int = 16,
                          device: str | torch.device | None = None) -> np.ndarray:
    """[Np] f32 distance of each scan point to the mesh: its nearest vertex
    (on `device`), refined by the exact distance to the vertex's first
    `max_incident` incident faces; inf everywhere for an empty mesh."""
    scan_points = np.asarray(scan_points, np.float32)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0 or len(verts) == 0:
        return np.full((len(scan_points),), np.inf, np.float32)
    dev = resolve_device(device)
    d_vert, idx = _nearest_vertex_dist(torch.from_numpy(scan_points).to(dev), torch.from_numpy(verts).to(dev))
    d_vert, idx = d_vert.cpu().numpy(), idx.cpu().numpy()
    incident, counts = _incident_faces(faces, len(verts), max_incident)
    tri = verts[faces[incident[idx]]]  # [Np, K, 3, 3]
    d_tri = _point_triangle_dist(scan_points.astype(np.float64), tri.astype(np.float64))
    return np.where(counts[idx] > 0, np.minimum(d_vert, d_tri), d_vert).astype(np.float32)


def icp_align(src: np.ndarray, dst: np.ndarray, device: str | torch.device | None = None):
    """ICP similarity alignment of point set src to dst, from the centroid
    and RMS-scale match, ICP_ITERS Umeyama steps over seeded subsamples
    (RandomState(0)): ICP_SAMPLE source points against 4 x ICP_SAMPLE target
    points, nearest targets on `device`. Returns (s, R, t)."""
    rng = np.random.RandomState(0)
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    s = float(np.sqrt(((dst - dst.mean(0)) ** 2).sum(1).mean()
                      / max(((src - src.mean(0)) ** 2).sum(1).mean(), 1e-12)))
    R = np.eye(3)
    t = dst.mean(0) - s * src.mean(0)
    src_s = src[rng.choice(len(src), min(ICP_SAMPLE, len(src)), replace=False)]
    dst_s = dst[rng.choice(len(dst), min(ICP_SAMPLE * 4, len(dst)), replace=False)].astype(np.float32)
    dev = resolve_device(device)
    dst_t = torch.from_numpy(dst_s).to(dev)
    for _ in range(ICP_ITERS):
        cur = torch.from_numpy((src_s @ (s * R).T + t).astype(np.float32)).to(dev)
        _, idx = _nearest_vertex_dist(cur, dst_t)
        s, R, t = umeyama(src_s, dst_s[idx.cpu().numpy()])
    return s, R, t


def parse_picked_points(path) -> np.ndarray:
    """A MeshLab .pp picked-points file (the NoW landmark format) -> [N, 3] f64."""
    pts = []
    with open(path) as f:
        text = f.read()
    for m in re.finditer(r"<point[^>]*/>", text):
        tag = m.group(0)
        pts.append([float(re.search(rf'{k}="([^"]+)"', tag).group(1)) for k in ("x", "y", "z")])
    return np.asarray(pts, np.float64)


def now_scan_error(pred_verts: np.ndarray, pred_faces: np.ndarray, scan_points: np.ndarray,
                   pred_lms: np.ndarray | None = None, scan_lms: np.ndarray | None = None,
                   device: str | torch.device | None = None) -> np.ndarray:
    """The NoW-style error [Np'] in scan units (mm for NoW): align the mesh
    to the scan (Umeyama on the landmarks when both are given, else ICP),
    keep the scan points within CROP_RADIUS of the scan landmarks' mean (of
    the aligned mesh's without them; all points if none is that close), and
    measure each one's distance to the aligned mesh."""
    if pred_lms is not None and scan_lms is not None:
        s, R, t = umeyama(pred_lms, scan_lms, with_scale=True)
    else:
        s, R, t = icp_align(pred_verts, scan_points, device=device)
    aligned = np.asarray(pred_verts, np.float64) @ (s * R).T + t
    scan = np.asarray(scan_points, np.float64)
    center = scan_lms.mean(0) if scan_lms is not None else aligned.mean(0)
    scan = scan[np.linalg.norm(scan - center, axis=1) < CROP_RADIUS]
    if len(scan) == 0:
        scan = np.asarray(scan_points, np.float64)
    return scan_to_mesh_distance(scan.astype(np.float32), aligned.astype(np.float32), pred_faces, device=device)


def landmark_98_to_7(landmark_98: np.ndarray) -> np.ndarray:
    """98-point detector landmarks -> the 7 NoW landmarks (reference
    misc_utils.py:297-319): the eye corners (60, 64, 68, 72), the nose tip
    (57) and the mouth corners (76, 92)."""
    return np.asarray(landmark_98, np.float32)[[60, 64, 68, 72, 57, 76, 92]]
