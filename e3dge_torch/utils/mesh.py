"""Meshes: frustum-to-cube alignment of the SDF samples, marching
tetrahedra, vertex welding and .obj I/O, the depth mesh, screen projection,
z-buffer rasterization, the noise projection and Phong shading; counterpart
of `e3dge_tpu/utils/mesh.py` (reference mesh_utils.py:17-126, 145-219,
volume_renderer.py:1733-1758, trainer.py:2251-2346).

`march` and `rasterize` run the port's own host C++ source
(`e3dge_torch/csrc/marching.cpp`), built with the host C++ compiler at first
use into `e3dge_torch/_build/` and bound through ctypes; they raise when the
library cannot be built. `march_reference` and `rasterize_reference` are
their plain numpy versions, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from e3dge_torch.ops import grid_sample_3d

_PKG = Path(__file__).resolve().parents[1]
MARCHING_SOURCE = _PKG / "csrc" / "marching.cpp"
BUILD_DIR = _PKG / "_build"
_lib = None


def align_volume(sdf: torch.Tensor, near: float = 0.88, far: float = 1.12) -> torch.Tensor:
    """Warp [B, H, W, S, 1] frustum SDF samples onto a cubic grid of the same
    shape (mesh_utils.py:17-44). The cube's xy extent is the FAR slice's
    frustum extent, so nearer slices are read at xy scaled up by
    linspace(far/near -> 1) over depth; samples outside the frustum are
    border-clamped by the resample, then set to +1 (outside the surface)."""
    b, h, w, s, _ = sdf.shape
    dev = sdf.device
    vol = sdf.permute(0, 4, 3, 1, 2)  # [B, C, S(D), H, W]
    gy, gx, gz = torch.meshgrid(
        torch.linspace(-1.0, 1.0, h, device=dev), torch.linspace(-1.0, 1.0, w, device=dev),
        torch.linspace(-1.0, 1.0, s, device=dev), indexing="ij",
    )  # [h, w, s] each
    coeff = torch.linspace(far / near, 1.0, s, device=dev).reshape(1, 1, s)
    grid_hws = torch.stack([gx * coeff, gy * coeff, gz], dim=-1)  # [h, w, s, 3]
    oob = ((grid_hws < -1.0) | (grid_hws > 1.0)).any(dim=-1)
    grid = grid_hws.permute(2, 0, 1, 3)[None].expand(b, s, h, w, 3)  # [B, D, H, W, 3]
    out = grid_sample_3d(vol, grid, padding_mode="border").permute(0, 3, 4, 2, 1)  # [B, H, W, D, C]
    return torch.where(oob[None, :, :, :, None], torch.ones((), dtype=out.dtype, device=dev), out)


# ------------------------------------------------------------ marching tetrahedra


def build_marching_library() -> Path:
    """Compile csrc/marching.cpp into _build/ with the host C++ compiler
    ($CXX, else c++ or g++) unless a library built from the same source bytes
    is there (an older source's library, without `rasterize`, has another
    name). Contraction into fused multiply-adds is off, so `rasterize` rounds
    as `rasterize_reference` does. Returns its path; raises if it cannot be
    built."""
    digest = hashlib.sha256(MARCHING_SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmarching_{digest}.so"
    if lib.exists():
        return lib
    cxx = next((p for p in (os.environ.get("CXX"), "c++", "g++") if p and shutil.which(p)), None)
    if cxx is None:
        raise RuntimeError("no host C++ compiler ($CXX, c++ or g++): cannot build the marching library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, "-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(tmp), str(MARCHING_SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"building the marching library failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _marching_library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_marching_library()))
        fp, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
        lib.march_tetrahedra.argtypes = [fp, i64, i64, i64, ctypes.c_float, fp, i64]
        lib.march_tetrahedra.restype = i64
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rasterize.argtypes = [fp, i64, i32p, i64, fp, i64, i64, fp, fp]
        lib.rasterize.restype = i64
        _lib = lib
    return _lib


def march(sdf: np.ndarray, iso: float = 0.0) -> np.ndarray:
    """Triangle soup [T, 3, 3] (grid-index coordinates) of the iso level of an
    [nx, ny, nz] grid, by the native library."""
    sdf = np.ascontiguousarray(sdf, dtype=np.float32)
    if sdf.ndim != 3:
        raise ValueError(f"march takes an [nx, ny, nz] grid, got shape {sdf.shape}")
    lib = _marching_library()
    max_tris = 12 * sdf.size  # 6 tetrahedra per cell, at most 2 triangles each
    out = np.empty((max_tris, 3, 3), dtype=np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    n = lib.march_tetrahedra(sdf.ctypes.data_as(fp), *sdf.shape, ctypes.c_float(iso), out.ctypes.data_as(fp), max_tris)
    if n < 0:
        raise RuntimeError("marching buffer overflow")
    return out[:n]


def march_reference(sdf: np.ndarray, iso: float = 0.0) -> np.ndarray:
    """Plain numpy version of `march`: the same 6-tetrahedra decomposition, the
    same vertex order per triangle (`e3dge_tpu/utils/mesh.py::_march_numpy`)."""
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
    tets = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])
    nx, ny, nz = sdf.shape
    tris = []

    def lerp(p0, p1, v0, v1):
        d = v1 - v0
        t = 0.5 if abs(d) < 1e-12 else np.clip((iso - v0) / d, 0.0, 1.0)
        return p0 + t * (p1 - p0)

    for x in range(nx - 1):
        for y in range(ny - 1):
            for z in range(nz - 1):
                v = np.array([sdf[x + c[0], y + c[1], z + c[2]] for c in corners])
                if (v >= iso).all() or (v < iso).all():
                    continue
                p = np.array([[x + c[0], y + c[1], z + c[2]] for c in corners], dtype=np.float64)
                for tet in tets:
                    inside = [i for i in tet if v[i] < iso]
                    outside = [i for i in tet if v[i] >= iso][::-1]  # the native order fill
                    if not inside or not outside:
                        continue
                    if len(inside) == 1:
                        a = inside[0]
                        tris.append([lerp(p[a], p[o], v[a], v[o]) for o in outside])
                    elif len(inside) == 3:
                        a = outside[-1]
                        tris.append([lerp(p[a], p[i], v[a], v[i]) for i in inside])
                    else:
                        (i0, i1), (o0, o1) = inside, outside
                        e00 = lerp(p[i0], p[o0], v[i0], v[o0])
                        e01 = lerp(p[i0], p[o1], v[i0], v[o1])
                        e10 = lerp(p[i1], p[o0], v[i1], v[o0])
                        e11 = lerp(p[i1], p[o1], v[i1], v[o1])
                        tris += [[e00, e01, e11], [e00, e11, e10]]
    return np.asarray(tris, dtype=np.float32) if tris else np.zeros((0, 3, 3), np.float32)


def weld(tris: np.ndarray, decimals: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """Triangle soup -> (verts [V, 3] f32, faces [T, 3] int32), identical
    vertices (to `decimals`) welded."""
    uniq, inv = np.unique(np.round(tris.reshape(-1, 3), decimals), axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv.reshape(-1, 3).astype(np.int32)


def extract_mesh(sdf_vol: np.ndarray, scene_scale: float = 0.12) -> tuple[np.ndarray, np.ndarray]:
    """Grid SDF [H, W, D] -> (verts, faces) in scene coordinates: the grid is
    permuted (y, x, z) -> (x, y, z), verts normalised to +-scene_scale and y, z
    flipped, as the reference does (volume_renderer.py:1745-1753); flipping two
    axes keeps the winding."""
    vol = np.transpose(np.asarray(sdf_vol), (1, 0, 2))
    verts, faces = weld(march(vol, 0.0))
    if len(verts):
        verts = (verts / np.array(vol.shape, dtype=np.float32) - 0.5) * (2 * scene_scale)
        verts[:, 1:] *= -1
    return verts, faces


# ------------------------------------------------------------ depth mesh, raster


def xyz2mesh(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Depth mesh: the per-pixel surface xyz map [H, W, 3] triangulated on its
    pixel grid, two triangles per cell (reference xyz2mesh,
    mesh_utils.py:107-126)."""
    h, w, _ = xyz.shape
    verts = xyz.reshape(-1, 3).astype(np.float32)
    idx = np.arange(h * w).reshape(h, w)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 0)
    return verts, faces.astype(np.int32)


def project_to_screen(verts: np.ndarray, calibs: np.ndarray, height: int, width: int) -> np.ndarray:
    """World-space verts [V, 3] -> screen verts [V, 3] (x_pix, y_pix, depth)
    through a uv-space calib [4, 4], y flipped as the grid convention
    (HGPIFuGANNet.py:114-115)."""
    homo = calibs[:3, :3] @ verts.T + calibs[:3, 3:4]  # [3, V]
    depth = -homo[2]
    safe = np.where(np.abs(depth) < 1e-8, 1e-8, depth)
    x_pix = (homo[0] / safe + 1.0) * 0.5 * width
    y_pix = (-homo[1] / safe + 1.0) * 0.5 * height
    return np.stack([x_pix, y_pix, depth], axis=-1).astype(np.float32)


def _raster_inputs(verts_screen, faces, vertex_color):
    return (np.ascontiguousarray(verts_screen, dtype=np.float32), np.ascontiguousarray(faces, dtype=np.int32),
            np.ascontiguousarray(vertex_color, dtype=np.float32))


def rasterize(verts_screen: np.ndarray, faces: np.ndarray, vertex_color: np.ndarray, height: int, width: int):
    """Z-buffer rasterization by the native library: verts [V, 3] as (x_pix,
    y_pix, depth), faces [F, 3], vertex_color [V] -> (color [H, W], depth
    [H, W]); pixel centres at +0.5, barycentric interpolation, the nearest
    (smallest) depth wins, background color 0 and depth 0."""
    v, f, c = _raster_inputs(verts_screen, faces, vertex_color)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3 or c.shape != (len(v),):
        raise ValueError(f"rasterize takes verts [V, 3], faces [F, 3], colors [V]: {v.shape}, {f.shape}, {c.shape}")
    out_color = np.empty((height, width), np.float32)
    out_depth = np.empty((height, width), np.float32)
    fp, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    _marching_library().rasterize(v.ctypes.data_as(fp), len(v), f.ctypes.data_as(i32p), len(f), c.ctypes.data_as(fp),
                                  height, width, out_color.ctypes.data_as(fp), out_depth.ctypes.data_as(fp))
    return out_color, out_depth


def rasterize_reference(verts_screen: np.ndarray, faces: np.ndarray, vertex_color: np.ndarray, height: int,
                        width: int):
    """Plain numpy version of `rasterize`: the same f32 operations in the
    same order, one face at a time over its bounding box."""
    v, f, col = _raster_inputs(verts_screen, faces, vertex_color)
    one, half = np.float32(1.0), np.float32(0.5)
    color = np.zeros((height, width), np.float32)
    depth = np.zeros((height, width), np.float32)
    zbuf = np.full((height, width), 1e30, np.float32)
    for i0, i1, i2 in f:
        if min(i0, i1, i2) < 0 or max(i0, i1, i2) >= len(v):
            continue
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = v[i0], v[i1], v[i2]
        px0 = max(0, int(np.floor(min(x0, x1, x2))))
        px1 = min(width - 1, int(np.ceil(max(x0, x1, x2))))
        py0 = max(0, int(np.floor(min(y0, y1, y2))))
        py1 = min(height - 1, int(np.ceil(max(y0, y1, y2))))
        if px0 > px1 or py0 > py1:
            continue
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(denom) < np.float32(1e-12):
            continue
        x = np.arange(px0, px1 + 1, dtype=np.float32)[None, :] + half
        y = np.arange(py0, py1 + 1, dtype=np.float32)[:, None] + half
        w0 = ((y1 - y2) * (x - x2) + (x2 - x1) * (y - y2)) / denom
        w1 = ((y2 - y0) * (x - x2) + (x0 - x2) * (y - y2)) / denom
        w2 = one - w0 - w1
        z = w0 * z0 + w1 * z1 + w2 * z2
        box = (slice(py0, py1 + 1), slice(px0, px1 + 1))
        hit = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z < zbuf[box])
        zbuf[box] = np.where(hit, z, zbuf[box])
        depth[box] = np.where(hit, z, depth[box])
        color[box] = np.where(hit, w0 * col[i0] + w1 * col[i1] + w2 * col[i2], color[box])
    return color, depth


def project_noise(
    noise: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    calibs: np.ndarray,
    vert_noise: np.ndarray | None = None,
    prev_noise: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Geometry-aware noise projection (reference NoiseInjection.project_noise,
    stylesdf_model.py:423-457): a fixed per-vertex noise (`vert_noise`, else
    RandomState(0).randn(V)) rasterized through the view calib [4, 4] into a
    [1, 1, H, W] noise map; where the mesh covers no pixel, the previous
    noise (`prev_noise`, else `noise`) stays. Returns (the projected noise,
    vert_noise) so the caller can reuse the vertex noise."""
    _, _, h, w = noise.shape
    if vert_noise is None:
        vert_noise = np.random.RandomState(0).randn(len(verts)).astype(np.float32)
    color, dep = rasterize(project_to_screen(verts, calibs, h, w), faces, vert_noise, h, w)
    base = prev_noise if prev_noise is not None else noise
    return np.where(dep[None, None] > 0, color[None, None], base).astype(np.float32), vert_noise


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals [V, 3] (what trimesh gives the
    reference's Meshes, trainer.py:2295-2310)."""
    n = np.zeros_like(verts, dtype=np.float64)
    tri = verts[faces]  # [F, 3, 3]
    face_n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for i in range(3):
        np.add.at(n, faces[:, i], face_n)
    return (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)).astype(np.float32)


def phong_vertex_intensity(
    verts: np.ndarray,
    normals: np.ndarray,
    cam_origin: np.ndarray,
    light_pos=(0.0, 0.0, 5.0),
    ambient: float = 0.1,
    diffuse: float = 0.65,
    specular: float = 0.2,
    shininess: float = 64.0,
) -> np.ndarray:
    """Gray Phong intensity per vertex in [0, 1], with the reference's light
    rig (trainer.py:2320-2330: a point light at (0, 0, 5), ambient 0.1,
    diffuse 0.65, specular 0.2; pytorch3d's shininess 64)."""
    l = np.asarray(light_pos, np.float32) - verts
    l = l / np.maximum(np.linalg.norm(l, axis=1, keepdims=True), 1e-12)
    v = np.asarray(cam_origin, np.float32) - verts
    v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    ndl = np.clip(np.sum(normals * l, axis=1), 0.0, None)
    r = 2.0 * ndl[:, None] * normals - l  # the light reflected about the normal
    rdv = np.clip(np.sum(r * v, axis=1), 0.0, None)
    return np.clip(ambient + diffuse * ndl + specular * rdv**shininess, 0.0, 1.0).astype(np.float32)


def save_obj(path: str | os.PathLike, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces + 1:  # .obj is 1-indexed
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def load_obj(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """(verts [V, 3] f32, faces [F, 3] int32, 0-indexed) of a triangle .obj;
    other records are ignored."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts and parts[0] == "f":
                faces.append([int(x.split("/")[0]) - 1 for x in parts[1:4]])
    return np.asarray(verts, np.float32).reshape(-1, 3), np.asarray(faces, np.int32).reshape(-1, 3)
