"""Mesh export: frustum-to-cube alignment of the SDF samples, marching
tetrahedra, vertex welding and .obj I/O; counterpart of
`e3dge_tpu/utils/mesh.py` (reference mesh_utils.py:17-126,
volume_renderer.py:1733-1758).

`march` runs the port's own marching-tetrahedra source
(`e3dge_torch/csrc/marching.cpp`), built with the host C++ compiler at first
use into `e3dge_torch/_build/` and bound through ctypes; it raises when the
library cannot be built. `march_reference` is its plain numpy version, the
same decomposition, for the tests. Not ported yet: the rasterizer and the
noise projection (`rasterize`, `project_noise`) and `xyz2mesh`.
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
    is there. Returns its path; raises if it cannot be built."""
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
        [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(MARCHING_SOURCE)],
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
