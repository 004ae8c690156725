"""Runner — the inference entry points around a port `E3DGE`; counterpart of
the inference part of `e3dge_tpu/runner.py:30-307` (reference trainer.py,
e3dge_full_runner.py): inversion, novel-view videos, camera trajectories,
semantic editing, toonify and mesh export.

Decoder noise is explicit: each call takes a list of per-layer noise maps for
the B inputs, or draws one from a `torch.Generator` seeded with NOISE_SEED
(the JAX runner's fixed noise key). The B*V batch of a batched video tiles
each input's maps over its V views, so the batched form and the per-view loop
see the same noise. Not ported yet (ROADMAP A11, A15): the projected-noise
video, the depth-mesh render, the HDTF video, validation, projection and
checkpoint rotation.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from e3dge_torch.models.e3dge import E3DGE, LatentMeans
from e3dge_torch.render.camera import CameraParams, camera_params_from_angles
from e3dge_torch.utils import editing, mesh
from e3dge_torch.utils.device import resolve_device

NOISE_SEED = 0


class Runner:
    """Inference over `model` with its mean latents, on `device` (None: the
    card; the constructor raises without one). The model and the mean latents
    are moved to the device."""

    def __init__(
        self,
        model: E3DGE,
        mean_latents: LatentMeans,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.model.device = self.device
        self.cfg = model.cfg
        self.mean_latents = LatentMeans(*(t.to(self.device) for t in mean_latents))
        self.boundaries: dict | None = None

    # ------------------------------------------------------------------ noise

    def make_noise(self, batch: int) -> list[torch.Tensor]:
        """Per-layer decoder noise [batch, 1, r, r] (one map at in_res, two at
        each level up to size), drawn on the CPU from a generator seeded with
        NOISE_SEED and moved to the device."""
        gen = torch.Generator().manual_seed(NOISE_SEED)
        d = self.cfg.decoder
        sizes, res = [d.in_res], d.in_res
        while res < d.size:
            res *= 2
            sizes += [res, res]
        return [torch.randn(batch, 1, s, s, generator=gen).to(self.device) for s in sizes]

    def _noise(self, noise, batch: int) -> list[torch.Tensor]:
        return [n.to(self.device) for n in noise] if noise is not None else self.make_noise(batch)

    def _camera(self, azim, elev) -> CameraParams:
        c = self.cfg
        return camera_params_from_angles(
            torch.as_tensor(azim, dtype=torch.float32, device=self.device),
            torch.as_tensor(elev, dtype=torch.float32, device=self.device),
            c.renderer.out_im_res, c.camera.fov_ang, c.camera.dist_radius,
        )

    # -------------------------------------------------------------- inference

    def image2image(self, images: torch.Tensor, noise=None) -> dict[str, Any]:
        """Invert and reconstruct: the full E1 path, or `image2image_global`
        for a model without the local branch."""
        images = images.to(self.device)
        noise = self._noise(noise, images.shape[0])
        if self.cfg.renderer.enable_local_model:
            return self.model.image2image(images, self.mean_latents, noise=noise)
        return self.model.image2image_global(images, self.mean_latents, noise=noise)

    def encode_ref(self, images: torch.Tensor) -> dict[str, Any]:
        return self.model.encode_ref_images(images.to(self.device), self.mean_latents)

    def render_view(self, ref_info: dict, camera: CameraParams, noise=None) -> dict[str, Any]:
        """The reference view(s) re-rendered at `camera` (the generic branch)."""
        noise = self._noise(noise, ref_info["orig_res_gt"].shape[0])
        return self.model.que_render_given_ref(ref_info, camera, noise=noise)

    def render_video(
        self,
        images: torch.Tensor,
        n_views: int = 8,
        azim_range: float = 0.3,
        batched: bool = True,
        noise=None,
        ref_info: dict | None = None,
    ) -> torch.Tensor:
        """Novel-view trajectory of each input (reference render_video,
        trainer.py:1843-2012): an azimuth sweep over [-azim_range, azim_range]
        at the estimated elevation -> [B, V, 3, size, size]. batched renders
        the B*V views as one batch (`E3DGE.render_multiview`); otherwise one
        view at a time, as the reference does. ref_info skips the encoding."""
        if ref_info is None:
            ref_info = self.encode_ref(images)
        b = ref_info["orig_res_gt"].shape[0]
        noise = self._noise(noise, b)
        azims = np.linspace(-azim_range, azim_range, n_views)
        elev = ref_info["cam_settings"].viewpoint[:, 1]
        if batched:
            cams = self._camera(np.tile(azims, b), elev.repeat_interleave(n_views))  # b0v0, b0v1, ..
            tiled = [n.repeat_interleave(n_views, dim=0) for n in noise]
            out = self.model.render_multiview(ref_info, cams, n_views, noise=tiled)
            imgs = out["res_render_out"]["gen_imgs"]
            return imgs.reshape(b, n_views, *imgs.shape[1:])
        frames = []
        for azim in azims:
            out = self.render_view(ref_info, self._camera(np.full(b, azim), elev), noise=noise)
            frames.append(out["res_render_out"]["gen_imgs"])
        return torch.stack(frames, dim=1)

    def create_trajectory(self, num_frames: int = 250, azim_only: bool = False) -> np.ndarray:
        """Camera trajectory [num_frames, 2] of (azim, elev) (reference
        create_trajectory, trainer.py:2349-2390): an azimuth sweep, or an
        ellipse over the training pose range."""
        t = np.linspace(0.0, 1.0, num_frames)
        cc = self.cfg.camera
        if azim_only:
            azim = 1.5 * cc.azim_range * np.cos(t * np.pi)
            elev = np.zeros_like(azim)
        else:
            azim = cc.azim_range * np.cos(t * 2 * np.pi)
            elev = cc.elev_range / 2 + cc.elev_range / 2 * np.sin(t * 2 * np.pi)
        return np.stack([azim, elev], axis=1).astype(np.float32)

    # ---------------------------------------------------------------- editing

    def load_boundaries(self, boundary_dir) -> None:
        self.boundaries = editing.load_boundaries(boundary_dir)

    def edit_and_render(
        self, images: torch.Tensor, scales: Sequence[float] | Mapping[str, float], noise=None
    ) -> dict[str, Any]:
        """Semantic editing (reference editing path, e3dge_full_runner.py:
        121-142): edit the codes, re-render the edited global pass, then render
        the reference camera through the generic branch. As in the JAX runner,
        the residual and its feature volume stay the pre-edit ones."""
        if self.boundaries is None:
            raise RuntimeError("call load_boundaries first")
        ref_info = dict(self.encode_ref(images))
        ref_info["pred_latents"] = editing.edit_code(ref_info["pred_latents"], self.boundaries, scales)
        ref_info["global_render_out"] = self.model.latent2image(
            ref_info["pred_latents"], ref_info["cam_settings"], renderer_only=True
        )
        return self.render_view(ref_info, ref_info["cam_settings"], noise=noise)

    def toonify(self, toon_generator_state_dict: Mapping[str, torch.Tensor]) -> None:
        """Swap in a domain-transferred generator (demo_toonify path)."""
        editing.toonify(self.model.generator, toon_generator_state_dict)

    # ------------------------------------------------------------------- mesh

    def latent2surface(self, pred_latents, camera: CameraParams | None = None) -> list[tuple[np.ndarray, np.ndarray]]:
        """SDF frustum grid (one field launch) -> cube grid -> marching
        tetrahedra -> [(verts, faces)] per item (reference latent2surface,
        trainer.py:1374-1480). The default camera is frontal."""
        styles = pred_latents[0].to(self.device)
        b = styles.shape[0]
        if camera is None:
            camera = self._camera(np.zeros(b), np.zeros(b))
        with torch.no_grad():
            sdf = self.model.generator.render_sdf_grid(camera, styles)
        aligned = mesh.align_volume(sdf).cpu().numpy()
        return [mesh.extract_mesh(aligned[i, ..., 0]) for i in range(b)]
