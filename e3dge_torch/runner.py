"""Runner — the inference and evaluation entry points around a port `E3DGE`;
counterpart of `e3dge_tpu/runner.py` (reference trainer.py,
e3dge_full_runner.py, projectors.py): inversion, novel-view videos (batched,
with projected noise, the HDTF video), camera trajectories, the depth-mesh
render, semantic editing, toonify, mesh export, the NoW 3D evaluation,
validation with scores.json, optimisation inversion with PTI and validation
from its latents, and the trainer's checkpoints with their `_old` rotation.

Decoder noise is explicit: each call takes a list of per-layer noise maps for
the B inputs, or draws one from a `torch.Generator` seeded with NOISE_SEED
(the JAX runner's fixed noise key). The B*V batch of a batched video tiles
each input's maps over its V views, so the batched form and the per-view loop
see the same noise.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from e3dge_torch.models import volume_renderer
from e3dge_torch.models.e3dge import E3DGE, LatentMeans
from e3dge_torch.ops import adaptive_avg_pool
from e3dge_torch.ops import siren_field as sf
from e3dge_torch.parallel import mesh as dp
from e3dge_torch.render.camera import CameraParams, camera_params_from_angles
from e3dge_torch.training import losses as L
from e3dge_torch.training.data import EvalImageDataset
from e3dge_torch.utils import editing, graphs, image_io, mesh
from e3dge_torch.utils.device import resolve_device
from e3dge_torch.utils.trace import span

NOISE_SEED = 0


class Runner:
    """Inference and evaluation over `model` with its mean latents, on
    `device` (None: the card; the constructor raises without one). The model
    and the mean latents are moved to the device. Artifacts go under
    `work_dir`; `lpips_fn` and `id_fn` (`training.perceptual`) add the LPIPS
    and identity columns to the scores and LPIPS to projection's objective.
    With a `world` of several ranks (`parallel.mesh`, imported as `dp`), `image2image` serves
    a global batch data-parallel; every other entry point is per rank. A
    world with an sp axis raises: JAX serves only under a pure dp mesh
    (`__graft_entry__.py:218-232`)."""

    def __init__(
        self,
        model: E3DGE,
        mean_latents: LatentMeans,
        device: str | torch.device | None = None,
        work_dir: str | Path = "runs/e3dge",
        lpips_fn: Callable | None = None,
        id_fn: Callable | None = None,
        world: dp.World | None = None,
    ):
        if world is not None and world.sp > 1:
            raise ValueError(f"Runner serves across ranks under pure dp only, not on an sp axis of {world.sp}: "
                             f"start the world with sp=1")
        self.device = resolve_device(device)
        self.world = world
        self.model = model.to(self.device)
        self.model.device = self.device
        self.cfg = model.cfg
        self.mean_latents = LatentMeans(*(t.to(self.device) for t in mean_latents))
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.lpips_fn = lpips_fn
        self.id_fn = id_fn
        self.boundaries: dict | None = None
        # image2image's CUDA graphs, per input signature, and the fixed noise per batch
        self.graphs = graphs.GraphCache(
            self._invert, self.model, self.device, extra=lambda: self.mean_latents,
            counters=(sf.launch_counts, sf.precision_launch_counts, volume_renderer.twin_counts),
        ) if graphs.usable(self.device, world) else None
        self._fixed_noise: dict[int, list[torch.Tensor]] = {}

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

    def _camera(self, azim, elev, res: int | None = None) -> CameraParams:
        c = self.cfg
        return camera_params_from_angles(
            torch.as_tensor(azim, dtype=torch.float32, device=self.device),
            torch.as_tensor(elev, dtype=torch.float32, device=self.device),
            res or c.renderer.out_im_res, c.camera.fov_ang, c.camera.dist_radius,
        )

    def _append_scores(self, scores: dict) -> None:
        path = self.work_dir / "scores.json"
        existing = json.loads(path.read_text()) if path.exists() else []
        existing.append(scores)
        path.write_text(json.dumps(existing, indent=2))

    # -------------------------------------------------------------- inference

    def image2image(self, images: torch.Tensor, noise=None) -> dict[str, Any]:
        """Invert and reconstruct: the full E1 path, or `image2image_global`
        for a model without the local branch. Across the runner's ranks,
        images (and noise) are the global batch on every rank: each rank
        inverts its rows, and `gen_imgs` comes back for the whole batch on
        every rank (the other outputs are the rank's rows).

        On a CUDA device with no world or a world of one rank, calls replay
        CUDA graphs (`utils.graphs`). The key is the input signature (the
        images' shape and dtype, the noise maps' shapes and dtypes) and every
        parameter's and buffer's storage and version counter, the mean
        latents' included. The first call at a key runs eagerly and captures
        the call, cut at the layer spans (10 graphs for the full model);
        later calls copy the inputs in and replay them. An in-place weight
        update, a load or `toonify` drops every chain, and the next call
        captures again. Replayed outputs are fresh tensors, never the
        graphs' memory. Each
        captured signature holds a private pool of about one eager call's
        working memory or more (at demo_view_synthesis_config's widths, f32:
        2.0 GiB at B=1, 15.2 GiB at B=8). Without `noise`, the NOISE_SEED
        maps are drawn once per batch size and kept on the card."""
        with span("inversion"):
            if self.graphs is None:
                return self._invert(images, noise)
            if noise is None:
                b = images.shape[0]
                if b not in self._fixed_noise:
                    self._fixed_noise[b] = self.make_noise(b)
                noise = self._fixed_noise[b]
            return self.graphs(images, list(noise))

    def _invert(self, images: torch.Tensor, noise=None) -> dict[str, Any]:
        """`image2image`'s eager path."""
        images = images.to(self.device)
        noise = self._noise(noise, images.shape[0])
        w = self.world
        if w is not None and w.size > 1:
            images, noise = dp.shard_rows(images, w), [dp.shard_rows(n, w) for n in noise]
        if self.cfg.renderer.enable_local_model:
            out = self.model.image2image(images, self.mean_latents, noise=noise)
            rec = out["res_render_out"]
        else:
            out = rec = self.model.image2image_global(images, self.mean_latents, noise=noise)
        if w is not None and w.size > 1:
            rec["gen_imgs"] = dp.gather_rows(rec["gen_imgs"], w)
        return out

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

    def render_video_projected_noise(
        self, images: torch.Tensor, n_views: int = 8, azim_range: float = 0.3, noise=None
    ) -> torch.Tensor:
        """Geometry-aware noise video (reference --project_noise,
        stylesdf_model.py:423-466) of one input -> [1, V, 3, size, size]:
        the mesh is extracted once at the estimated camera, a fixed
        per-vertex noise is rasterized at each view into every decoder noise
        layer (the base noise, `noise` or `make_noise`, where the mesh covers
        nothing, or everywhere if it is empty), and the global path renders
        the view with it. As in the JAX runner, one vertex noise
        (RandomState(0)) serves every layer and frame."""
        if images.shape[0] != 1:
            raise ValueError("the noise projection takes one image (reference NoiseInjection.project_noise)")
        ref_info = self.encode_ref(images)
        verts, faces = self.latent2surface(ref_info["pred_latents"], ref_info["cam_settings"])[0]
        base = self._noise(noise, 1)
        vert_noise = None
        elev = float(ref_info["cam_settings"].viewpoint[0, 1])
        frames = []
        for azim in np.linspace(-azim_range, azim_range, n_views):
            cam = self._camera([float(azim)], [elev])
            calib = cam.calibs[0].cpu().numpy()
            layers = []
            for layer_noise in base:
                if len(verts):
                    projected, vert_noise = mesh.project_noise(layer_noise.cpu().numpy(), verts, faces, calib,
                                                               vert_noise=vert_noise)
                    layer_noise = torch.from_numpy(projected).to(self.device)
                layers.append(layer_noise)
            frames.append(self.model.latent2image(ref_info["pred_latents"], cam, noise=layers)["gen_imgs"])
        return torch.stack(frames, dim=1)

    def render_hdtf(
        self,
        data_root: str | Path,
        max_frames: int = 250,
        batch_size: int = 4,
        trajectory_len: int = 250,
        out_name: str = "HDTF_nvs_video",
    ) -> dict[str, Any]:
        """HDTF novel-view video (reference render_HDTF, trainer.py:3107-3174):
        each frame of the folder is inverted and re-rendered at the next camera
        of a looping `create_trajectory(trajectory_len)`, in device batches of
        per-frame cameras (the last batch padded with its last frame). Writes
        trajectory_videos/<out_name>.npy [N, 3, H, W] and the video
        (`image_io.write_video`)."""
        ds = EvalImageDataset(data_root, size=self.cfg.pifu.load_size)
        traj = self.create_trajectory(trajectory_len)
        frames, seen = [], 0
        for batch in ds.iter_batches(batch_size):
            if seen >= max_frames:
                break
            imgs = _pad_batch(batch["image"], batch_size)
            idx = (seen + np.arange(batch_size)) % trajectory_len
            ref = self.encode_ref(torch.from_numpy(imgs).to(self.device))
            out = self.render_view(ref, self._camera(traj[idx, 0], traj[idx, 1]))
            valid = len(batch["img_path"])
            frames.append(out["res_render_out"]["gen_imgs"][:valid].cpu().numpy())
            seen += valid
        video = np.concatenate(frames, axis=0)[:max_frames]
        out_dir = self.work_dir / "trajectory_videos"
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / f"{out_name}.npy", video)
        written = image_io.write_video(out_dir / f"{out_name}.mp4", video, fps=25)
        return {"num_frames": int(video.shape[0]), "out_dir": str(out_dir), "video": str(written)}

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

    def render_depth_mesh(
        self,
        images: torch.Tensor | None = None,
        ref_info: dict | None = None,
        trajectory_location: Sequence[float] | None = None,
        image_size: int = 512,
        filter_out_bg: bool = True,
    ) -> np.ndarray:
        """Phong-shaded depth-geometry frames [B, H, W] in [0, 1] (reference
        render_depth_mesh, trainer.py:2251-2346): the global render's surface
        xyz map as a grid mesh with area-weighted normals, shaded by the
        reference's light rig, projected at `image_size` from the estimated
        (or the given (azim, elev)) view and z-buffer rasterized; uncovered
        pixels 0.5. With filter_out_bg the thumb's background (> 0.98,
        nearest-resized, box-blurred over max(size // 64, 1) taps) is
        composited to 0.5."""
        if ref_info is None:
            ref_info = self.encode_ref(images)
        gro = ref_info["global_render_out"]
        xyz = gro["xyz"].float().cpu().numpy()  # [B, H, W, 3]
        b = xyz.shape[0]
        if trajectory_location is None:
            viewpoints = ref_info["cam_settings"].viewpoint.float().cpu().numpy()
        else:
            viewpoints = np.broadcast_to(np.asarray(trajectory_location, np.float32).reshape(1, 2), (b, 2))
        if filter_out_bg:
            bg = (gro["gen_thumb_imgs"].float().cpu().numpy() > 0.98).astype(np.float32).mean(axis=1)  # [B, h, w]
        frames = []
        for i in range(b):
            verts, faces = mesh.xyz2mesh(xyz[i])
            normals = mesh.vertex_normals(verts, faces)
            azim, elev = float(viewpoints[i, 0]), float(viewpoints[i, 1])
            cam_origin = np.array([np.cos(elev) * np.sin(azim), np.sin(elev), np.cos(elev) * np.cos(azim)],
                                  np.float32)  # the dist-1 camera (render/camera.py)
            intensity = mesh.phong_vertex_intensity(verts, normals, cam_origin)
            calib = self._camera([azim], [elev], res=image_size).calibs[0].cpu().numpy()
            screen = mesh.project_to_screen(verts, calib, image_size, image_size)
            color, dep = mesh.rasterize(screen, faces, intensity, image_size, image_size)
            frame = np.where(dep > 0, color, 0.5)
            if filter_out_bg:
                idx = np.arange(image_size) * bg.shape[-1] // image_size
                mask = bg[i][np.ix_(idx, idx)]
                k = max(image_size // 64, 1)
                kern = np.ones(k) / k
                mask = np.apply_along_axis(lambda r: np.convolve(r, kern, mode="same"), 1, mask)
                mask = np.apply_along_axis(lambda c: np.convolve(c, kern, mode="same"), 0, mask)
                frame = frame * (1.0 - mask) + mask * 0.5
            frames.append(frame.astype(np.float32))
        return np.stack(frames, axis=0)

    def evaluate3d(
        self,
        now_folder: str | Path,
        batch_size: int = 2,
        out_dir: str | Path | None = None,
        max_scan_points: int = 40000,
    ) -> dict[str, Any]:
        """The NoW 3D eval (reference evaluate3D, trainer.py:2103-2208): each
        validation crop (`NoWDataset`, 224^2) is inverted and its mesh written
        as out_dir/<subject>/<image>.obj; where the layout holds a subject's
        scan (scans/<subject>/*.obj, strided down to at most
        max_scan_points) and its landmarks (scans_lmks_onlypp/<subject>/*.pp),
        each mesh is scored by `now_scan_error` (ICP: no predicted landmarks,
        as the JAX runner) and the mean, median and std of the distances in
        scan units go to out_dir/now_scores.json."""
        from e3dge_torch.training.eval3d import now_scan_error, parse_picked_points
        from e3dge_torch.training.now_data import NoWDataset

        root = Path(now_folder)
        ds = NoWDataset(root)
        out_dir = Path(out_dir or (self.work_dir / "now_meshes"))
        out_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        all_dists: list[np.ndarray] = []
        scan_cache: dict[str, tuple] = {}
        for batch in ds.iter_batches(batch_size):
            ref = self.encode_ref(torch.from_numpy(batch["image"]))
            meshes = self.latent2surface(ref["pred_latents"], ref["cam_settings"])
            for (verts, faces), name, subj in zip(meshes, batch["imagename"], batch["subject"]):
                (out_dir / subj).mkdir(parents=True, exist_ok=True)
                mesh.save_obj(out_dir / subj / f"{name}.obj", verts, faces)
                n += 1
                if len(verts) == 0:
                    continue
                if subj not in scan_cache:
                    scan_objs = sorted((root / "scans" / subj).glob("*.obj"))
                    lms_files = sorted((root / "scans_lmks_onlypp" / subj).glob("*.pp"))
                    scan_pts = mesh.load_obj_vertices(scan_objs[0]) if scan_objs else None
                    scan_lms = parse_picked_points(lms_files[0]) if lms_files else None
                    if scan_pts is not None and len(scan_pts) > max_scan_points:
                        scan_pts = scan_pts[:: len(scan_pts) // max_scan_points + 1]
                    scan_cache[subj] = (scan_pts, scan_lms)
                scan_pts, scan_lms = scan_cache[subj]
                if scan_pts is None:
                    continue
                dists = now_scan_error(verts, faces, scan_pts, scan_lms=scan_lms, device=self.device)
                all_dists.append(dists[np.isfinite(dists)])
        result: dict[str, Any] = {"num_meshes": n, "out_dir": str(out_dir)}
        if all_dists:
            d = np.concatenate(all_dists)
            result.update(mean=float(d.mean()), median=float(np.median(d)), std=float(d.std()),
                          num_scored=len(all_dists))
            (out_dir / "now_scores.json").write_text(json.dumps(result, indent=2))
        return result

    # ------------------------------------------------------------- validation

    @torch.no_grad()
    def _per_image_metrics(self, pred: torch.Tensor, gt: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per-image L2, MAE, PSNR and SSIM, plus LPIPS and the identity
        similarity when the nets are given (trainer.py:423-429,
        builder.py:130-186). `mae` and `ssim` are the reference's printed
        conventions (L1 on [-1, 1]; window-5 (1 + SSIM) / 2), the standard
        forms `mae_std` and `ssim_std`."""
        pred01, gt01 = (pred + 1.0) / 2.0, (gt + 1.0) / 2.0
        axes = (1, 2, 3)
        m = {
            "loss_l2": torch.mean((pred - gt) ** 2, dim=axes),
            "mae": L.mae_ref(pred, gt, per_sample=True),
            "mae_std": torch.mean(torch.abs(pred01 - gt01), dim=axes),
            "psnr": 10.0 * torch.log10(1.0 / torch.clamp(torch.mean((pred01 - gt01) ** 2, dim=axes), min=1e-12)),
            "ssim": L.ssim_ref(pred, gt, per_sample=True),
            "ssim_std": L.ssim(pred01, gt01, per_sample=True),
        }
        if self.lpips_fn is not None:
            m["loss_lpips"] = self.lpips_fn(pred, gt, per_sample=True)
        if self.id_fn is not None:
            m["id_sim"] = self.id_fn(pred, gt, per_sample=True)[1]
        return m

    def _scores(self, pred: torch.Tensor, imgs: torch.Tensor) -> dict[str, torch.Tensor]:
        """`_per_image_metrics` with both pooled to the smaller resolution."""
        res = min(pred.shape[-1], imgs.shape[-1])
        return self._per_image_metrics(adaptive_avg_pool(pred, res), adaptive_avg_pool(imgs, res))

    def validation(
        self,
        data_root: str | Path,
        batch_size: int = 4,
        max_images: int | None = None,
        save_panels: bool = False,
    ) -> dict[str, float]:
        """The eval_2dmetrics path (trainer.py:290-585): invert every image of
        the folder, score the reconstructions, append the means to
        work_dir/scores.json. The last batch is padded to batch_size with its
        last image and scored on its valid rows. save_panels writes the
        reference's comparison panels (GT | rec | thumb | residual | aligned
        residual) as images_for_vis/val_XXXX.png."""
        ds = EvalImageDataset(data_root, size=self.cfg.pifu.load_size)
        agg: dict[str, list] = {}
        seen = 0
        t0 = time.perf_counter()
        for bi, batch in enumerate(ds.iter_batches(batch_size)):
            if max_images and seen >= max_images:
                break
            valid = len(batch["img_path"])
            imgs = torch.from_numpy(_pad_batch(batch["image"], batch_size)).to(self.device)
            out = self.image2image(imgs)
            rec = out["res_render_out"] if "res_render_out" in out else out
            if save_panels:
                rows = {"gt": imgs, "rec": adaptive_avg_pool(rec["gen_imgs"], imgs.shape[-1]),
                        "thumb": rec["gen_thumb_imgs"]}
                if "ref_info" in out:
                    rows["residual"] = out["ref_info"]["orig_res_gt"]
                if "aligned_res" in out:
                    rows["aligned_res"] = out["aligned_res"]
                image_io.save_panel(self.work_dir / "images_for_vis" / f"val_{bi:04d}.png",
                                    {k: v.float().cpu().numpy() for k, v in rows.items()})
            for k, v in self._scores(rec["gen_imgs"], imgs).items():
                agg.setdefault(k, []).extend(v[:valid].float().cpu().tolist())
            seen += valid
        scores = {k: float(np.mean(v)) for k, v in agg.items()}
        scores["num_images"] = seen
        scores["sec_per_image"] = (time.perf_counter() - t0) / max(seen, 1)
        self._append_scores(scores)
        return scores

    # ------------------------------------------------- optimisation inversion

    def project_images(
        self,
        data_root: str | Path,
        steps: int = 300,
        lr: float = 5e-3,
        pti_steps: int = 0,
        wspace: bool = False,
        batch_size: int = 1,
        max_images: int | None = None,
        seed: int = 0,
    ) -> list[dict]:
        """Optimisation inversion over a folder (reference Projectors.project,
        projectors.py:129-330): per batch, the pose head's camera, `project`
        from the mean latents (latent noise from a generator seeded seed +
        batch index), then PTI if pti_steps. Writes
        projection/<stem>/latent_in.npz (keys renderer, decoder, final_loss,
        as the JAX runner), rec.png (the reconstruction, through the field
        kernel) and, with PTI, pti_g.pt (the tuned generator's state_dict; the
        runner's generator is restored after each batch)."""
        from e3dge_torch.training.projector import project, pti

        ds = EvalImageDataset(data_root, size=self.cfg.pifu.load_size)
        out_root = self.work_dir / "projection"
        g = self.model.generator
        results, seen = [], 0
        for bi, batch in enumerate(ds.iter_batches(batch_size)):
            if max_images and seen >= max_images:
                break
            imgs = torch.from_numpy(batch["image"]).to(self.device)
            noise = self.make_noise(imgs.shape[0])
            with torch.no_grad():
                cam = self.model.image2camsettings(imgs)
            gen = torch.Generator(self.device).manual_seed(seed + bi)
            latents, losses = project(self.model, self.mean_latents, imgs, cam, gen, steps=steps, lr=lr,
                                      lpips_fn=self.lpips_fn, wspace=wspace, noise=noise)
            original = {k: v.clone() for k, v in g.state_dict().items()} if pti_steps > 0 else None
            try:
                if pti_steps > 0:
                    pti(self.model, latents, imgs, cam, steps=pti_steps, lpips_fn=self.lpips_fn, noise=noise)
                rec = self.model.latent2image(latents, cam, noise=noise)["gen_imgs"].float().cpu().numpy()
                final = float(losses[-1])
                for i, name in enumerate(batch["img_path"]):
                    d = out_root / Path(name).stem
                    d.mkdir(parents=True, exist_ok=True)
                    np.savez(d / "latent_in.npz", renderer=latents[0][i].cpu().numpy(),
                             decoder=latents[1][i].cpu().numpy(), final_loss=final)
                    image_io.save_image_grid(d / "rec.png", rec[i : i + 1])
                    if pti_steps > 0:
                        torch.save({k: v.detach().cpu() for k, v in g.state_dict().items()}, d / "pti_g.pt")
                    results.append({"name": Path(name).stem, "final_loss": final})
            finally:
                if original is not None:
                    g.load_state_dict(original)
            seen += imgs.shape[0]
        return results

    def validation_from_latents(
        self,
        data_root: str | Path,
        projection_root: str | Path | None = None,
        batch_size: int = 4,
        max_images: int | None = None,
        use_pti: bool = False,
    ) -> dict[str, Any]:
        """Validation from saved projection latents instead of the encoder
        (the reference's --inference_projection_validation, trainer.py:
        355-379): images with a `<stem>/latent_in.npz` under projection_root
        are rendered at the pose head's camera, with that image's PTI
        generator (`pti_g.pt`, batch 1 only) when use_pti, and scored; the
        means go to scores.json with projection_validation true."""
        proj_root = Path(projection_root) if projection_root else self.work_dir / "projection"
        ds = EvalImageDataset(data_root, size=self.cfg.pifu.load_size)
        g = self.model.generator
        agg: dict[str, list] = {}
        seen = 0
        for batch in ds.iter_batches(batch_size):
            if max_images and seen >= max_images:
                break
            stems = [Path(n).stem for n in batch["img_path"]]
            keep = [i for i, s in enumerate(stems) if (proj_root / s / "latent_in.npz").exists()]
            if not keep:
                continue
            if use_pti and len(keep) != 1:
                raise ValueError("use_pti loads one PTI generator per image: it needs batch_size=1")
            imgs = torch.from_numpy(batch["image"][keep]).to(self.device)
            lat = [np.load(proj_root / stems[i] / "latent_in.npz") for i in keep]
            latents = [torch.from_numpy(np.stack([x[k] for x in lat])).to(self.device) for k in ("renderer", "decoder")]
            original = None
            if use_pti:
                original = {k: v.clone() for k, v in g.state_dict().items()}
                g.load_state_dict(torch.load(proj_root / stems[keep[0]] / "pti_g.pt", map_location=self.device,
                                             weights_only=True))
            try:
                with torch.no_grad():
                    cam = self.model.image2camsettings(imgs)
                pred = self.model.latent2image(latents, cam, noise=self.make_noise(len(keep)))["gen_imgs"]
            finally:
                if original is not None:
                    g.load_state_dict(original)
            for k, v in self._scores(pred, imgs).items():
                agg.setdefault(k, []).extend(v.float().cpu().tolist())
            seen += len(keep)
        scores: dict[str, Any] = {k: float(np.mean(v)) for k, v in agg.items()}
        scores["num_images"] = seen
        scores["projection_validation"] = True
        self._append_scores(scores)
        return scores

    # ------------------------------------------------------------ checkpoints

    def save_checkpoint(self, state=None, name: str = "latest", d_state=None) -> Path:
        """work_dir/models_<name>/ with variables.pt (the model's whole
        state_dict, BatchNorm statistics included), and state.pt (a
        `TrainState`'s step, optimizer and EMA) and d_state.pt (a DState, or
        a dict of states or None, as the trainer's {"full", "volume"}) when
        given; an existing models_<name> is rotated to models_<name>_old
        first (reference base_runner.py:277-284)."""
        path = self.work_dir / f"models_{name}"
        old = self.work_dir / f"models_{name}_old"
        if path.exists():
            if old.exists():
                shutil.rmtree(old)
            path.rename(old)
        path.mkdir(parents=True)
        torch.save(self.model.state_dict(), path / "variables.pt")
        if state is not None:
            torch.save(state.state_dict(), path / "state.pt")
        if d_state is not None:
            torch.save(_saved(d_state), path / "d_state.pt")
        return path

    def load_checkpoint(self, name: str = "latest", state_template=None, d_template=None):
        """The model's variables from work_dir/models_<name>, or from `name`
        when it is a directory. With templates (states built as the saving
        run's: a fresh `create_train_state`, a DState or a dict of them) the
        saved training states are restored into them. Returns (state,
        d_state), each None where the checkpoint or the template lacks it.
        A directory of the earlier layout (`<module>.pt` files) warm-starts
        the variables only (`utils.checkpoint.warm_start_checkpoint`)."""
        from e3dge_torch.utils.checkpoint import warm_start_checkpoint

        cand = Path(name).expanduser()
        path = cand if cand.is_dir() else self.work_dir / f"models_{name}"

        def load(file: str):
            return torch.load(path / file, map_location=self.device, weights_only=True)

        if not (path / "variables.pt").is_file():
            warm_start_checkpoint(self.model, path)
            return None, None
        self.model.load_state_dict(load("variables.pt"))
        state = d_state = None
        if state_template is not None and (path / "state.pt").is_file():
            state_template.load_state_dict(load("state.pt"))
            state = state_template
        if d_template is not None and (path / "d_state.pt").is_file():
            d_state = _restore(d_template, load("d_state.pt"))
        return state, d_state


def _saved(tree):
    """A state, or a dict of states or None, as its state_dicts."""
    if isinstance(tree, dict):
        return {k: _saved(v) for k, v in tree.items()}
    return None if tree is None else tree.state_dict()


def _restore(template, saved):
    """`saved` (from `_saved`) loaded into the template's states in place;
    returns the template, or None where either side has nothing."""
    if template is None or saved is None:
        return None
    if isinstance(template, dict):
        return {k: _restore(v, saved.get(k)) for k, v in template.items()}
    template.load_state_dict(saved)
    return template


def _pad_batch(images: np.ndarray, batch_size: int) -> np.ndarray:
    """A ragged batch padded to batch_size by repeating its last image."""
    if len(images) >= batch_size:
        return images
    return np.concatenate([images, np.repeat(images[-1:], batch_size - len(images), axis=0)], axis=0)
