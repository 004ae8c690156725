"""Closed-loop single-image inversion through `Runner.image2image`.

One client sends request i (its `batch` distinct seeded photos on the host,
and their decoder noise drawn on the card from the seed) after request i-1
has returned; a request runs from handing the host photos to
`Runner.image2image` until its 1024^2 `gen_imgs` is on the host. The answers
of a sample of the window's requests (a reservoir sample drawn from the seed)
are kept and, after the window, rebuilt by the frozen reference.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench import traffic
from port_bench.manifest import PKG, build_config
from port_bench.weights import seed_model_, sub_seed

# the submodules whose forwards open a span in a traced segment
STAGE_SPANS = ("encoder", "local.image_filter", "generator.decoder")
REQUEST_SPAN = "request"
# request indices of the warm-up and the traced segment: out of the window's range
WARM_BASE, TRACE_BASE = 2**40, 2**41
WORK_DIR = PKG / ".work"


class Driver:
    def __init__(self, cell: dict, seed: int, device, program_cfg: dict):
        self.seed, self.device = seed, torch.device(device)
        wl = cell["workload"]
        self.traffic, self.limits = wl["traffic"], wl["limits"]
        self.batch = self.traffic["batch"]
        # units are photos; a call inverts `batch` of them
        self.call_batch = self.units_per_call = self.batch
        self.cfg_ref = cell["config"]["e3dge"]  # the configuration as stated
        self.cfg_prog = program_cfg             # as the program runs it (the control's precision, if asked)
        self.sizes = traffic.noise_sizes(self.cfg_prog["decoder"])
        self.kept: dict[int, tuple[int, dict]] = {}
        self.flops = None

    # ------------------------------------------------------------ the program

    def setup(self) -> None:
        from e3dge_torch import config as C
        from e3dge_torch.models.e3dge import E3DGE, LatentMeans
        from e3dge_torch.runner import Runner

        t = time.perf_counter()
        cfg = build_config(C, self.cfg_prog)
        with torch.device(self.device):
            model = E3DGE(cfg, device=self.device)
        t_build = time.perf_counter()
        seed_model_(model, sub_seed(self.seed, traffic.MODEL))
        ml = LatentMeans(*traffic.mean_latents(self.seed, self.cfg_prog, self.device))
        self.runner = Runner(model, ml, self.device, work_dir=WORK_DIR)
        self.photos = traffic.Photos(self.seed, self.batch, self.traffic["photo_res"], self.traffic["pool"])
        t_inputs = time.perf_counter()
        for k in range(self.traffic["warmup"]):
            self._request(WARM_BASE + k)
        self.setup_parts = {"build_s": t_build - t, "weights_inputs_s": t_inputs - t_build,
                            "warmup_s": time.perf_counter() - t_inputs}

    def _request(self, i: int):
        photos = self.photos.request(i)
        noise = traffic.request_noise(self.seed, i, self.batch, self.sizes, self.device)
        t0 = time.perf_counter()
        out = self.runner.image2image(photos, noise)
        img = out["res_render_out"]["gen_imgs"].cpu()
        return out, img, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        k = self.traffic["sample"]
        rng = np.random.RandomState(sub_seed(self.seed, traffic.SAMPLE) % 2**32)
        lat, n = [], 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            slot = n if n < k else rng.randint(0, n + 1)
            out, img, dt = self._request(n)
            lat.append(dt)
            if slot < k:  # left on the card until the window closes: no copy inside it
                self.kept[slot] = (n, _answers(out, img, host=False))
            n += 1
        wall = time.perf_counter() - t_start
        self.kept = {s: (i, {name: t.cpu() for name, t in a.items()}) for s, (i, a) in self.kept.items()}
        return {"attempted": n, "failed": 0, "wall_s": wall, "units": n * self.batch,
                "metrics": {"inversions_per_s": n * self.batch / wall,
                            "inversion_p95_ms": float(np.percentile(lat, 95)) * 1e3}}

    def traced(self):
        """(fn, span names, units, module spans' model and names) of the traced segment."""
        n = self.traffic["traced"]

        def fn():
            for j in range(n):
                with torch.profiler.record_function(REQUEST_SPAN):
                    self._request(TRACE_BASE + j)

        return fn, {REQUEST_SPAN, *STAGE_SPANS}, n * self.batch, self.runner.model, STAGE_SPANS

    def release(self) -> None:
        del self.runner

    # ---------------------------------------------------------- the reference

    def check(self, count_flops: bool = False) -> list[tuple[str, float, float | None]]:
        """Rebuild each kept request with the reference (f32, TF32 off) and
        return (name, worst reading, limit) per compared number."""
        from port_bench.reference import config as RC
        from port_bench.reference.models.e3dge import E3DGE, LatentMeans
        from port_bench.yardstick import flop_counter

        cfg = build_config(RC, self.cfg_ref)
        with torch.device(self.device):
            ref = E3DGE(cfg, device=self.device)
        seed_model_(ref, sub_seed(self.seed, traffic.MODEL))
        ml = LatentMeans(*traffic.mean_latents(self.seed, self.cfg_ref, self.device))
        worst: dict[str, float] = {}
        for slot, (i, got) in sorted(self.kept.items(), key=lambda kv: kv[1][0]):
            photos = self.photos.request(i).to(self.device)
            noise = traffic.request_noise(self.seed, i, self.batch, self.sizes, self.device)
            counter = flop_counter() if count_flops and self.flops is None else None
            with torch.no_grad(), (counter or contextlib.nullcontext()):
                out = ref.image2image(photos, ml, noise=noise)
            if counter is not None:
                self.flops = counter.total / self.batch
            want = _answers(out, out["res_render_out"]["gen_imgs"].cpu())
            for name, gap in gaps(got, want).items():
                worst[name] = max(worst.get(name, 0.0), gap)
        return [(name, worst[name], self.limits.get(name)) for name in sorted(worst)]


def _answers(out: dict, img: torch.Tensor, host: bool = True) -> dict:
    """What a request answers and the comparison reads: the 1024^2 image (on
    the host already), the G0 thumb, and the W+ latents on the way to them,
    in f32; the thumb and latents on the host, or where they were made."""
    ref_info = out["ref_info"]
    r, d = ref_info["pred_latents"]
    thumb = ref_info["global_render_out"]["gen_thumb_imgs"].detach().float()
    latents = torch.cat([r.flatten(1), d.flatten(1)], 1).detach().float()
    return {"image": img.float(), "thumb": thumb.cpu() if host else thumb,
            "latents": latents.cpu() if host else latents}


def gaps(got: dict, want: dict) -> dict:
    """Per answer: the relative L2 gap ||got - want|| / ||want|| and the largest
    absolute gap."""
    out = {}
    for k in want:
        g, w = got[k].double(), want[k].double()
        if g.shape != w.shape or not torch.isfinite(g).all():
            out[f"{k}_rel"] = out[f"{k}_max"] = float("inf")
            continue
        out[f"{k}_rel"] = float((g - w).norm() / w.norm().clamp_min(1e-30))
        out[f"{k}_max"] = float((g - w).abs().max())
    return out
