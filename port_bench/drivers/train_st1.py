"""Closed-loop stage-1 training: back-to-back iterations of the stage-1 loop
body of `e3dge_torch.training.train.run` (`metrics = step(ml, bs, gen_e)`):
`steps.make_stage1_step`'s train step, E0 trained through the frozen
StyleSDF on a frozen-GAN batch that each iteration draws on the card from
its own generator, seeded from (--seed, iteration, E_STREAM) as `train.run`
seeds it. No D and no reals: the released stage-1 job trains none.

Set-up builds one training object (model, E0's optimizer state, the
perceptual nets) and drives its first three iterations, reading each step's
loss and loss terms, the first gradient of every E0 leaf from the
optimizer's state after one step (Adam's first moment over 1 - beta1) and
each leaf's change after three; the window goes on with the same object.
After the window the frozen reference (`reference/training/stage1.py`)
builds the same from the same seed, runs the same three iterations, and the
two are compared by `compare`: the E side of `drivers/train.py::compare`,
whose D side needs the D leaves that this cell has not.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

from port_bench import traffic
from port_bench.drivers.train import ADAM_B1, CHECKED_STEPS, E_STREAM, EXCLUDE_SHARE
from port_bench.manifest import build_config
from port_bench.tracing import span
from port_bench.weights import seed_model_, seed_perceptual_, sub_seed

# the stage-1 step's terms that enter its loss (`stage1_loss`'s metrics at
# the cell's lambdas), each compared on its own
E_TERMS = ("loss_l2", "loss_lpips", "loss_id", "latent_gt", "sdf_rec_loss", "surf_rec_loss",
           "surface_norm_rec_loss", "eikonal_term", "thumb_rec")
SPANS = ("e_step",)
# where each side keeps its stage-1 step: the port's steps module, the reference's stage-1 file
STEPS = {"e3dge_torch": "e3dge_torch.training.steps", "port_bench.reference": "port_bench.reference.training.stage1"}


class Driver:
    def __init__(self, cell: dict, seed: int, device, program_cfg: dict):
        self.seed, self.device = seed, torch.device(device)
        wl, conf = cell["workload"], cell["config"]
        self.traffic, self.limits, self.tr = wl["traffic"], wl["limits"], conf["train"]
        self.batch = self.tr["batch"]
        # units are iterations; one call is one iteration at `batch` rows
        self.call_batch, self.units_per_call = self.batch, 1
        self.cfg_ref, self.cfg_prog = conf["e3dge"], program_cfg
        self.flops = None
        self.it = 0

    # ------------------------------------------------------------ building

    def _build(self, pkg: str, cfg_dict: dict, config_module) -> dict:
        """The training object from `pkg`'s modules (the port's or the
        reference's), seeded by the benchmark."""
        models = importlib.import_module(f"{pkg}.models.e3dge")
        perceptual = importlib.import_module(f"{pkg}.training.perceptual")
        steps = importlib.import_module(STEPS[pkg])
        tr, dev, seed = self.tr, self.device, self.seed
        cfg = build_config(config_module, cfg_dict)
        with torch.device(dev):
            model = models.E3DGE(cfg, device=dev)
            lp, idl = perceptual.LPIPS(), perceptual.IDLoss()
        seed_model_(model, sub_seed(seed, traffic.MODEL))
        seed_perceptual_(lp, sub_seed(seed, traffic.LPIPS_NET))
        seed_perceptual_(idl.facenet, sub_seed(seed, traffic.ARCFACE_NET))
        for net in (lp, idl):
            net.eval().requires_grad_(False)
        lam = tr["lambdas"]
        state = steps.create_train_state(model, steps.STAGE1_TRAINABLE, tr["lr"], tr["optimizer"], ema=tr["ema"])
        schedule = steps.pose_curriculum() if tr["pose_curriculum"] else (lambda step: 1.0)
        e_step = steps.make_stage1_step(model, lam, state, lp if lam.get("lpips_lambda", 0) > 0 else None,
                                        idl if lam.get("id_lambda", 0) > 0 else None, schedule)
        return {"model": model, "ml": models.LatentMeans(*traffic.mean_latents(seed, cfg_dict, dev)),
                "state": state, "e_step": e_step}

    def _iteration(self, obj: dict, it: int) -> dict:
        """train.run's stage-1 loop body at iteration `it`."""
        gen_e = traffic.stream_generator(self.device, self.seed, it, E_STREAM)
        with span("e_step"):
            return obj["e_step"](obj["ml"], self.batch, gen_e)

    def _checked_steps(self, obj: dict, counter=None) -> dict:
        """Run the first CHECKED_STEPS iterations on `obj` and read them:
        losses and terms per step, first gradients and changes per leaf;
        with `counter`, each iteration's FLOPs, their mean kept as
        `self.flops`."""
        params = dict(obj["state"].params)
        start = {k: p.detach().clone() for k, p in params.items()}
        read = {"e_loss": [], "e_terms": [], "grad": {}, "change": {}}
        flops = []
        for it in range(CHECKED_STEPS):
            with counter() if counter is not None else contextlib.nullcontext() as c:
                em = self._iteration(obj, it)
            if c is not None:
                flops.append(c.total)
            read["e_loss"].append(float(em["loss"]))
            read["e_terms"].append({k: float(em[k]) for k in E_TERMS if k in em})
            if it == 0:
                for k, p in params.items():
                    st = obj["state"].optimizer.state.get(p)
                    read["grad"][k] = float(st["mu"].norm()) / (1 - ADAM_B1) if st else 0.0
        for k, p in params.items():
            read["change"][k] = float((p.detach() - start[k]).norm())
        if flops:
            self.flops = float(np.mean(flops))
        return read

    # ------------------------------------------------------------ the program

    def setup(self) -> None:
        from e3dge_torch import config as C

        t = time.perf_counter()
        self.obj = self._build("e3dge_torch", self.cfg_prog, C)
        t_build = time.perf_counter()
        self.read = self._checked_steps(self.obj)
        self.setup_parts = {"build_weights_s": t_build - t, "checked_steps_s": time.perf_counter() - t_build}
        self.it = CHECKED_STEPS

    def window(self, seconds: float) -> dict:
        n = 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            self._iteration(self.obj, self.it)
            self.it += 1
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        return {"attempted": n, "failed": 0, "wall_s": wall, "units": n,
                "metrics": {"train_imgs_per_s": n * self.batch / wall}}

    def traced(self):
        n = self.traffic["traced"]

        def fn():
            for _ in range(n):
                self._iteration(self.obj, self.it)
                self.it += 1

        return fn, set(SPANS), n, self.obj["model"], ()

    def release(self) -> None:
        del self.obj

    # ---------------------------------------------------------- the reference

    def check(self, count_flops: bool = False) -> list[tuple[str, float, float | None]]:
        from port_bench.reference import config as RC
        from port_bench.yardstick import flop_counter

        ref = self._build("port_bench.reference", self.cfg_ref, RC)
        want = self._checked_steps(ref, flop_counter if count_flops else None)
        del ref
        nums = compare(self.read, want)
        return [(name, nums[name], self.limits.get(name)) for name in sorted(nums)]


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, as `drivers/train.py::compare` computes them for
    its E side: the largest relative gap of a step's loss over the three
    steps; by the worst E0 leaf the gap between the two sides' norms of the
    first gradient and of the change after three steps, each over the larger
    of the reference leaf's norm and the median leaf's (leaves whose
    reference gradient is under EXCLUDE_SHARE of the median leaf's left out
    of the change); and `e_term_gap`, the largest relative gap of one of
    E_TERMS over the three steps, a term that one side lacks reading 1, with
    each term's own largest gap reported beside it, not judged."""
    out = {}
    for term in sorted({k for step in want["e_terms"] for k in step} | {k for step in got["e_terms"] for k in step}):
        out[f"e_term.{term}"] = max(
            abs(g[term] - w[term]) / max(abs(w[term]), 1e-12) if term in g and term in w else 1.0
            for g, w in zip(got["e_terms"], want["e_terms"]))
    out["e_term_gap"] = max(v for k, v in out.items() if k.startswith("e_term."))
    out["e_loss_gap"] = max(abs(g - w) / max(abs(w), 1e-12) for g, w in zip(got["e_loss"], want["e_loss"]))
    keys = list(want["grad"])
    med_g = float(np.median([want["grad"][k] for k in keys]))
    med_c = float(np.median([want["change"][k] for k in keys]))
    out["e_grad_gap"] = max(abs(got["grad"][k] - want["grad"][k]) / max(want["grad"][k], med_g, 1e-30) for k in keys)
    moved = [k for k in keys if want["grad"][k] >= EXCLUDE_SHARE * med_g]
    out["e_change_gap"] = max(abs(got["change"][k] - want["change"][k]) / max(want["change"][k], med_c, 1e-30)
                              for k in moved)
    return out
