"""Closed-loop stage-2.2 training: back-to-back iterations of the loop body
of `e3dge_torch.training.train.run` (the full-resolution D's fake producer
`full_d_batch`, a batch of reals from the port's `ImageFolderDataset`, the D
step, then the cycle step), each drawing from its own generator streams
seeded from (--seed, iteration, stream) as `train.run` seeds them.

Set-up builds one training object (model, optimizer and EMA state, the D and
its optimizer, the perceptual nets, the image stream) and drives its first
three iterations, reading each step's losses, the first gradient of every
trainable leaf from the optimizer's state after one step (Adam's first moment
over 1 - beta1) and each leaf's change after three; the window goes on with
the same object. After the window the frozen reference builds the same from
the same seed, runs the same three iterations, and the two are compared.
"""

from __future__ import annotations

import contextlib
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import traffic
from port_bench.manifest import build_config
from port_bench.tracing import span
from port_bench.weights import seed_model_, seed_perceptual_, sub_seed

D_STREAM, E_STREAM = 0, 2  # train.run's D_STREAM and E_STREAM
CHECKED_STEPS = 3
ADAM_B1 = 0.9
# a leaf whose reference gradient is below this share of the median leaf's
# moves by round-off alone under Adam: it is left out of the change compared
EXCLUDE_SHARE = 1e-3
# the cycle step's terms that enter its loss (`cycle_loss`'s metrics at the
# cell's lambdas): each is compared on its own, so a term left out or
# mis-wired shows even where its share of the loss is small (adv: 0.01 x)
E_TERMS = ("loss_l2", "loss_lpips", "loss_id", "loss_e_adv", "thumb_rec", "res_loss")
SPANS = ("d_producer", "d_reals", "d_step", "e_step")


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

    def _build(self, pkg: str, cfg_dict: dict, config_module, reals_dir: str) -> dict:
        """The training object from `pkg`'s modules (the port's or the
        reference's), seeded by the benchmark."""
        import importlib

        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        E3DGE, LatentMeans = mod("models.e3dge").E3DGE, mod("models.e3dge").LatentMeans
        steps, perceptual = mod("training.steps"), mod("training.perceptual")
        tr, dev, seed = self.tr, self.device, self.seed
        cfg = build_config(config_module, cfg_dict)
        with torch.device(dev):
            model = E3DGE(cfg, device=dev)
            d = mod("models.discriminator").Discriminator(tr["d_res"])
            lp, idl = perceptual.LPIPS(), perceptual.IDLoss()
        seed_model_(model, sub_seed(seed, traffic.MODEL))
        seed_model_(d, sub_seed(seed, traffic.DISC))
        seed_perceptual_(lp, sub_seed(seed, traffic.LPIPS_NET))
        seed_perceptual_(idl.facenet, sub_seed(seed, traffic.ARCFACE_NET))
        for net in (lp, idl):
            net.eval().requires_grad_(False)
        lam = tr["lambdas"]
        state = steps.create_train_state(model, steps.stage22_trainable(tr["fix_ada"]), tr["lr"], tr["optimizer"],
                                         ema=tr["ema"])
        r = tr["d_reg_every"]
        d_state = steps.create_d_state(d, tr["lr"] * r / (r + 1), tr["optimizer"])
        d_step = steps.make_full_d_step(dict(discriminator_lambda=tr["discriminator_lambda"], r1=tr["r1"]), d_state,
                                        r, None)
        schedule = steps.pose_curriculum() if tr["pose_curriculum"] else (lambda step: 1.0)
        e_step = steps.make_cycle_step(model, lam, state, lp if lam.get("lpips_lambda", 0) > 0 else None,
                                       idl if lam.get("id_lambda", 0) > 0 else None, schedule,
                                       tr["use_ref_view_weight"], d_fn=d_state.d)
        ds = mod("training.data").ImageFolderDataset(reals_dir, size=tr["d_res"], thumb_size=min(64, tr["d_res"]),
                                                     rng=np.random.RandomState(sub_seed(seed, traffic.REALS, 1) % 2**32))
        return {"model": model, "ml": LatentMeans(*traffic.mean_latents(seed, cfg_dict, dev)), "state": state,
                "d_state": d_state, "d_step": d_step, "e_step": e_step, "steps": steps,
                "reals": ds.iter_batches(self.batch, sub_seed(seed, traffic.REALS, 2) % 2**32)}

    def _iteration(self, obj: dict, it: int) -> tuple[dict, dict]:
        """train.run's loop body at iteration `it`."""
        dev, b = self.device, self.batch
        gen_d, gen_e = (traffic.stream_generator(dev, self.seed, it, s) for s in (D_STREAM, E_STREAM))
        with span("d_producer"):
            fakes, reals = obj["steps"].full_d_batch(obj["model"], obj["ml"], b, self.tr["d_res"], gen_d)
        with span("d_reals"):
            reals = torch.from_numpy(next(obj["reals"])["image"]).to(dev)
        with span("d_step"):
            dm = obj["d_step"](reals, fakes)
        with span("e_step"):
            em = obj["e_step"](obj["ml"], b, gen_e)
        return dm, em

    def _checked_steps(self, obj: dict, counter=None) -> dict:
        """Run the first CHECKED_STEPS iterations on `obj` and read them:
        losses per step, first gradients and changes per leaf."""
        e_params = dict(obj["state"].params)
        d_params = {f"d.{k}": p for k, p in obj["d_state"].d.named_parameters()}
        start = {k: p.detach().clone() for k, p in {**e_params, **d_params}.items()}
        read = {"e_loss": [], "d_loss": [], "e_terms": [], "grad": {}, "change": {}}
        flops = []
        for it in range(CHECKED_STEPS):
            ctx = counter() if counter is not None and it < 2 else contextlib.nullcontext()
            with ctx as c:
                dm, em = self._iteration(obj, it)
            if c is not None:
                flops.append(c.total)
            read["e_loss"].append(float(em["loss"]))
            read["e_terms"].append({k: float(em[k]) for k in E_TERMS if k in em})
            read["d_loss"].append(float(dm["d"]))
            if it == 0:
                for k, p in e_params.items():
                    st = obj["state"].optimizer.state.get(p)
                    read["grad"][k] = float(st["mu"].norm()) / (1 - ADAM_B1) if st else 0.0
                for k, p in d_params.items():
                    st = obj["d_state"].optimizer.state.get(p)
                    read["grad"][k] = float(st["mu"].norm()) / (1 - ADAM_B1) if st else 0.0
        for k, p in {**e_params, **d_params}.items():
            read["change"][k] = float((p.detach() - start[k]).norm())
        if flops:
            # iteration 0 carries the lazy R1 that every d_reg_every-th D step does
            self.flops = flops[1] + (flops[0] - flops[1]) / self.tr["d_reg_every"]
        return read

    # ------------------------------------------------------------ the program

    def setup(self) -> None:
        from e3dge_torch import config as C

        t = time.perf_counter()
        self.reals_dir = tempfile.mkdtemp(prefix="port_bench_reals_")
        traffic.write_reals(self.reals_dir, self.traffic["reals"], self.tr["d_res"], self.seed)
        t_reals = time.perf_counter()
        self.obj = self._build("e3dge_torch", self.cfg_prog, C, self.reals_dir)
        t_build = time.perf_counter()
        self.read = self._checked_steps(self.obj)
        self.setup_parts = {"reals_s": t_reals - t, "build_weights_s": t_build - t_reals,
                            "checked_steps_s": time.perf_counter() - t_build}
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

        try:
            ref = self._build("port_bench.reference", self.cfg_ref, RC, self.reals_dir)
            want = self._checked_steps(ref, flop_counter if count_flops else None)
            del ref
        finally:
            shutil.rmtree(self.reals_dir, ignore_errors=True)
        nums = compare(self.read, want)
        return [(name, nums[name], self.limits.get(name)) for name in sorted(nums)]


def compare(got: dict, want: dict) -> dict:
    """The numbers compared: per side (e: the trained E1 leaves, d: the D),
    the largest relative gap of a step's loss, and by the worst leaf the gap
    between the two sides' norms of the first gradient and of the change
    after three steps, each over the larger of the reference leaf's norm and
    the median leaf's. Leaves whose reference gradient is under
    EXCLUDE_SHARE of the median leaf's are left out of the change. For the
    cycle step also `e_term_gap`: the largest relative gap of one of its
    E_TERMS over the three steps, a term that one side lacks reading 1; each
    term's own largest gap is reported beside it, not judged."""
    out = {}
    for term in sorted({k for step in want["e_terms"] for k in step} | {k for step in got["e_terms"] for k in step}):
        out[f"e_term.{term}"] = max(
            abs(g[term] - w[term]) / max(abs(w[term]), 1e-12) if term in g and term in w else 1.0
            for g, w in zip(got["e_terms"], want["e_terms"]))
    out["e_term_gap"] = max(v for k, v in out.items() if k.startswith("e_term."))
    for side, loss in (("e", "e_loss"), ("d", "d_loss")):
        out[f"{side}_loss_gap"] = max(abs(g - w) / max(abs(w), 1e-12) for g, w in zip(got[loss], want[loss]))
        keys = [k for k in want["grad"] if k.startswith("d.") == (side == "d")]
        med_g = float(np.median([want["grad"][k] for k in keys]))
        med_c = float(np.median([want["change"][k] for k in keys]))
        out[f"{side}_grad_gap"] = max(abs(got["grad"][k] - want["grad"][k]) / max(want["grad"][k], med_g, 1e-30)
                                      for k in keys)
        moved = [k for k in keys if want["grad"][k] >= EXCLUDE_SHARE * med_g]
        out[f"{side}_change_gap"] = max(abs(got["change"][k] - want["change"][k]) /
                                        max(want["change"][k], med_c, 1e-30) for k in moved)
    return out
