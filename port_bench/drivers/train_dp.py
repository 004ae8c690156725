"""Closed-loop stage-2.2 training over the ranks of a data-parallel world,
one rank per card, as the released training runs it: back-to-back
iterations of the loop body of `e3dge_torch.training.train.run` on
`mesh.init_distributed`'s world at the global batch (the configuration's
`train.batch`, each rank taking its rows). The iteration, its seeding and
the three checked iterations are `drivers/train.py`'s.

This process is rank 0. `setup` starts ranks 1..n-1 itself, one process per
card (`python -m port_bench.drivers.train_dp <spec> <rank>`, their output on
standard error), joins them in one process group (a file:// rendezvous) and
builds the same training object on every rank. Before each iteration rank 0
posts on a TCP store on localhost whether it runs, and every peer runs
exactly the iterations posted: agreeing when the window ends costs one store
write per iteration on rank 0 and no device synchronisation. The cards are
synchronised at the window's start (a barrier ends the set-up) and at its
end: an iteration ends in `reduce_metrics`' all-reduce, which completes on
rank 0 only after every rank has done all of that iteration's work.

A peer that exits before `release`, or a run past RUN_LIMIT_S (the window's
seconds besides), ends every rank and this process with exit code 1 and no
result; a peer whose rank 0 is gone exits. After its last iteration each
peer posts its peak memory and the forbidden modules (`run.FORBIDDEN`, by
whole top-level names) it holds; `release` ends the peers and the process
group, and fails the run, so that no result is printed, where a peer
reports one or reports nothing. `check` then runs the frozen one-rank reference at the global
batch on rank 0's card: by the port's contract (`parallel/mesh.py`) n ranks
at a global batch B compute what one process computes at B.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from port_bench import faults, traffic
from port_bench.drivers import train as one_card
from port_bench.manifest import ROOT, build_config
from port_bench.run import forbidden_modules
from port_bench.tracing import span
from port_bench.weights import seed_model_, seed_perceptual_, sub_seed

# set-up, window and traced segment end within this many seconds besides the
# window's, or every rank is ended
RUN_LIMIT_S = 240.0
# the longest a peer waits for rank 0's next word, and rank 0 for the peers to end
STORE_TIMEOUT_S = 300.0
PEER_EXIT_S = 60.0
HOST = "127.0.0.1"


class Driver(one_card.Driver):
    def __init__(self, cell: dict, seed: int, device, program_cfg: dict, rank: int = 0):
        super().__init__(cell, seed, device, program_cfg)
        world = cell["config"]["world"]
        self.cell, self.rank = cell, rank
        self.size, self.sp = world["dp"] * world["sp"], world["sp"]
        self.backend = world["backend"] if self.device.type == "cuda" else "gloo"
        # units are iterations at the global batch; a rank's call takes its rows
        self.call_batch = self.batch // world["dp"]
        # each rank gets the share of the host's cores that one card's machine has
        self.threads = max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // self.size))
        self.world = self.store = None
        self.peers: list[subprocess.Popen] = []
        self.posts, self.post_s = 0, 0.0

    # ------------------------------------------------------------ the world

    def _join(self, init_method: str) -> None:
        """This rank's `World` from `mesh.init_distributed`, given the
        launcher's variables for the length of the call."""
        from e3dge_torch.parallel import mesh

        keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
        saved = {k: os.environ.get(k) for k in keys}
        os.environ.update(RANK=str(self.rank), WORLD_SIZE=str(self.size), LOCAL_RANK=str(self.rank))
        try:
            self.world = mesh.init_distributed(self.backend, device=self.device.type, init_method=init_method,
                                               sp=self.sp)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self.device = self.world.device

    def _build_program(self) -> dict:
        """`drivers/train.py`'s training object of the port, on this rank's
        world as `train.run` builds it: the replicas start from rank 0's
        parameters and mean latents, the steps and the reals take the world."""
        from e3dge_torch import config as C
        from e3dge_torch.models.discriminator import Discriminator
        from e3dge_torch.models.e3dge import E3DGE, LatentMeans
        from e3dge_torch.parallel import mesh
        from e3dge_torch.training import perceptual, steps
        from e3dge_torch.training.data import ImageFolderDataset

        tr, dev, seed, world = self.tr, self.device, self.seed, self.world
        with torch.device(dev):
            model = E3DGE(build_config(C, self.cfg_prog), device=dev)
            d = Discriminator(tr["d_res"]).to(dev)  # its blur kernels are made on the host
            lp, idl = perceptual.LPIPS(), perceptual.IDLoss()
        seed_model_(model, sub_seed(seed, traffic.MODEL))
        seed_model_(d, sub_seed(seed, traffic.DISC))
        seed_perceptual_(lp, sub_seed(seed, traffic.LPIPS_NET))
        seed_perceptual_(idl.facenet, sub_seed(seed, traffic.ARCFACE_NET))
        mesh.replicate(model, world)
        mesh.replicate(d, world)
        for net in (lp, idl):
            net.eval().requires_grad_(False)
        ml = LatentMeans(*traffic.mean_latents(seed, self.cfg_prog, dev))
        mesh.broadcast_(list(ml), world)
        lam = tr["lambdas"]
        state = steps.create_train_state(model, steps.stage22_trainable(tr["fix_ada"]), tr["lr"], tr["optimizer"],
                                         ema=tr["ema"])
        r = tr["d_reg_every"]
        d_state = steps.create_d_state(d, tr["lr"] * r / (r + 1), tr["optimizer"])
        d_step = steps.make_full_d_step(dict(discriminator_lambda=tr["discriminator_lambda"], r1=tr["r1"]), d_state,
                                        r, world)
        schedule = steps.pose_curriculum() if tr["pose_curriculum"] else (lambda step: 1.0)
        e_step = steps.make_cycle_step(model, lam, state, lp if lam.get("lpips_lambda", 0) > 0 else None,
                                       idl if lam.get("id_lambda", 0) > 0 else None, schedule,
                                       tr["use_ref_view_weight"], d_fn=d_state.d, world=world)
        ds = ImageFolderDataset(self.reals_dir, size=tr["d_res"], thumb_size=min(64, tr["d_res"]),
                                rng=np.random.RandomState(sub_seed(seed, traffic.REALS, 1) % 2**32))
        return {"model": model, "ml": ml, "state": state, "d_state": d_state, "d_step": d_step, "e_step": e_step,
                "steps": steps, "world": world,
                "reals": ds.iter_batches(self.batch, sub_seed(seed, traffic.REALS, 2) % 2**32, world)}

    def _iteration(self, obj: dict, it: int) -> tuple[dict, dict]:
        """`drivers/train.py`'s iteration on `obj`'s world (none for the
        reference): the global batch, each rank's rows."""
        dev, b = self.device, self.batch
        gen_d, gen_e = (traffic.stream_generator(dev, self.seed, it, s) for s in (one_card.D_STREAM,
                                                                                   one_card.E_STREAM))
        with span("d_producer"):
            fakes, _ = obj["steps"].full_d_batch(obj["model"], obj["ml"], b, self.tr["d_res"], gen_d,
                                                 obj.get("world"))
        with span("d_reals"):
            reals = torch.from_numpy(next(obj["reals"])["image"]).to(dev)
        with span("d_step"):
            dm = obj["d_step"](reals, fakes)
        with span("e_step"):
            em = obj["e_step"](obj["ml"], b, gen_e)
        return dm, em

    # ------------------------------------------------------------ rank 0

    def setup(self) -> None:
        from e3dge_torch.parallel import mesh

        t = time.perf_counter()
        self.deadline = time.monotonic() + RUN_LIMIT_S
        self.saved_threads = torch.get_num_threads()
        torch.set_num_threads(self.threads)
        self.tmp = tempfile.mkdtemp(prefix="port_bench_dp_")
        self.reals_dir = tempfile.mkdtemp(prefix="port_bench_reals_")
        self.store = torch.distributed.TCPStore(HOST, 0, None, True, timedelta(seconds=STORE_TIMEOUT_S),
                                                wait_for_workers=False)
        init_method = "file://" + os.path.join(self.tmp, "rendezvous")
        spec = {"cell": self.cell, "seed": self.seed, "device": self.device.type, "program_cfg": self.cfg_prog,
                "reals_dir": self.reals_dir, "init_method": init_method, "port": self.store.port,
                "threads": self.threads, "faults": list(faults.PLANTED)}
        spec_path = os.path.join(self.tmp, "spec.json")
        Path(spec_path).write_text(json.dumps(spec))
        self.done = threading.Event()
        for r in range(1, self.size):
            self.peers.append(subprocess.Popen([sys.executable, "-m", "port_bench.drivers.train_dp", spec_path, str(r)],
                                               cwd=ROOT, stdin=subprocess.PIPE, stdout=2))
        threading.Thread(target=self._watch, daemon=True).start()
        traffic.write_reals(self.reals_dir, self.traffic["reals"], self.tr["d_res"], self.seed)
        t_reals = time.perf_counter()
        self._join(init_method)
        self.obj = self._build_program()
        t_build = time.perf_counter()
        self.read = self._checked_steps(self.obj)
        mesh.barrier(self.world)
        self.setup_parts = {"reals_s": t_reals - t, "build_weights_s": t_build - t_reals,
                            "checked_steps_s": time.perf_counter() - t_build}
        self.it = one_card.CHECKED_STEPS

    def _watch(self) -> None:
        """End every rank and this process when a peer exits before
        `release` or the run passes its time limit. `release` sets `done`
        before it lets the peers end, so a peer seen ended with `done` set
        is `release`'s to judge."""
        while not self.done.wait(0.5):
            dead = [(r, p.returncode) for r, p in enumerate(self.peers, 1) if p.poll() is not None]
            if (dead or time.monotonic() > self.deadline) and not self.done.is_set():
                why = f"rank {dead[0][0]} exited with code {dead[0][1]}" if dead else "the run passed its time limit"
                print(f"train_dp: {why}; ending every rank", file=sys.stderr, flush=True)
                self._end_peers()
                os._exit(1)

    def _end_peers(self) -> None:
        for p in self.peers:
            if p.poll() is None:
                p.kill()
        for p in self.peers:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                pass
            p.stdin.close()

    def _post(self, go: bool) -> None:
        """Tell the peers whether iteration `self.it` runs."""
        t = time.perf_counter()
        self.store.set(f"go/{self.it}", "1" if go else "0")
        self.post_s += time.perf_counter() - t
        self.posts += 1

    def window(self, seconds: float) -> dict:
        self.deadline += seconds
        n = 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            self._post(True)
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
                self._post(True)
                self._iteration(self.obj, self.it)
                self.it += 1

        return fn, set(one_card.SPANS), n, self.obj["model"], ()

    def release(self) -> None:
        """Stop the peers after the iterations run so far, end the process
        group, and wait for every peer; a peer that did not end cleanly
        fails the run."""
        from e3dge_torch.parallel import mesh

        self.done.set()
        self._post(False)
        mesh.shutdown(self.world)
        end = time.monotonic() + PEER_EXIT_S
        codes = []
        for p in self.peers:
            try:
                codes.append(p.wait(max(1.0, end - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self._end_peers()
        posted = lambda key: json.loads(self.store.get(key)) if self.store.check([key]) else None  # noqa: E731
        peaks = [posted(f"peak/{r}") for r in range(1, self.size)]
        mods = {r: posted(f"modules/{r}") for r in range(1, self.size)}
        print(f"train_dp: peers' peak memory {peaks} bytes, forbidden modules {mods}; {self.posts} posts, "
              f"{1e6 * self.post_s / max(self.posts, 1):.1f} us each", file=sys.stderr, flush=True)
        bad = {r: m for r, m in mods.items() if m != []}
        self.store = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        torch.set_num_threads(self.saved_threads)
        del self.obj
        if codes != [0] * len(codes):
            raise RuntimeError(f"train_dp: the peers exited with codes {codes}")
        if bad:
            found = "; ".join(f"rank {r}: " + (", ".join(m) if m else "no report") for r, m in bad.items())
            print(f"forbidden modules loaded: {found}", file=sys.stderr, flush=True)
            raise RuntimeError(f"train_dp: a peer loaded a forbidden module or did not report its modules ({found})")

    def check(self, count_flops: bool = False) -> list[tuple[str, float, float | None]]:
        """The reference's three iterations at the global batch, compared
        with rank 0's readings (the losses and gradients are the world's
        means, the changes each replica's); FLOPs per card."""
        out = super().check(count_flops)
        if self.flops:
            self.flops /= self.size
        return out


# ---------------------------------------------------------------- a peer


def _exit_with_rank0() -> None:
    """Rank 0 holds this process's standard input open: end at its EOF (read
    from the descriptor: a daemon thread inside `sys.stdin`'s buffer would
    hold its lock at the interpreter's exit)."""
    while os.read(0, 4096):
        pass
    os._exit(1)


def peer(spec_path: str, rank: int) -> None:
    """Rank `rank` of the run that wrote `spec_path`: the same set-up as
    rank 0's, then the iterations rank 0 posts."""
    from e3dge_torch.parallel import mesh

    threading.Thread(target=_exit_with_rank0, daemon=True).start()
    spec = json.loads(Path(spec_path).read_text())
    flags = spec["cell"]["config"]["torch_flags"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_allow_tf32"]
    torch.set_num_threads(spec["threads"])
    for name in spec["faults"]:
        faults.BY_NAME[name](setattr)
    drv = Driver(spec["cell"], spec["seed"], spec["device"], spec["program_cfg"], rank)
    drv.reals_dir = spec["reals_dir"]
    store = torch.distributed.TCPStore(HOST, spec["port"], None, False, timedelta(seconds=STORE_TIMEOUT_S))
    drv._join(spec["init_method"])
    try:
        obj = drv._build_program()
        drv._checked_steps(obj)
        mesh.barrier(drv.world)
        it = one_card.CHECKED_STEPS
        while store.get(f"go/{it}") == b"1":
            drv._iteration(obj, it)
            it += 1
        peak = 0
        if drv.device.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        store.set(f"peak/{rank}", str(peak))
        store.set(f"modules/{rank}", json.dumps(forbidden_modules()))
    finally:
        mesh.shutdown(drv.world)


if __name__ == "__main__":
    peer(sys.argv[1], int(sys.argv[2]))
