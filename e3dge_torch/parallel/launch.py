"""Rank processes with a time limit: `spawn(fn, n, ...)` runs fn(world, *args)
in n fresh processes joined by a process group (a `file://` rendezvous, so
no port is taken), returns each rank's result, and fails loudly: a rank that
raises or dies fails the call, and when the time runs out every rank is
killed. The trainer's own launcher is torchrun
(`python -m torch.distributed.run`); this one serves the tests and the dry
run, which need the ranks' results and a hang that ends."""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.multiprocessing as mp


def _rank_main(fn, rank: int, n: int, args: tuple, init_method: str, device, sp: int, results) -> None:
    from e3dge_torch.parallel import mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    world = None
    try:
        world = mesh.init_distributed(device=device, init_method=init_method, sp=sp)
        results.put((rank, True, fn(world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        mesh.shutdown(world)


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def spawn(fn: Callable, n: int, *args: Any, timeout: float, device=None,
          rendezvous_dir: str | None = None, sp: int = 1) -> list[Any]:
    """[fn(world, *args) of rank 0, ..., rank n-1], each rank a process of
    the `spawn` start method with one intra-op thread, on `device` (None:
    the rank's card, over nccl; "cpu": over gloo), the world a dp x sp mesh
    (`mesh.init_distributed(sp=)`). fn and its results are
    pickled, so fn must be importable. Raises RuntimeError naming the rank
    and its traceback if a rank raises or exits without a result,
    TimeoutError after `timeout` seconds; either way every rank is ended
    first."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=rendezvous_dir, prefix="e3dge_rdzv_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, n, args, init_method, device, sp, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: {n} ranks of {getattr(fn, '__name__', fn)} still running after "
                                       f"{timeout:.0f} s (done: {sorted(out)})")
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                try:
                    # a rank that died may still have its traceback in the queue
                    rank, ok, payload = results.get(timeout=2.0 if dead else min(left, 1.0))
                except queue.Empty:
                    if dead:
                        raise RuntimeError(f"spawn: rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                           f"without a result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            codes = [p.exitcode for p in procs]
            if codes != [0] * n:
                raise RuntimeError(f"spawn: the ranks exited with codes {codes}")
        finally:
            _kill(procs)
            results.close()
    return [out[r] for r in range(n)]
