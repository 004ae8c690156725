"""The `dp` axis of `e3dge_tpu/parallel/mesh.py` over `torch.distributed`.

JAX shards the batch over a device mesh and XLA inserts the collectives. Here
each rank is a process (started by `torchrun` or `launch.spawn`) holding a
replica of the model, and the contract is JAX's: n ranks with a global batch
B compute what one process computes on B, up to the order of reductions.

  * Random draws. Inside `sharded(world)` every draw of a step is made at the
    global batch from the step's generator and each rank keeps its rows
    (`draw_rows`, `own_rows`), so n ranks see the samples one process sees.
  * Batch statistics. Inside `sharded`, BatchNorm in train mode averages its
    moments over the ranks (`mean_over_ranks`, as flax's
    `BatchNorm(axis_name="dp")`), and the full-res D's minibatch stddev reads
    the global batch (`gather_rows`); both carry their gradient across ranks.
  * Gradients are summed over the ranks and divided by n before the optimizer
    (`all_reduce_grads`) and metrics are averaged (`reduce_metrics`, the
    reference's reduce_loss_dict); the replicas start from rank 0's
    parameters (`replicate`).

Only `all_reduce` and `broadcast` are used: gloo has no all_gather of CUDA
tensors, and two ranks that share one card must talk over gloo (NCCL refuses
two ranks on one GPU). The `sp` (ray) axis is not ported.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from e3dge_torch.utils.device import resolve_device

# the largest flattened buffer of one collective, in bytes
BUCKET_BYTES = 64 << 20


@dataclass(frozen=True)
class World:
    """This process's place among the ranks. `group`: `init_distributed`
    started a process group that joins them, so the collectives run (at size
    1 too), and `shutdown` ends it."""

    rank: int = 0
    size: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _rank_device(device, local_rank: int) -> torch.device:
    """The card `local_rank` mod the visible cards for None or "cuda" (a
    rank without a card raises); anything else as `resolve_device` gives it."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a rank runs on a CUDA device by default and none is available; "
                               "pass device='cpu' (with the gloo backend) to run the ranks on the CPU")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return resolve_device(device)


def init_distributed(backend: str | None = None, device=None, init_method: str | None = None) -> World:
    """This process's `World`, from the launcher's RANK, WORLD_SIZE and
    LOCAL_RANK. Without them it is a world of one on `resolve_device(device)`
    and no process group starts. With them the process group starts on
    `backend` (None: nccl on a card, gloo on the CPU) through `init_method`
    (None: env://, torchrun's MASTER_ADDR and MASTER_PORT), and the rank's
    card becomes the current one. nccl on the CPU raises: no backend is
    swapped for another."""
    if "WORLD_SIZE" not in os.environ:
        return World(device=resolve_device(device))
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs CUDA devices, not {dev}; use gloo on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no nccl backend")
        kwargs["device_id"] = dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=size, **kwargs)
    return World(rank, size, dev, group=True)


def shutdown(world: World | None) -> None:
    """End the process group `init_distributed` started for `world`."""
    if world is not None and world.group and dist.is_initialized():
        dist.destroy_process_group()


def barrier(world: World | None) -> None:
    if world is not None and world.group:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[world.device.index])
        else:
            dist.barrier()


# ------------------------------------------------------------ batch sharding


def shard_size(n_rows: int, world: World, pairs: bool = False, shape: Sequence[int] | None = None) -> int:
    """The rows each rank takes of a leading axis of n_rows. An uneven split
    raises, naming the shape and the dp size (`e3dge_tpu/parallel/mesh.py:
    78-84`); with `pairs` so does an odd number of rows per rank: the cycle
    stages swap rows 0<->1, 2<->3, ... within a rank (`steps._swap_odd_even`),
    where JAX's GSPMD swaps across shards."""
    shape = tuple(shape) if shape is not None else (n_rows,)
    if n_rows % world.size:
        raise ValueError(f"shard_batch: leading axis {n_rows} of leaf shape {shape} is not divisible by the dp "
                         f"size {world.size}; pick a batch size divisible by the number of ranks")
    b = n_rows // world.size
    if pairs and b % 2:
        raise ValueError(f"shard_batch: leaf shape {shape} gives {b} rows to each of {world.size} ranks; the cycle "
                         f"stages pair rows within a rank, so each rank needs an even number")
    return b


def shard_rows(x, world: World, pairs: bool = False):
    """Rank r's rows [r*b, (r+1)*b) of x (a tensor or an array)."""
    b = shard_size(x.shape[0], world, pairs, x.shape)
    return x[world.rank * b:(world.rank + 1) * b]


def _map(fn: Callable, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree) if tree.ndim >= 1 else tree
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_batch(tree: Any, world: World, pairs: bool = False) -> Any:
    """`shard_rows` over every tensor and array of a tree of dicts, lists and
    (named) tuples; scalars and other leaves are kept."""
    return _map(lambda x: shard_rows(x, world, pairs), tree)


# ---------------------------------------------------- the sharded step scope

_ACTIVE: ContextVar[World | None] = ContextVar("e3dge_torch_dp_world", default=None)


@contextmanager
def sharded(world: World | None):
    """The scope of one data-parallel step over `world` (a world of one, or
    None, changes nothing): draws keep this rank's rows of the global batch,
    BatchNorm and the D's minibatch stddev take global statistics."""
    token = _ACTIVE.set(world if world is not None and world.size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> World | None:
    """The world of the enclosing `sharded` scope (None outside one or at size 1)."""
    return _ACTIVE.get()


def local_batch(batch_size: int, pairs: bool = False) -> int:
    """The rows this rank takes of a global batch in the active scope."""
    w = active()
    return batch_size if w is None else shard_size(batch_size, w, pairs)


def own_rows(x):
    """This rank's rows of a global-batch tensor in the active scope."""
    w = active()
    return x if w is None else shard_rows(x, w)


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """draw(shape) of this rank's `shape` ([rows, ...]): in the active scope
    the draw is made at the global batch and this rank keeps its rows."""
    w = active()
    if w is None:
        return draw(tuple(shape))
    return shard_rows(draw((shape[0] * w.size, *shape[1:])), w)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) with autograd: the backward sums the incoming
    gradients over the ranks (itself differentiable, for R1's double
    backward); as `torch.distributed.nn.functional.all_reduce`, without its
    deprecation warning."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the active scope's ranks, with autograd."""
    w = active()
    return x if w is None else _SumOverRanks.apply(x) / w.size


def gather_rows(x: torch.Tensor, world: World | None = None) -> torch.Tensor:
    """The global batch of a per-rank tensor (rank r's rows at [r*b,
    (r+1)*b)), by a sum over the ranks of zero-padded copies, with autograd;
    `world` or the active scope's (none: x itself)."""
    w = world if world is not None and world.size > 1 else active()
    if w is None:
        return x
    b, rest = x.shape[0], x.shape[1:]
    padded = torch.cat([x.new_zeros((w.rank * b, *rest)), x, x.new_zeros(((w.size - w.rank - 1) * b, *rest))])
    return _SumOverRanks.apply(padded)


# ----------------------------------------------------------- collectives


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterable[list[torch.Tensor]]:
    """The tensors in runs of one dtype and device of at most BUCKET_BYTES
    (a larger tensor alone), in order."""
    run: list[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device or size + nbytes > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], world: World | None) -> None:
    """Each tensor replaced in place by its mean over the ranks (bucketed
    all_reduce, then / n); nothing without a process group."""
    if world is None or not world.group:
        return
    for run in _buckets(list(tensors)):
        flat = _flatten_dense_tensors(run)
        dist.all_reduce(flat)
        flat.div_(world.size)
        for t, r in zip(run, _unflatten_dense_tensors(flat, run)):
            t.copy_(r)


def all_reduce_grads(params: Iterable[torch.Tensor], world: World | None) -> None:
    """The gradients the backward left, averaged over the ranks before the
    optimizer step (the replicas then take the same step)."""
    all_reduce_mean_([p.grad for p in params if p.grad is not None], world)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], world: World | None) -> None:
    """The tensors overwritten in place by rank 0's."""
    if world is None or not world.group:
        return
    for run in _buckets(list(tensors)):
        flat = _flatten_dense_tensors(run)
        dist.broadcast(flat, 0)
        for t, r in zip(run, _unflatten_dense_tensors(flat, run)):
            t.copy_(r)


def replicate(module: torch.nn.Module, world: World | None) -> torch.nn.Module:
    """Every parameter and buffer of `module` broadcast from rank 0."""
    broadcast_([*module.parameters(), *module.buffers()], world)
    return module


def reduce_metrics(metrics: dict[str, Any], world: World | None) -> dict[str, Any]:
    """Each scalar metric's mean over the ranks (the reference's
    reduce_loss_dict); detached 0-d tensors."""
    if world is None or not world.group or not metrics:
        return metrics
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=world.device).detach().reshape(())
                        for v in metrics.values()])
    all_reduce_mean_([vals], world)
    return dict(zip(metrics, vals.unbind()))
