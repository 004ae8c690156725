"""The `dp` and `sp` axes of `e3dge_tpu/parallel/mesh.py` over
`torch.distributed`.

JAX shards the batch over a device mesh and XLA inserts the collectives. Here
each rank is a process (started by `torchrun` or `launch.spawn`) holding a
replica of the model, and the contract is JAX's: n ranks with a global batch
B compute what one process computes on B, up to the order of reductions.

The ranks form a dp x sp mesh laid out as JAX's `make_mesh(shape=(dp, sp))`
lays out its devices, row-major: rank = dp_rank * sp + sp_rank. The ranks of
one `sp` group (one dp_rank) hold the same rows of the batch; the ranks of
one `dp` group (one sp_rank) hold the dp shards. Every batch mechanism below
reads the dp coordinate, so at sp > 1 the sp ranks of a dp group repeat one
shard's work unless a step splits it:

  * Random draws. Inside `sharded(world)` every draw of a step is made at the
    global batch from the step's generator and each rank keeps its dp rows
    (`draw_rows`, `own_rows`), so the ranks see the samples one process sees.
  * Batch statistics. Inside `sharded`, BatchNorm in train mode averages its
    moments over the dp group (`mean_over_ranks`, as flax's
    `BatchNorm(axis_name="dp")`), and the full-res D's minibatch stddev reads
    the global batch (`gather_rows`, over the dp group); both carry their
    gradient across the dp group. Over the whole world at sp > 1 each row
    would count sp times: right in value for the mean, but its backward
    would sum the gradient sp times.
  * The ray split (`sharded(world, rays=True)`, the stage-2 cycle step: JAX's
    `constrain_fn` puts "sp" on the image-height axis of the rendered maps).
    Each sp rank renders its rows [r*H/sp, (r+1)*H/sp) of the rays
    (`own_rays`) and every 2D layer or loss reads maps gathered whole along H
    (`gather_rays`, a sum over the sp group of zero-padded copies). The
    gather's backward sums the incoming gradient over the sp group, so a
    per-sample parameter's gradient on each rank is sp times its rays' share,
    and a 2D parameter's is the whole gradient on each of the sp ranks:
    either way the world's sum is sp times the dp shards' sum, and
  * gradients are summed over the world and divided by its size before the
    optimizer (`all_reduce_grads`): the mean over the dp shards at any sp.
    Metrics are averaged over the world (`reduce_metrics`, the reference's
    reduce_loss_dict; the sp ranks of a shard hold equal values), and the
    replicas start from rank 0's parameters (`replicate`).

Only `all_reduce` and `broadcast` are used: gloo has no all_gather of CUDA
tensors, and two ranks that share one card must talk over gloo (NCCL refuses
two ranks on one GPU). At sp = 1 no subgroup is built and every collective
runs over the world.
"""

from __future__ import annotations

import dataclasses
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
    """This process's place among the ranks: a dp x sp mesh, row-major as
    JAX's `make_mesh(shape=(dp, sp))`. `group`: `init_distributed` started a
    process group that joins them, so the collectives run (at size 1 too),
    and `shutdown` ends it; `dp_group` and `sp_group` are this rank's
    subgroups (None: the world, or no collective over that axis at sp = 1)."""

    rank: int = 0
    size: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: bool = False
    sp: int = 1
    dp_group: Any = field(default=None, compare=False, repr=False)
    sp_group: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        check_sp(self.size, self.sp)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def dp(self) -> int:
        return self.size // self.sp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp


def check_sp(size: int, sp: int) -> None:
    """A world of `size` ranks splits into dp x sp only if sp divides it."""
    if sp < 1 or size % sp:
        raise ValueError(f"a world of {size} ranks (WORLD_SIZE) does not split into an sp axis of {sp}: sp must be "
                         f"a divisor of the world size")


def _rank_device(device, local_rank: int) -> torch.device:
    """The card `local_rank` mod the visible cards for None or "cuda" (a
    rank without a card raises); anything else as `resolve_device` gives it."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a rank runs on a CUDA device by default and none is available; "
                               "pass device='cpu' (with the gloo backend) to run the ranks on the CPU")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return resolve_device(device)


def init_distributed(backend: str | None = None, device=None, init_method: str | None = None, sp: int = 1) -> World:
    """This process's `World`, from the launcher's RANK, WORLD_SIZE and
    LOCAL_RANK. Without them it is a world of one on `resolve_device(device)`
    and no process group starts. With them the process group starts on
    `backend` (None: nccl on a card, gloo on the CPU) through `init_method`
    (None: env://, torchrun's MASTER_ADDR and MASTER_PORT), the rank's
    card becomes the current one, and at sp > 1 the dp x sp subgroups are
    built (`split_world`). nccl on the CPU raises: no backend is swapped
    for another. A world size that sp does not divide raises before any
    process group starts."""
    if "WORLD_SIZE" not in os.environ:
        check_sp(1, sp)
        return World(device=resolve_device(device))
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    check_sp(size, sp)
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
    return split_world(World(rank, size, dev, group=True), sp)


def split_world(world: World, sp: int) -> World:
    """`world` (a started process group) as a dp x sp mesh: every rank
    builds, in the same order, the sp group of each dp_rank (ranks [d*sp,
    (d+1)*sp)) and then the dp group of each sp_rank (ranks s, s + sp, ...),
    and keeps its own. At sp = 1 it builds none: the dp group is the world."""
    check_sp(world.size, sp)
    if sp == 1:
        return dataclasses.replace(world, sp=1, dp_group=None, sp_group=None)
    dp = world.size // sp
    sp_groups = [dist.new_group(list(range(d * sp, (d + 1) * sp))) for d in range(dp)]
    dp_groups = [dist.new_group(list(range(s, world.size, sp))) for s in range(sp)]
    return dataclasses.replace(world, sp=sp, dp_group=dp_groups[world.rank % sp],
                               sp_group=sp_groups[world.rank // sp])


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
    """The rows each dp shard takes of a leading axis of n_rows. An uneven
    split raises, naming the shape and the dp size (`e3dge_tpu/parallel/
    mesh.py:78-84`); with `pairs` so does an odd number of rows per shard: the
    cycle stages swap rows 0<->1, 2<->3, ... within a rank
    (`steps._swap_odd_even`), where JAX's GSPMD swaps across shards."""
    shape = tuple(shape) if shape is not None else (n_rows,)
    if n_rows % world.dp:
        raise ValueError(f"shard_batch: leading axis {n_rows} of leaf shape {shape} is not divisible by the dp "
                         f"size {world.dp}; pick a batch size divisible by the number of dp shards")
    b = n_rows // world.dp
    if pairs and b % 2:
        raise ValueError(f"shard_batch: leaf shape {shape} gives {b} rows to each of {world.dp} ranks; the cycle "
                         f"stages pair rows within a rank, so each rank needs an even number")
    return b


def shard_rows(x, world: World, pairs: bool = False):
    """dp shard d's rows [d*b, (d+1)*b) of x (a tensor or an array)."""
    b = shard_size(x.shape[0], world, pairs, x.shape)
    return x[world.dp_rank * b:(world.dp_rank + 1) * b]


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
_RAYS: ContextVar[bool] = ContextVar("e3dge_torch_ray_split", default=False)


@contextmanager
def sharded(world: World | None, rays: bool = False):
    """The scope of one data-parallel step over `world` (a world of one, or
    None, changes nothing): draws keep this rank's dp rows of the global
    batch, BatchNorm and the D's minibatch stddev take global statistics.
    `rays` splits the G0 renders' rays over the sp axis (`ray_split`)."""
    token = _ACTIVE.set(world if world is not None and world.size > 1 else None)
    token_rays = _RAYS.set(rays)
    try:
        yield
    finally:
        _RAYS.reset(token_rays)
        _ACTIVE.reset(token)


def active() -> World | None:
    """The world of the enclosing `sharded` scope (None outside one or at size 1)."""
    return _ACTIVE.get()


def ray_split() -> World | None:
    """The active world when the enclosing scope splits the rays over an sp
    axis of more than one rank, else None."""
    w = active()
    return w if w is not None and w.sp > 1 and _RAYS.get() else None


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
    return shard_rows(draw((shape[0] * w.dp, *shape[1:])), w)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) over `group` (None: the world) with autograd: the
    backward sums the incoming gradients over the same ranks (itself
    differentiable, for R1's double backward); as
    `torch.distributed.nn.functional.all_reduce`, without its deprecation
    warning."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad, ctx.group), None


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the active scope's dp shards, with autograd."""
    w = active()
    return x if w is None or w.dp == 1 else _SumOverRanks.apply(x, w.dp_group) / w.dp


def _placed(x: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    """x at block `index` of `parts` equal blocks along dim, zeros elsewhere."""
    n = x.shape[dim]
    shape = list(x.shape)
    before, after = shape.copy(), shape.copy()
    before[dim], after[dim] = index * n, (parts - index - 1) * n
    return torch.cat([x.new_zeros(before), x, x.new_zeros(after)], dim=dim)


def gather_rows(x: torch.Tensor, world: World | None = None) -> torch.Tensor:
    """The global batch of a per-shard tensor (dp shard d's rows at [d*b,
    (d+1)*b)), by a sum over the dp group of zero-padded copies, with
    autograd; `world` or the active scope's (none, or one dp shard: x)."""
    w = world if world is not None and world.size > 1 else active()
    if w is None or w.dp == 1:
        return x
    return _SumOverRanks.apply(_placed(x, 0, w.dp_rank, w.dp), w.dp_group)


def ray_bounds(n: int, world: World) -> tuple[int, int]:
    """This rank's rows [lo, hi) of an axis of n split over the sp axis; an
    uneven split raises, naming n and sp."""
    if n % world.sp:
        raise ValueError(f"the ray split needs the image height (or point count) H={n} divisible by sp={world.sp}")
    b = n // world.sp
    return world.sp_rank * b, (world.sp_rank + 1) * b


def own_rays(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This sp rank's rows of x along dim (the image height of a [B, H, ...]
    map, or the points of [B, N, ...]) under the ray split; x otherwise."""
    w = ray_split()
    if w is None:
        return x
    lo, hi = ray_bounds(x.shape[dim], w)
    return x.narrow(dim, lo, hi - lo)


def gather_rays(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole of a map split by `own_rays` along dim, from every sp rank's
    rows, by a sum over the sp group of zero-padded copies, with autograd
    (the backward sums the incoming gradient over the sp group); x outside
    the ray split."""
    w = ray_split()
    if w is None:
        return x
    return _SumOverRanks.apply(_placed(x, dim, w.sp_rank, w.sp), w.sp_group)


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
