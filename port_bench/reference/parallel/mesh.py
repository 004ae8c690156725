"""A world of one rank. The port's `parallel/mesh.py` splits a step's batch
over data-parallel ranks and its rays over an sp axis; the reference runs
every cell on one card, so each of its hooks is the identity here and the
port's splits are judged against this one-rank computation."""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def sharded(world=None, rays: bool = False):
    yield


def active():
    return None


def local_batch(batch_size: int, pairs: bool = False) -> int:
    return batch_size


def own_rows(x):
    return x


def draw_rows(draw, shape):
    return draw(tuple(shape))


def gather_rows(x, world=None):
    return x


def own_rays(x, dim: int = 1):
    return x


def gather_rays(x, dim: int = 1):
    return x


def all_reduce_grads(params, world) -> None:
    pass


def reduce_metrics(metrics: dict, world) -> dict:
    return metrics
