"""Spans at the port's layer boundaries, on the profiler's own timeline.

`with span("g0.render"):` marks one layer's work. While no torch profiler
records, `span` costs one check and returns a shared object that does
nothing. While one records, it opens a profiler range of that name
(`_RecordFunctionFast`), which the profiler keeps among its host operators,
stamped on its own clock: an operator's Chrome trace or TensorBoard shows the
port's layers by name, and `Layers` joins them with the device operations by
the host time of each launch. Spans are joined by time, so they nest on one
thread; device work that autograd launches from its own threads during a
backward lies inside the backward's span in time. A span never
synchronises, reads a tensor or allocates on the device.

While `utils.graphs` captures a call as CUDA graphs, `span` ends the graph
being captured at each span's entry and exit (`_cut`), and a replay opens
the same spans around the graphs: a replayed kernel belongs to the span its
`cudaGraphLaunch` was made in. The replay and the capture themselves open
`REPLAY` and `CAPTURE`, which are no layer.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import nullcontext

import torch

# every span the port opens, from the request down
LAYERS = ("inversion", "e0.encoder", "e0.pose", "g0.render", "e1.filter", "e1.fusion", "g1.decoder",
          "d.producer", "data.reals", "d.step", "e.step", "e.sample", "g0.shape", "e.backward", "e.optimizer")

# a call served from CUDA graphs (`utils.graphs`) and its capture
REPLAY, CAPTURE = "graph.replay", "graph.capture"

_profiling = torch._C._autograd._profiler_enabled
_OFF = nullcontext()
# while a chain of CUDA graphs is captured: the capture's cut(name), a
# context manager that ends one graph at the span's entry and exit
_cut = None


def span(name: str):
    """A context manager over one layer's work (`name` one of LAYERS)."""
    if _cut is not None:
        return _cut(name)
    if not _profiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def mark(name: str):
    """`span` that never cuts a capture: the profiler's range of that name
    while one records, else the shared null context."""
    return torch._C._profiler._RecordFunctionFast(name) if _profiling() else _OFF


def read(prof) -> tuple[list, list]:
    """(ops, host) of a finished `torch.profiler.profile`: each device
    operation as (name, start_ns, end_ns, host_ns), host_ns the start of the
    host call that launched it (None where the trace links it to none), and
    each host operator, the port's spans among them, as (start_ns, end_ns, name)."""
    from torch.autograd import DeviceType

    runtime, frontend, host, device = {}, {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() != DeviceType.CPU:
            device.append(e)
        elif e.linked_correlation_id() == 0:
            frontend[e.correlation_id()] = e.start_ns()
            host.append((e.start_ns(), e.end_ns(), e.name()))
        else:
            runtime[e.correlation_id()] = e.start_ns()
    ops = [(e.name(), e.start_ns(), e.end_ns(),
            runtime.get(e.correlation_id(), frontend.get(e.linked_correlation_id()))) for e in device]
    return ops, sorted(host)


def _union(ivs) -> list[tuple[int, int]]:
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Layers:
    """Device operations joined with the port's spans (`read`'s ops and host).
    An operation belongs to the innermost span open when its launch call
    started; one that the trace links to no call (a kernel launched through
    ctypes) to the owner of the operation before it on the device, which runs
    one stream in launch order. `own[None]` holds what was launched outside
    every span. Times in ns."""

    def __init__(self, ops, host):
        self.spans = [(s, e, n) for s, e, n in host if n in LAYERS]
        self.names = {n for _, _, n in self.spans}
        self.busy = _union((s, e) for _, s, e, _ in ops)
        # the innermost open span from times[k] on is names[k]
        self.times, names, stack = [], [], []

        def close_until(t):
            while stack and stack[-1][1] < t:
                self.times.append(stack.pop()[1])
                names.append(stack[-1][2] if stack else None)

        for s in sorted(self.spans, key=lambda s: (s[0], -s[1])):
            close_until(s[0])
            stack.append(s)
            self.times.append(s[0])
            names.append(s[2])
        close_until(float("inf"))
        self.inner = names
        # each operation with the host time it counts from: its launch call's, else the one's before it
        self.own, owner, self.launched, at = defaultdict(list), None, [], None
        for op in sorted(ops, key=lambda op: op[1]):
            if op[3] is not None:
                at = op[3]
                k = bisect.bisect_right(self.times, at) - 1
                owner = names[k] if k >= 0 else None
            self.own[owner].append(op)
            self.launched.append((at, op))

    def device_ns(self, name: str | None) -> int:
        """Device time of span `name`'s own operations (nested spans' excluded)."""
        return sum(e - s for _, s, e, _ in self.own[name])

    def inclusive_ns(self, names) -> int:
        """Device time of the operations launched while one of the spans
        `names` was open, those of the spans nested in it included."""
        ivs = self.open(names)
        starts = [s for s, _ in ivs]
        total = 0
        for at, (_, s, e, _) in self.launched:
            k = -1 if at is None else bisect.bisect_right(starts, at) - 1
            if k >= 0 and at <= ivs[k][1]:
                total += e - s
        return total

    def open(self, names) -> list[tuple[int, int]]:
        return _union((s, e) for s, e, n in self.spans if n in names)

    def host_ns(self, name: str) -> int:
        """Host time inside span `name`."""
        return sum(e - s for s, e in self.open({name}))

    def idle_ns(self, names) -> int:
        """Time in which one of the spans `names` was open and no device operation ran."""
        ivs = self.open(names)
        return sum(e - s for s, e in ivs) - _overlap(ivs, self.busy)

    def table(self) -> dict[str | None, tuple[int, int, int]]:
        """Per span name (None: outside every span): its own device ns and
        launches, and the ns in which it was the innermost open span and no
        device operation ran."""
        ends = self.times[1:] + self.times[-1:]
        rows = {}
        for name in sorted(self.names) + [None]:
            inner = [(t, u) for t, u, n in zip(self.times, ends, self.inner) if n == name and u > t]
            wait = sum(u - t for t, u in inner) - _overlap(inner, self.busy) if name else 0
            rows[name] = (self.device_ns(name), len(self.own[name]), wait)
        return rows
