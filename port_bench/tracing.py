"""Spans and the device trace of a `--trace 1` run.

Spans are opened from the benchmark's own files: the drivers wrap the calls
they make in `span(name)`, and `ModuleSpans` puts forward pre- and post-hooks
on named submodules (the `STAGES` of `chip_smoke.py`), each a
`torch.profiler.record_function` range. `profile` runs a segment under
torch.profiler (CPU and CUDA activities) inside a "window" span and returns a
`Trace`: every device operation with the host time of the API call that
enqueued it, so a span's device time is the time of the operations enqueued
while the span was open on the host.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

WINDOW = "window"


@contextmanager
def span(name: str):
    with torch.profiler.record_function(name):
        yield


class ModuleSpans:
    """Forward hooks that open a span named after each of `names` (paths of
    submodules of `model`) for the length of its forward; `remove` takes them
    off."""

    def __init__(self, model: torch.nn.Module, names: list[str]):
        self.handles, self.open = [], defaultdict(list)
        for name in names:
            mod = model.get_submodule(name)
            self.handles.append(mod.register_forward_pre_hook(self._pre(name)))
            self.handles.append(mod.register_forward_hook(self._post(name)))

    def _pre(self, name):
        def hook(_mod, _inp):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self.open[name].append(rf)
        return hook

    def _post(self, name):
        def hook(_mod, _inp, _out):
            self.open[name].pop().__exit__(None, None, None)
        return hook

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class Trace:
    """The device operations of a profiled segment. `ops`: (name, start_ns,
    end_ns, host_ns) per device operation (kernels, copies, fills; user
    annotations left out), host_ns the start of the host call that enqueued
    it (None when the trace links it to none); `spans`: name -> [(start_ns,
    end_ns)] on the host; `host_ops`: (start_ns, end_ns, name) of the host's
    operators, for labelling idle gaps."""

    def __init__(self, ops, spans, host_ops, window_ns: tuple[int, int], units: int):
        self.ops, self.spans, self.host_ops, self.units = ops, spans, host_ops, units
        self.t0, self.t1 = window_ns
        self.window_s = (self.t1 - self.t0) / 1e9
        self.busy = _union([(s, e) for _, s, e, _ in ops])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        self.unlinked = sum(1 for op in ops if op[3] is None)
        self.host_starts = [s for s, _, _ in host_ops]

    def launches(self) -> int:
        return len(self.ops)

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match(name)` accepts."""
        return sum(e - s for name, s, e, _ in self.ops if match(name)) / 1e9

    def span_seconds(self, name: str) -> float:
        """Device seconds of the operations enqueued while span `name` was open."""
        ivs = sorted(self.spans.get(name, []))
        starts = [s for s, _ in ivs]
        total = 0
        for _, s, e, host in self.ops:
            if host is None:
                continue
            k = bisect.bisect_right(starts, host) - 1
            if k >= 0 and ivs[k][1] >= host:
                total += e - s
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the idle time
        between device operations summed by what the host was doing as the
        device went idle (the innermost open span, then the host operator)."""
        by_name = defaultdict(int)
        for name, s, e, _ in self.ops:
            by_name[name[:160]] += e - s
        gaps = defaultdict(int)
        edges = [self.t0] + [t for iv in self.busy for t in iv] + [max(self.t1, self.busy[-1][1] if self.busy else self.t1)]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                gaps[self._label(g0)] += g1 - g0
        ordered = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": ordered(by_name), "idle_gaps": ordered(gaps)}

    def _label(self, t: int) -> str:
        inner = None
        for name, ivs in self.spans.items():
            for s, e in ivs:
                if s <= t <= e and name != WINDOW and (inner is None or s > inner[0]):
                    inner = (s, name)
        op = None
        k = bisect.bisect_right(self.host_starts, t) - 1
        for j in range(k, max(k - 400, -1), -1):
            s, e, name = self.host_ops[j]
            if e >= t:
                op = name
                break
        return f"{inner[1] if inner else WINDOW} / {op or 'python'}"[:160]


def _union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def profile(fn, span_names: set[str], units: int) -> Trace:
    """Run `fn()` (which must leave the device idle, e.g. by synchronising)
    under torch.profiler inside a WINDOW span, and read the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=acts) as prof:
        with span(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    t = time.perf_counter()
    runtime, frontend, host_ops, spans, device = {}, {}, [], defaultdict(list), []
    names = span_names | {WINDOW}
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type()
        if dev == DeviceType.CPU:
            name = e.name()
            if e.is_user_annotation():
                if name in names:
                    spans[name].append((e.start_ns(), e.end_ns()))
            elif e.linked_correlation_id() == 0:
                frontend[e.correlation_id()] = e.start_ns()
                host_ops.append((e.start_ns(), e.end_ns(), name))
            else:
                runtime[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            device.append(e)
    ops = []
    for e in device:
        host = runtime.get(e.correlation_id())
        if host is None:
            host = frontend.get(e.linked_correlation_id())
        ops.append((e.name(), e.start_ns(), e.end_ns(), host))
    host_ops.sort()
    win = spans.pop(WINDOW)[0]
    trace = Trace(ops, dict(spans), host_ops, win, units)
    trace.parse_s = time.perf_counter() - t
    return trace
