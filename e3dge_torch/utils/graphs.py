"""One entry point replayed as a chain of CUDA graphs, cut at the port's spans.

`GraphCache(fn, module)` serves `fn(*args)` (each argument a tensor or a list
of tensors) on the card. The first call at a new signature (each argument's
shapes and dtypes) runs `fn` eagerly (its answer; it also warms up cuDNN's
choices, the field kernel's weight packs and every lazy initialisation),
then captures `fn` on static copies of the arguments, on a stream of its
own, as a chain of CUDA graphs that share one memory pool. Every `span(name)` that `fn` opens
during the capture ends the graph being captured and begins the next, so
the chain records its span entries, graphs and span exits in order; empty
graphs are dropped. A later call at the signature copies its arguments into
the static ones, walks the chain (opening and closing the same spans, so a
profiler gives each replayed kernel to its layer through its
`cudaGraphLaunch`) and returns fresh copies of the outputs.

Chains are kept per signature while the module's parameters and buffers
(and `extra()`'s tensors) keep their storage and version counters: any
in-place update, a load or a replaced tensor drops every chain and its
memory, and the next call captures again. Each chain holds a private pool
of about one eager call's working memory or more (1.0x of the peak at the
full model's B=1, 1.3x at B=8).
"""

from __future__ import annotations

import ctypes
import gc
import warnings
from contextlib import contextmanager
from typing import Callable, Iterable

import torch
from torch.nn.modules import module as _nn_module

from e3dge_torch.utils import trace
from e3dge_torch.utils.trace import CAPTURE, REPLAY, span

ENTER, EXIT, GRAPH = "enter", "exit", "graph"

# bumped by every parameter, buffer or submodule registration in the process
# once a GraphCache exists, so a cached list of a module's tensors is rebuilt
# after one is replaced
_registrations = 0
_watching = False


def _registered(*_):
    global _registrations
    _registrations += 1


def _watch_registrations() -> None:
    global _watching
    if not _watching:
        for register in (_nn_module.register_module_parameter_registration_hook,
                         _nn_module.register_module_buffer_registration_hook,
                         _nn_module.register_module_module_registration_hook):
            register(_registered)
        _watching = True


def usable(device: torch.device, world=None) -> bool:
    """Whether a call can be replayed: on a CUDA device, with no world or a
    world of one rank (collectives across ranks stay eager)."""
    return device.type == "cuda" and (world is None or world.size == 1)


def _leaves(args) -> list[torch.Tensor]:
    out = []
    for a in args:
        out.extend([a] if isinstance(a, torch.Tensor) else a)
    return out


def signature(args) -> tuple:
    """Each argument's shape and dtype (a list: each of its tensors')."""
    return tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                 else tuple((tuple(t.shape), t.dtype) for t in a) for a in args)


def _fresh(x, memo: dict):
    """x with every tensor cloned, its dicts, lists and tuples rebuilt; an
    object met twice maps to one copy (the aliasing of the outputs kept)."""
    if id(x) in memo:
        return memo[id(x)]
    if isinstance(x, torch.Tensor):
        y = x.clone()
    elif isinstance(x, dict):
        y = {k: _fresh(v, memo) for k, v in x.items()}
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        y = type(x)(*(_fresh(v, memo) for v in x))
    elif isinstance(x, (list, tuple)):
        y = type(x)(_fresh(v, memo) for v in x)
    else:
        y = x
    memo[id(x)] = y
    return y


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a captured graph (`keep_graph=True`), by the driver's cuGraphGetNodes."""
    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t))
    fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = fn(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA driver error {err}")
    return n.value


class _Recorder:
    """A capture in progress on the current stream: the graphs so far (all
    in one pool, kept alive together) and the steps of the chain."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs, self.steps, self.open = [], [], None

    def begin(self) -> None:
        self.open = torch.cuda.CUDAGraph(keep_graph=True)
        self.open.capture_begin(pool=self.pool)

    def end(self) -> None:
        g, self.open = self.open, None
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            g.capture_end()
        self.graphs.append(g)
        if _node_count(g):
            g.instantiate()
            self.steps.append((GRAPH, g))

    @contextmanager
    def cut(self, name: str):
        """What `span(name)` is while capturing: the graph ends at the span's
        entry and exit, and the span is kept in the chain (and opened, under a
        profiler)."""
        self.end()
        self.steps.append((ENTER, name))
        with trace.mark(name):
            self.begin()
            yield
            self.end()
        self.steps.append((EXIT, name))
        self.begin()

    def abort(self) -> None:
        if self.open is not None:
            try:
                self.open.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated by the error being raised
            self.open = None


class Chain:
    """One signature's captured call: static inputs, the steps, the outputs
    the graphs write, and the launch counters' increments of one call."""

    def __init__(self, static, steps, graphs, out, counts):
        self.static, self.steps, self.graphs, self.out, self.counts = static, steps, graphs, out, counts

    @property
    def launches(self) -> int:
        """Graph launches per replay."""
        return sum(kind == GRAPH for kind, _ in self.steps)

    def replay(self, args, counters) -> dict:
        for s, a in zip(self.static, _leaves(args)):
            s.copy_(a)
        open_spans = []
        for kind, x in self.steps:
            if kind == GRAPH:
                x.replay()
            elif kind == ENTER:
                open_spans.append(span(x))
                open_spans[-1].__enter__()
            else:
                open_spans.pop().__exit__(None, None, None)
        for counter, inc in zip(counters, self.counts):
            for k, v in inc.items():
                counter[k] += v
        return _fresh(self.out, {})


class GraphCache:
    """`fn(*args)` on `device`, replayed per signature (see the module's
    docstring). `counters`: dicts of launch counts that `fn` adds to on the
    host; a replay adds what the captured call added, a capture nothing."""

    def __init__(self, fn: Callable, module: torch.nn.Module, device: torch.device,
                 extra: Callable[[], Iterable[torch.Tensor]] = tuple, counters: tuple[dict, ...] = ()):
        self.fn, self.module, self.device, self.extra, self.counters = fn, module, device, extra, counters
        self.chains: dict[tuple, Chain] = {}
        self.state = None
        self._tensors, self._seen = [], -1
        self._stream = None
        _watch_registrations()

    def key(self, *args) -> tuple:
        """(the arguments' signature, each parameter's, buffer's and extra
        tensor's data_ptr and version counter)."""
        if self._seen != _registrations:
            self._tensors = [*self.module.parameters(), *self.module.buffers()]
            self._seen = _registrations
        return signature(args), tuple((t.data_ptr(), t._version) for t in (*self._tensors, *self.extra()))

    def __call__(self, *args):
        sig, state = self.key(*args)
        if state != self.state:  # chains of other weights read stale packs: drop them and their pools
            self.chains.clear()
            self.state = state
        chain = self.chains.get(sig)
        if chain is not None:
            with span(REPLAY):
                return chain.replay(args, self.counters)
        with span(CAPTURE):
            out, self.chains[sig] = self._capture(args)
        return out

    def _capture(self, args):
        dev = self.device
        out = self.fn(*args)  # the warm-up, and this call's answer
        static = [torch.empty(a.shape, dtype=a.dtype, device=dev).copy_(a) for a in _leaves(args)]
        it = iter(static)
        static_args = [next(it) if isinstance(a, torch.Tensor) else [next(it) for _ in a] for a in args]
        before = [dict(c) for c in self.counters]
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        caller = torch.cuda.current_stream(dev)
        torch.cuda.synchronize(dev)
        gc.collect()  # no deleter of an earlier tensor runs inside the capture
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):  # capture needs a stream other than the default
            rec = _Recorder()
            rec.begin()
            trace._cut = rec.cut
            try:
                template = self.fn(*static_args)
            except BaseException:
                rec.abort()
                raise
            finally:
                trace._cut = None
            rec.end()
        caller.wait_stream(self._stream)
        counts = []
        for counter, was in zip(self.counters, before):
            counts.append({k: counter[k] - was.get(k, 0) for k in counter if counter[k] != was.get(k, 0)})
            counter.clear()
            counter.update(was)
        return out, Chain(static, rec.steps, rec.graphs, template, counts)
