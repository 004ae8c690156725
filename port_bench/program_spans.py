"""The port's own spans joined with a traced segment's device operations,
for the per-layer metrics that read them.

The port opens a span at each layer boundary while a profiler runs
(`e3dge_torch.utils.trace`); the profiler keeps them among its host
operators (`Trace.host_ops`), and the port's `Layers` joins them with
`Trace.ops`: an operation belongs to the innermost span open when its launch
call started. Every reader returns None when the segment holds no span of
the names it reads (a program without the port's spans), and the metric is
then left out.
"""

from __future__ import annotations


def layers(trace):
    """The segment's `Layers` (None for a program without them), built once per trace."""
    if not hasattr(trace, "port_layers"):
        try:
            from e3dge_torch.utils.trace import Layers
        except ImportError:
            trace.port_layers = None
        else:
            trace.port_layers = Layers(trace.ops, trace.host_ops)
    return trace.port_layers


def _per_unit(trace, names, ns) -> float | None:
    lay = layers(trace)
    if lay is None or not lay.names & set(names):
        return None
    return ns(lay) / 1e6 / trace.units


def own_ms(trace, name: str) -> float | None:
    """Device ms per unit of span `name`'s own operations."""
    return _per_unit(trace, {name}, lambda lay: lay.device_ns(name))


def idle_ms(trace, names) -> float | None:
    """ms per unit in which one of the spans `names` was open and no device
    operation ran."""
    return _per_unit(trace, names, lambda lay: lay.idle_ns(names))


def host_ms(trace, name: str) -> float | None:
    """Host ms per unit inside span `name`."""
    return _per_unit(trace, {name}, lambda lay: lay.host_ns(name))
