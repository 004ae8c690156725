"""Device ms per inversion of the operations E1's hourglass filter launches
itself, both forwards (the port's span "e1.filter":
`models/pifu/local_net.py::LocalFeatureNet.filter` around `image_filter`).
The span is opened by the port, so it reads the same eager and under CUDA
graph replay."""

from port_bench.program_spans import own_ms


def read(ctx):
    return own_ms(ctx.trace, "e1.filter")
