"""Device ms per inversion of the operations the G1 decoder launches itself
(the port's span "g1.decoder": `models/generator.py::_decode_into`, the
StyleGAN2 decoder to 1024^2). The span is opened by the port, so it reads the
same eager and under CUDA graph replay."""

from port_bench.program_spans import own_ms


def read(ctx):
    return own_ms(ctx.trace, "g1.decoder")
