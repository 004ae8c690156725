"""Device ms per inversion of the operations E0 launches itself (the port's
span "e0.encoder": `models/encoders/fpn.py` inside
`models/e3dge.py::image2latents`; nested spans' excluded). The span is
opened by the port, so it reads the same eager and under CUDA graph replay."""

from port_bench.program_spans import own_ms


def read(ctx):
    return own_ms(ctx.trace, "e0.encoder")
