"""Device ms per iteration of the operations the cycle step's backward
launches (the port's span "e.backward", autograd's threads included by
time)."""

from port_bench.program_spans import own_ms


def read(ctx):
    return own_ms(ctx.trace, "e.backward")
