"""Device ms per inversion of the operations G0's renders launch themselves
(the port's span "g0.render": the ref render and the conditioned re-render,
the field kernel's launches among them; nested spans' excluded)."""

from port_bench.program_spans import own_ms


def read(ctx):
    return own_ms(ctx.trace, "g0.render")
