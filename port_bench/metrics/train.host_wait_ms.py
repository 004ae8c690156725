"""ms per iteration in which one of the port's spans "d.producer",
"data.reals", "d.step" or "e.step" was open on the host and no device
operation ran: the card waiting on the training loop's own dispatch."""

from port_bench.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx.trace, {"d.producer", "data.reals", "d.step", "e.step"})
