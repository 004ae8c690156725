"""Device ms per iteration of the cycle step's optimizer step and EMA update
(the port's span "e.optimizer": `steps.optimizer_step`)."""

from port_bench.program_spans import own_ms


def read(ctx):
    return own_ms(ctx.trace, "e.optimizer")
