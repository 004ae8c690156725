"""ms per inversion in which the port's span "inversion" (`Runner.image2image`)
was open on the host and no device operation ran: the card waiting on the
program's own dispatch (the decoder noise drawn before the call and the copy
of the image out after it lie outside the span)."""

from port_bench.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx.trace, {"inversion"})
