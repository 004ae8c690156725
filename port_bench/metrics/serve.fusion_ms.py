"""Device ms per inversion of the operations E1's fusion launches itself (the
port's span "e1.fusion": the ADA aligner, the query view's context convs,
the pixel-aligned lookups, occlusion weight, visibility, SFT, PE and the
texture modulations; the hourglass filter inside it excluded)."""

from port_bench.program_spans import own_ms


def read(ctx):
    return own_ms(ctx.trace, "e1.fusion")
