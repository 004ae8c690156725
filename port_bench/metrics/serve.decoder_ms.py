"""Device ms per inversion of the operations enqueued inside the forward of
the G1 decoder (models/decoder.py): the span "generator.decoder"."""


def read(ctx):
    s = ctx.trace.span_seconds("generator.decoder")
    return s * 1e3 / ctx.trace.units if s > 0 else None
