"""Device ms per inversion of the operations enqueued inside the forward of
the E0 encoder (models/encoders/fpn.py): the span "encoder"."""


def read(ctx):
    s = ctx.trace.span_seconds("encoder")
    return s * 1e3 / ctx.trace.units if s > 0 else None
