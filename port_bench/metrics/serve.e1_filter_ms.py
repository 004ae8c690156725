"""Device ms per inversion of the operations enqueued inside the forward of
the E1 hourglass filter, both forwards (models/pifu/): the span "local.image_filter"."""


def read(ctx):
    s = ctx.trace.span_seconds("local.image_filter")
    return s * 1e3 / ctx.trace.units if s > 0 else None
