"""Share (%) of the traced segment in which no device operation ran: 100 x
(1 - union of the operations' intervals / the segment's length)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
