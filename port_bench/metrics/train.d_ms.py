"""Device ms per iteration of the full-resolution D's half: the fake
producer (`steps.full_d_batch`) and the D step (`make_full_d_step`, its lazy
R1 included where it falls), the spans "d_producer" and "d_step"."""


def read(ctx):
    s = ctx.trace.span_seconds("d_producer") + ctx.trace.span_seconds("d_step")
    return s * 1e3 / ctx.trace.units if s > 0 else None
