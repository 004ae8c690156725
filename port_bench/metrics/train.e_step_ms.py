"""Device ms per iteration of the cycle step (`steps.make_cycle_step`: the
frozen-GAN sample, forward, loss, backward, optimizer and EMA), the span
"e_step"."""


def read(ctx):
    s = ctx.trace.span_seconds("e_step")
    return s * 1e3 / ctx.trace.units if s > 0 else None
