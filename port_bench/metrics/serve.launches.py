"""Device operations (kernels, copies, fills) enqueued per inversion in the
traced segment: the host-dispatch layer's count."""


def read(ctx):
    return ctx.trace.launches() / ctx.trace.units
