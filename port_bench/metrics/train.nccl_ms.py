"""Device ms per iteration of rank 0's NCCL kernels (by kernel name in the
device trace): the gradient all-reduces, the D's minibatch-stddev gathers,
BatchNorm's moments and the metrics' all-reduce, with the time each kernel
waits for the other ranks. That wait is most of it and follows how far the
four hosts drift apart, so the reading swings from run to run and does not
bound the exchange's own transfer time. None where the segment ran none
(one rank)."""


def read(ctx):
    ms = ctx.trace.op_seconds(lambda name: "nccl" in name.lower()) * 1e3
    return ms / ctx.trace.units if ms > 0 else None
