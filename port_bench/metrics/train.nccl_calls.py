"""NCCL kernels rank 0 launches per iteration (by kernel name in the device
trace): the count of collectives the step runs. None where the segment ran
none (one rank)."""


def read(ctx):
    calls = sum(1 for name, *_ in ctx.trace.ops if "nccl" in name.lower())
    return calls / ctx.trace.units if calls else None
