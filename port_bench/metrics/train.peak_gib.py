"""Peak device memory of the run in GiB (`torch.cuda.max_memory_allocated`),
which decides the batch a card can take."""


def read(ctx):
    return ctx.memory_peak_bytes / 2**30 if ctx.memory_peak_bytes else None
