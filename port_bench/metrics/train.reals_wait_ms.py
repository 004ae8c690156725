"""Host ms per iteration inside the port's span "data.reals"
(`ImageFolderDataset.iter_batches` reading, flipping and stacking one batch
of reals): the time the iteration waits for its reals."""

from port_bench.program_spans import host_ms


def read(ctx):
    return host_ms(ctx.trace, "data.reals")
