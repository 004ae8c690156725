"""The whole unit's share (%) of the card's dense peak for the configuration's
stated precision: FLOPs of one inversion or iteration (FlopCounterMode over
the frozen reference at the cell's shapes; forward and backward in training)
x the untraced window's units per second / the peak."""

from port_bench.yardstick import PEAKS


def read(ctx):
    if not ctx.flops_per_unit:
        return None
    rate = ctx.window["units"] / ctx.window["wall_s"]
    return 100.0 * ctx.flops_per_unit * rate / PEAKS[ctx.config["precision"]["peak"]]
