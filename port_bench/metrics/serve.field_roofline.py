"""The field kernel's share (%) of its roofline in an inversion
(`yardstick.field_roofline`: the passes the workload file states for one
call, over the device time of the kernels below)."""

from port_bench.yardstick import field_roofline

KERNELS = ("siren_field_tf32_kernel", "siren_field_tc_kernel")


def read(ctx):
    return field_roofline(ctx, KERNELS)
