"""Device ms per iteration of the stage-1 loss's shape supervision (the
port's span "g0.shape": the predicted SDF at the uniform and surface points
through the twin, both eikonal terms with the first-order graph of the
predicted one, and the shape loss), its own operations. The second-order
part of the eikonal runs in the step's backward ("e.backward")."""

from port_bench.program_spans import own_ms


def read(ctx):
    return own_ms(ctx.trace, "g0.shape")
