"""Device ms per iteration of the stage-1 step's frozen-GAN sample (the
port's span "e.sample" around `synthetic_sample`: the frozen G0 and G1 render
and the two SDF-target queries), the spans nested in it ("g0.render",
"g1.decoder") included: `Layers.inclusive_ns`, which counts an operation
where its launch call started and one that the trace links to no call where
the operation before it was launched."""

from port_bench.program_spans import layers


def read(ctx):
    lay = layers(ctx.trace)
    if lay is None or "e.sample" not in lay.names:
        return None
    return lay.inclusive_ns({"e.sample"}) / 1e6 / ctx.trace.units
