"""One reader per per-layer metric, `<metric name>.py`, each with
`read(ctx) -> float | None`. ctx holds the traced segment's `trace`
(`tracing.Trace`, with `units` inversions or iterations), the untraced
window's `window` dict, `flops_per_unit` (FlopCounterMode over the frozen
reference at the cell's shapes), `memory_peak_bytes`, the `cell`, the
program's `renderer` configuration and the configuration file `config`. A
reader that finds nothing to read returns None and the metric is left out."""
