"""The benchmark of the PyTorch/CUDA port `e3dge_torch` on one H100.

`python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Everything
that belongs to a configuration, a cell or a per-layer metric is a file of its
own, found by name (see README.md). `reference/` is a frozen plain-PyTorch
copy of the port, which `correct` is decided against; it imports nothing of
the port.
"""
