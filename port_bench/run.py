"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m port_bench.run --workload i2i_b1 --seed 7 --seconds 30 --trace 0

Set-up (the program built with seeded weights, the cell's shapes warmed up)
runs from process start to the window; the window drives the cell's entry
point for --seconds; with --trace 1 a traced segment follows it and the
per-layer metrics are read from it. Then the program is freed and the frozen
reference rebuilds what the window produced: `correct` is whether every
compared number is within its limit. The last lines on standard error are the
compared numbers beside their limits; the last line on standard output is
the JSON result. Without a card (or with fewer than the cell needs) it exits
2 and prints no result; if JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from port_bench import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "e3dge_tpu")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program at the configuration's control precision (the lower-precision control)")
    return ap.parse_args(argv)


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = manifest.PKG / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def driver_class(name: str):
    path = manifest.PKG / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.drivers.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver


def reader(metric: str):
    path = manifest.PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, control: bool = False,
             t0: float | None = None) -> dict:
    """One run of `cell` on `device`; returns the result line's dict, the
    compared numbers under "compared" (last), the run's own figures (set-up
    parts, the reference's seconds, every reading) under "notes". `t0`: the
    start that `setup_s` counts from (default: this process's)."""
    import torch

    from port_bench import tracing

    t0 = PROCESS_T0 if t0 is None else t0
    conf = cell["config"]
    flags = conf["torch_flags"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_allow_tf32"]
    program_cfg = manifest.merged(conf["e3dge"], conf["control"]) if control else conf["e3dge"]
    cuda = torch.device(device).type == "cuda"
    driver = driver_class(cell["workload"]["driver"])(cell, seed, device, program_cfg)
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t0
    win = driver.window(seconds)
    forbidden = forbidden_modules()
    result = {"attempted": win["attempted"], "failed": win["failed"]}
    per_layer = None
    if trace:
        fn, span_names, units, model, module_spans = driver.traced()
        spans = tracing.ModuleSpans(model, list(module_spans))
        try:
            per_layer = tracing.profile(fn, span_names, units)
        finally:
            spans.remove()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    t_ref = time.time()
    compared = driver.check(count_flops=trace)
    ref_s = time.time() - t_ref
    forbidden = sorted(set(forbidden) | set(forbidden_modules()))
    judged = [(n, v, lim) for n, v, lim in compared if lim is not None]
    correct = bool(judged) and all(v <= lim for _, v, lim in judged)
    if trace:
        ctx = SimpleNamespace(trace=per_layer, window=win, driver=driver, cell=cell, memory_peak_bytes=peak,
                              flops_per_unit=driver.flops, renderer=program_cfg["renderer"], config=conf)
        metrics = {}
        for m in cell["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell["end_to_end"]:
            if m["name"] in win["metrics"]:
                metrics[m["name"]] = {"value": win["metrics"][m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=per_layer.busy_s, window_s=per_layer.window_s)
    result.update(correct=correct, metrics=metrics, device=dev)
    if trace:
        result["breakdown"] = per_layer.breakdown()
    result["notes"] = {"setup_parts": driver.setup_parts, "reference_s": ref_s, "window_s": win["wall_s"],
                       "units": win["units"], "readings": {n: v for n, v, _ in compared},
                       "forbidden_modules": forbidden}
    if trace:
        result["notes"].update(trace_parse_s=per_layer.parse_s, unlinked_ops=per_layer.unlinked,
                               traced_units=per_layer.units)
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in judged}
    return result


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    set_cache_dirs()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", control=args.control)
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    bad = result["notes"]["forbidden_modules"]
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result["notes"]), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
