"""Finds a cell's files by name: the entry of `BENCHMARK.json`, its workload
file `workloads/<cell>.json` (configuration, driver, chips, traffic,
comparison limits, why) and its configuration file (`configs/<config>.json`,
the one the manifest names), and builds the configuration as it is run."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> dict:
    """{"name", "chips", "workload": the workload file, "config": the
    configuration file, "end_to_end": [metric entries the cell reports],
    "per_layer": [...]} for cell `name` of the manifest."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    workload = json.loads((root / PKG.name / "workloads" / f"{name}.json").read_text())
    if workload["config"] != entry["config"]:
        raise SystemExit(f"{name}: the workload file's config {workload['config']!r} is not the manifest's")

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "chips": entry["chips"], "workload": workload,
            "config": json.loads((root / conf["file"]).read_text()),
            "end_to_end": [m for m in man["end_to_end"] if reports(m)],
            "per_layer": [m for m in man["per_layer"] if reports(m)]}


def merged(base: dict, over: dict) -> dict:
    """base with over's entries, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def build_config(config_module: ModuleType, e3dge: dict):
    """The configuration dict (`E3DGEConfig.to_dict()`'s layout) as an
    `E3DGEConfig` of `config_module` (the port's or the reference's)."""
    cls = config_module.E3DGEConfig
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = e3dge[f.name]
        if isinstance(v, dict):
            sub = f.default_factory().__class__
            v = sub(**{k: tuple(x) if isinstance(x, list) else x for k, x in v.items()})
        kwargs[f.name] = v
    return cls(**kwargs).validate()
