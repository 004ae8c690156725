"""BENCHMARK.json against the contract's form, and every cell's files."""

import json
import re

import pytest

from port_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["port_bench"] and MAN["command"][:3] == ["python3", "-m", "port_bench.run"]
    assert 1 <= MAN["run_seconds"] <= 51
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("port_bench/") and 1 <= len(c["why"]) <= 200
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_per_layer_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
        assert (manifest.PKG / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = manifest.cell(name)
    wl = cell["workload"]
    assert (manifest.PKG / "drivers" / f"{wl['driver']}.py").exists()
    assert wl["limits"], f"{name} has no comparison limits"
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_preset_it_names(conf):
    from e3dge_torch import config as C

    data = json.loads((manifest.ROOT / conf["file"]).read_text())
    preset = {"ffhq_view_synthesis": C.demo_view_synthesis_config, "ffhq_stage2_2": C.stage2_config}[conf["name"]]
    assert manifest.build_config(C, data["e3dge"]) == preset()
    assert data["source"] == conf["source"] and data["reduced"] == conf["reduced"] == []
