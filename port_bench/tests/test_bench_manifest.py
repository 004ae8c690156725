"""BENCHMARK.json against the contract's form, and every cell's files; and
that a configuration and a cell are added by new files and appends alone."""

import dataclasses
import json
import re
import shutil

import pytest

from port_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# a configuration file's "preset" names the port's preset it starts from
PRESET = re.compile(r"\be3dge_torch\.config\.(\w+)")
MAN = manifest.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def check_keys_and_names(man):
    cells = [w["name"] for w in man["workloads"]]
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["port_bench"] and man["command"][:3] == ["python3", "-m", "port_bench.run"]
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("port_bench/") and 1 <= len(c["why"]) <= 200
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(cells) // 4)
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def check_per_layer(man, root):
    cells = [w["name"] for w in man["workloads"]]
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        assert (root / "port_bench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def check_cell(name, root):
    cell = manifest.cell(name, root)
    wl = cell["workload"]
    assert (root / "port_bench" / "drivers" / f"{wl['driver']}.py").exists()
    assert wl["limits"], f"{name} has no comparison limits"
    assert wl["chips"] == next(w["chips"] for w in manifest.manifest(root)["workloads"] if w["name"] == name)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]


def check_config(conf, root):
    """The file's "e3dge" block is the preset its "preset" names, group by
    group (the top-level keys of `E3DGEConfig`), except the groups listed in
    `reduced`; `reduced` is the manifest's, and names such groups."""
    from e3dge_torch import config as C

    data = json.loads((root / conf["file"]).read_text())
    preset = getattr(C, PRESET.search(data["preset"]).group(1))()
    built = manifest.build_config(C, data["e3dge"])
    groups = [f.name for f in dataclasses.fields(preset)]
    assert data["source"] == conf["source"] and data["reduced"] == conf["reduced"]
    assert set(conf["reduced"]) <= set(groups), conf["reduced"]
    for group in groups:
        if group not in conf["reduced"]:
            assert getattr(built, group) == getattr(preset, group), group


def test_keys_and_names():
    check_keys_and_names(MAN)


def test_per_layer_moves_what_its_cells_report():
    check_per_layer(MAN, manifest.ROOT)


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    check_cell(name, manifest.ROOT)


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_preset_it_names(conf):
    check_config(conf, manifest.ROOT)


def _root_with_one_more(tmp_path, renderer_change, reduced):
    """A copy of the benchmark with one more configuration (a stage-1 file
    whose renderer differs from `stage1_config` by `renderer_change`,
    `reduced` listed) and one more cell of the train driver, made from new
    files and appends to lists alone."""
    from e3dge_torch import config as C

    root = tmp_path / "root"
    shutil.copytree(manifest.PKG, root / "port_bench", ignore=shutil.ignore_patterns(".work", ".cache", "reference"))
    man = json.loads(json.dumps(MAN))
    e3dge = json.loads(json.dumps(C.stage1_config().to_dict()))
    e3dge["renderer"].update(renderer_change)
    source = "https://github.com/NIRVANALAN/CVPR23-E3DGE/blob/main/scripts/train/ffhq/stage1.sh"
    base = json.loads((manifest.PKG / "configs" / "ffhq_stage2_2.json").read_text())
    conf_file = {**base, "source": source, "preset": "e3dge_torch.config.stage1_config", "reduced": reduced,
                 "e3dge": e3dge}
    (root / "port_bench" / "configs" / "ffhq_stage1.json").write_text(json.dumps(conf_file))
    workload = json.loads((manifest.PKG / "workloads" / "st2_b4.json").read_text())
    workload.update(config="ffhq_stage1", why="stage-1 iterations at B=4")
    (root / "port_bench" / "workloads" / "st1_b4.json").write_text(json.dumps(workload))
    man["configs"].append({"name": "ffhq_stage1", "source": source, "file": "port_bench/configs/ffhq_stage1.json",
                           "reduced": reduced, "why": "stage 1 with the eikonal double backward"})
    man["workloads"].append({"name": "st1_b4", "config": "ffhq_stage1", "traffic": "st1_b4", "chips": 1,
                             "why": "stage-1 iterations at B=4"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "st2_b4" in m.get("workloads", []):
            m["workloads"].append("st1_b4")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root, man


def test_a_configuration_and_a_cell_are_added_by_new_files_alone(tmp_path):
    """Every manifest check passes on a copy with one more configuration
    (with a `reduced` entry) and one more cell."""
    root, man = _root_with_one_more(tmp_path, {"n_samples": 12}, ["renderer"])
    check_keys_and_names(man)
    check_per_layer(man, root)
    for w in man["workloads"]:
        check_cell(w["name"], root)
    for conf in man["configs"]:
        check_config(conf, root)


@pytest.mark.parametrize("change, reduced", [({"n_samples": 12}, []), ({"n_samples": 12}, ["camera"])],
                         ids=["nothing listed", "another group listed"])
def test_a_changed_group_not_listed_fails(tmp_path, change, reduced):
    root, man = _root_with_one_more(tmp_path, change, reduced)
    with pytest.raises(AssertionError, match="renderer"):
        check_config(man["configs"][-1], root)
