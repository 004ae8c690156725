"""What the harness and the reference import, judged on whole top-level
module names, in a fresh interpreter."""

import subprocess
import sys

from port_bench import manifest

PROBE = """
import sys, importlib, pathlib
for m in {mods!r}:
    importlib.import_module(m)
for p in sorted(pathlib.Path("port_bench").glob("{glob}")):
    import importlib.util
    spec = importlib.util.spec_from_file_location("probe_" + p.stem.replace(".", "_"), p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(mods, glob="nothing") -> set[str]:
    out = subprocess.run([sys.executable, "-c", PROBE.format(mods=mods, glob=glob)], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_imports_no_jax():
    mods = ["port_bench.run", "port_bench.drivers.serve", "port_bench.drivers.train", "port_bench.drivers.train_dp",
            "e3dge_torch.runner", "e3dge_torch.training.train", "port_bench.reference.training.steps"]
    loaded = top_level(mods, "metrics/*.py")
    assert not loaded & {"jax", "jaxlib", "flax", "e3dge_tpu", "chip_smoke", "bench", "__graft_entry__"}


def test_reference_imports_nothing_of_the_port():
    mods = ["port_bench.reference.models.e3dge", "port_bench.reference.training.steps",
            "port_bench.reference.training.perceptual", "port_bench.reference.training.data",
            "port_bench.reference.models.discriminator"]
    loaded = top_level(mods)
    assert "e3dge_torch" not in loaded and not loaded & {"jax", "jaxlib", "flax", "e3dge_tpu"}


def test_sources_name_no_jax_or_old_scripts():
    bad = ("import jax", "from jax", "e3dge_tpu import", "from e3dge_tpu", "import chip_smoke", "import bench",
           "__graft_entry__ import", "from chip_smoke")
    for p in manifest.PKG.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert not [b for b in bad if b in text], p
