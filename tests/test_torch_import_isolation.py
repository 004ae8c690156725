"""The port stands alone: with `jax`, `flax`, `optax` and `e3dge_tpu` made
unimportable, every module of `e3dge_torch` imports (walked by pkgutil), as
do `chip_smoke.py`, `dp_scaling.py`, `sp_scaling.py` and `rank_spread.py`,
the trainer's, the eval CLI's and the offline tools' (`python -m
e3dge_torch.tools.calc_losses`, `.gallery_video`) parsers run, and the
reference flags build a config (`utils/options_compat.py`)."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "e3dge_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
import e3dge_torch

names = [m.name for m in pkgutil.walk_packages(e3dge_torch.__path__, "e3dge_torch.")]
for name in names:
    importlib.import_module(name)
for script in ("chip_smoke", "dp_scaling", "sp_scaling", "rank_spread"):
    importlib.import_module(script)
from e3dge_torch import eval as teval
from e3dge_torch.training import train

try:
    train.main(["--help"])
except SystemExit as e:
    assert e.code == 0, e.code
from e3dge_torch.tools import calc_losses, gallery_video

for cli in (calc_losses, gallery_video):
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
args = teval.parse_args(["--data", "d", "--mode", "now"])
assert args.mode == "now" and args.ckpt is None
from e3dge_torch.utils.options_compat import config_from_reference_flags

cfg, unknown = config_from_reference_flags(["--no_sdf", "--netLocal_type", "HGPIFuNetGANResidual", "--x"])
assert not cfg.renderer.with_sdf and cfg.pifu.netLocal_type == "HGPIFuNetGANResidual" and unknown == ["--x"]
assert "e3dge_torch.utils.options_compat" in names
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names), "modules")
'''


def test_port_imports_nothing_of_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--resume" in proc.stdout and "--sp" in proc.stdout and "imported" in proc.stdout
    assert "--gt-path" in proc.stdout and "--bounce" in proc.stdout  # the offline tools' CLIs
    n = int(proc.stdout.split("imported ")[1].split()[0])
    assert n >= len(list((REPO / "e3dge_torch").rglob("*.py"))) - 1  # every module but the package itself
