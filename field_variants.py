"""Times the `serving` field kernels at the main path's shapes (B=1,
N=64*64*24: the full pass writing raw_h, the texture pass with SFT) and
checks the full pass against its plain version, for the source as it is and
for variants of csrc/siren_field_sm90.cu made by textual edits, in turns on
one card: A, each variant, A again. Needs a CUDA card.

    python3 field_variants.py \\
        --variant 'ring5=constexpr int NSTAGE = 4;=>constexpr int NSTAGE = 5;'

A variant is NAME=OLD=>NEW, several OLD=>NEW edits joined by ';;'. Each run
builds its own copy of the package in a temporary directory, so the checkout
is never edited. Prints one line per run: kernel ms (CUDA events over 50
launches), ptxas spill bytes per kernel, and (max, mean, within
KERNEL_TOLERANCE) of feat, rgb_sdf and raw_h.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_ROOT = Path(__file__).resolve().parent
_PKG = _ROOT / "e3dge_torch"
_SOURCE = Path("csrc") / "siren_field_sm90.cu"


def measure(tag: str) -> None:
    """One run in this process: build, time, compare; prints one line."""
    import re

    import torch

    import chip_smoke as c
    from e3dge_torch.ops import siren_field as sf

    _, build_log = sf.build_library()
    spills = re.findall(r"(\d+) bytes spill stores", build_log)
    dev = torch.device("cuda")
    with torch.no_grad():
        x = c.field_inputs(c.N_FULL, "serving", False, dev)
        full = (x["pts"], x["dirs"], x["pack"], x["gamma"], x["beta"])
        y = c.field_inputs(c.N_FULL, "serving", True, dev)
        raw_h = sf.siren_field_full(*full, precision="serving", return_raw_h=True)[2]
        tex = (raw_h, y["dirs"], y["pack"], y["gamma"][:, -1].contiguous(), y["beta"][:, -1].contiguous(),
               y["alpha"], y["lbeta"])
        full_ms = c.cuda_ms(lambda: sf.siren_field_full(*full, precision="serving", return_raw_h=True), iters=50)
        tex_ms = c.cuda_ms(lambda: sf.siren_field_tex(*tex, precision="serving"), iters=50)
        got = sf.siren_field_full(*full, precision="serving", return_raw_h=True)
        want = sf.siren_field_reference(*full, precision="serving", return_raw_h=True)
        errs = [sf.kernel_errors(g, w, k, "serving") for g, w, k in zip(got, want, ("hidden", "head", "hidden"))]
    errs = [(f"{mx:.3e}", f"{mean:.3e}", ok) for mx, mean, ok in errs]
    print(f"{tag}: full {full_ms:.4f} ms, tex {tex_ms:.4f} ms, spill bytes {spills}, errors {errs}", flush=True)


def run_variant(tag: str, edits: list[tuple[str, str]]) -> int:
    """`measure` in a subprocess on a copy of the package with `edits` made."""
    with tempfile.TemporaryDirectory() as tmp:
        pkg = Path(tmp) / _PKG.name
        shutil.copytree(_PKG, pkg, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = pkg / _SOURCE
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {tag}: {old!r} not in {_SOURCE}")
            text = text.replace(old, new)
        src.write_text(text)
        # cwd first on sys.path: the copy of the package; then this checkout
        env = dict(os.environ, PYTHONPATH=str(_ROOT))
        return subprocess.run([sys.executable, "-c", f"import field_variants; field_variants.measure({tag!r})"],
                              env=env, cwd=tmp).returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=[], help="NAME=OLD=>NEW[;;OLD=>NEW...]")
    args = ap.parse_args()
    runs = [("A", [])]
    for v in args.variant:
        name, _, spec = v.partition("=")
        runs.append((name, [tuple(e.split("=>", 1)) for e in spec.split(";;")]))
    runs.append(("A2", []))
    return max(run_variant(tag, edits) for tag, edits in runs)


if __name__ == "__main__":
    sys.exit(main())
