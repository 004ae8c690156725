"""Times the field kernels of one precision (B items of N=64*64*24 points:
the full pass writing raw_h, the full pass without it, the texture pass with
SFT) and checks the full pass against its plain version, for the source as it
is and for variants of one kernel source made by textual edits, in turns on
one card: A, each variant, A again. Needs a CUDA card.

    python3 field_variants.py \\
        --variant 'ring5=constexpr int NSTAGE = 4;=>constexpr int NSTAGE = 5;'
    python3 field_variants.py --source csrc/siren_field.cu --precision highest --batch 4 \\
        --variant 'ring2=constexpr int NSTAGE = 3=>constexpr int NSTAGE = 2'

A variant is NAME=OLD=>NEW, several OLD=>NEW edits joined by ';;', made in
--source (a path under e3dge_torch/, default csrc/siren_field_sm90.cu), or in
another file of the package where an edit reads FILE::OLD=>NEW (keep ';'
off the end of OLD and NEW: ';;' joins edits). Each
run builds its own copy of the package in a temporary directory, so the
checkout is never edited. Prints one line per run: kernel ms (CUDA events over
20 launches), ptxas spill bytes and wgmma serialisation warnings, and (max,
mean, within KERNEL_TOLERANCE) of feat, rgb_sdf and raw_h.
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


def measure(tag: str, precision: str, batch: int) -> None:
    """One run in this process: build, time, compare; prints one line."""
    import re

    import torch

    import chip_smoke as c
    from e3dge_torch.ops import siren_field as sf

    _, build_log = sf.build_library()
    spills = re.findall(r"(\d+) bytes spill stores", build_log)
    serialized = len(re.findall(r"C7510", build_log))
    dev = torch.device("cuda")
    with torch.no_grad():
        x = c.field_inputs(c.N_FULL, precision, False, dev, batch=batch)
        full = (x["pts"], x["dirs"], x["pack"], x["gamma"], x["beta"])
        y = c.field_inputs(c.N_FULL, precision, True, dev, batch=batch)
        raw_h = sf.siren_field_full(*full, precision=precision, return_raw_h=True)[2]
        tex = (raw_h, y["dirs"], y["pack"], y["gamma"][:, -1].contiguous(), y["beta"][:, -1].contiguous(),
               y["alpha"], y["lbeta"])
        full_ms = c.cuda_ms(lambda: sf.siren_field_full(*full, precision=precision, return_raw_h=True))
        nraw_ms = c.cuda_ms(lambda: sf.siren_field_full(*full, precision=precision))
        tex_ms = c.cuda_ms(lambda: sf.siren_field_tex(*tex, precision=precision))
        got = sf.siren_field_full(*full, precision=precision, return_raw_h=True)
        want = sf.siren_field_reference(*full, precision=precision, return_raw_h=True)
        errs = [sf.kernel_errors(g, w, k, precision) for g, w, k in zip(got, want, ("hidden", "head", "hidden"))]
    errs = [(f"{mx:.3e}", f"{mean:.3e}", ok) for mx, mean, ok in errs]
    print(f"{tag}: {precision} B={batch}: full {full_ms:.4f} ms (no raw_h {nraw_ms:.4f}), tex {tex_ms:.4f} ms, "
          f"spill bytes {spills}, serialized wgmma warnings {serialized}, errors {errs}", flush=True)


def run_variant(tag: str, edits: list[tuple[Path, str, str]], precision: str, batch: int) -> int:
    """`measure` in a subprocess on a copy of the package with `edits` (file,
    old, new) made."""
    with tempfile.TemporaryDirectory() as tmp:
        pkg = Path(tmp) / _PKG.name
        shutil.copytree(_PKG, pkg, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for source, old, new in edits:
            src = pkg / source
            text = src.read_text()
            if old not in text:
                raise SystemExit(f"variant {tag}: {old!r} not in {source}")
            src.write_text(text.replace(old, new))
        # cwd first on sys.path: the copy of the package; then this checkout
        env = dict(os.environ, PYTHONPATH=str(_ROOT))
        code = f"import field_variants; field_variants.measure({tag!r}, {precision!r}, {batch})"
        return subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp).returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=[], help="NAME=OLD=>NEW[;;OLD=>NEW...]")
    ap.add_argument("--source", type=Path, default=Path("csrc") / "siren_field_sm90.cu",
                    help="the file the variants edit, relative to e3dge_torch/")
    ap.add_argument("--precision", choices=("serving", "highest"), default="serving")
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    runs = [("A", [])]
    for v in args.variant:
        name, _, spec = v.partition("=")
        edits = []
        for e in spec.split(";;"):
            source, edit = e.split("::", 1) if "::" in e.split("=>", 1)[0] else (args.source, e)
            edits.append((Path(source), *edit.split("=>", 1)))
        runs.append((name, edits))
    runs.append(("A2", []))
    return max(run_variant(tag, edits, args.precision, args.batch) for tag, edits in runs)


if __name__ == "__main__":
    sys.exit(main())
