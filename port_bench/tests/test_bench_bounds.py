"""The copied roofline arithmetic reproduces the port's recorded bounds, and
each cell's field passes (its workload file) are the field work its
configuration implies."""

import pytest

from port_bench import manifest
from port_bench.yardstick import field_bounds, passes_bound_ms

MAN = manifest.manifest()


@pytest.mark.parametrize("batch, want", [(1, 0.625), (4, 2.499)])
def test_highest_full_bound(batch, want):
    b = field_bounds(98_304, "highest", batch=batch)["siren_field_full"]
    assert b["bound_by"] == "operations" and round(b["bound_ms"], 3) == want


def _bound(n, batch, entry="siren_field_full", **kw):
    return field_bounds(n, "highest", batch=batch, **kw)[entry]["bound_ms"]


@pytest.mark.parametrize("cell", ["i2i_b1", "i2i_b8"])
def test_inversion_passes(cell):
    c = manifest.cell(cell)
    b = c["workload"]["traffic"]["batch"]
    want = _bound(98_304, b, raw_h=True) + _bound(98_304, b, "siren_field_tex", sft=True)
    assert passes_bound_ms(c["workload"]["field_passes"], c["config"]["e3dge"]["renderer"], b) == pytest.approx(want)


def test_stage22_passes():
    """Per iteration at B=4: the D producer's sample render (no raw_h), its
    near-surface (64^2) and uniform SDF targets, its inversion's render
    keeping raw_h and texture pass with the SFT; the cycle step's sample
    render and two SDF targets, the reference render and the query render
    keeping raw_h."""
    c = manifest.cell("st2_b4")
    r = c["config"]["e3dge"]["renderer"]
    sample = _bound(98_304, 4) + _bound(4_096, 4) + _bound(r["uniform_grid_sampling_num"], 4)
    want = 2 * sample + 2 * _bound(98_304, 4, raw_h=True) + _bound(98_304, 4, "siren_field_tex", sft=True) \
        + _bound(98_304, 4)
    assert passes_bound_ms(c["workload"]["field_passes"], r, 4) == pytest.approx(want)


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_roofline_cells_state_their_passes(name):
    c = manifest.cell(name)
    if any(m["name"].endswith("field_roofline") for m in c["per_layer"]):
        passes = c["workload"]["field_passes"]
        assert passes and all(p["entry"] in ("siren_field_full", "siren_field_tex") and p["of"] for p in passes)


@pytest.mark.parametrize("cell, units, calls", [("i2i_b8", 24, 3), ("st2_b4", 3, 3)])
def test_field_roofline_share(cell, units, calls):
    """The share is the stated passes' bound times the segment's calls over
    the field kernels' device time, whatever a call's units are."""
    from types import SimpleNamespace

    from port_bench.yardstick import field_roofline

    c = manifest.cell(cell)
    r = c["config"]["e3dge"]["renderer"]
    b = c["workload"]["traffic"]["batch"] if cell.startswith("i2i") else c["config"]["train"]["batch"]
    kernel_s = 0.05
    trace = SimpleNamespace(units=units, op_seconds=lambda match: kernel_s if match("siren_field_tf32_kernel") else 0)
    ctx = SimpleNamespace(trace=trace, cell=c, renderer=r,
                          driver=SimpleNamespace(call_batch=b, units_per_call=units // calls))
    want = 100 * passes_bound_ms(c["workload"]["field_passes"], r, b) * calls / (kernel_s * 1e3)
    assert field_roofline(ctx, ("siren_field_tf32_kernel",)) == pytest.approx(want)
    assert field_roofline(ctx, ("no_such_kernel",)) is None
