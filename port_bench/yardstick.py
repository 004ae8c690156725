"""The arithmetic the metrics are measured against: the H100's published
peaks, the field kernel's least time from its shapes, and device time read
from a profile.

`field_bounds` is copied from `chip_smoke.py::field_bounds` (and its
constants); `device_kernels`' rule of leaving user annotations out of the
device timeline from `chip_smoke.py::device_kernels`.
"""

from __future__ import annotations

# H100 SXM data-sheet peaks (dense): bf16 and TF32 tensor cores, f32 outside
# them, HBM3; published for a 700 W power limit
PEAK_BF16_TC = 989e12
PEAK_TF32_TC = 495e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAKS = {"bf16": PEAK_BF16_TC, "tf32": PEAK_TF32_TC, "f32": PEAK_F32}
# the FiLM epilogue's f32-pipe instructions per activation
EPILOGUE_INSTR = 14


def field_bounds(n: int, precision: str, depth: int = 8, width: int = 256, batch: int = 1,
                 sft: bool = False, raw_h: bool = True) -> dict:
    """Least time for each field entry over `batch` items of n points: the
    larger of the bytes (each input read once, each output written once) over
    the HBM rate and the operations over their pipe's peak. The full entry
    reads alpha/lbeta when `sft` and writes raw_h when `raw_h`. The 256x256
    products go to the tensor cores: `serving` once on bf16 operands,
    `highest` three times on TF32 operands (3xTF32 split products); the FiLM
    sines (~16 f32 flops each) and the K=3 layers and heads go to the f32 pipe
    beside them. bf16 weights and io in `serving`, f32 in `highest`."""
    io, f4 = (2 if precision == "serving" else 4), 4
    weights = (3 * width + (depth - 1) * width * width + width * width + 3 * width + width + 3 * width) * io
    film = batch * 2 * (depth + 1) * width * f4
    n_io = batch * n * width * io  # one [B, N, W] io tensor
    full_bytes = (batch * n * 3 * f4 * 2 + weights + film + n_io * (1 + int(raw_h) + 2 * int(sft))
                  + batch * n * 4 * f4)  # pts, dirs, [alpha, lbeta] in; feat, [raw_h], rgb_sdf out
    n *= batch
    full_tc, full_small = 2 * n * width * width * depth, 2 * n * width * (3 + 3 + 1 + 3)
    tex_bytes = n * width * io * 3 + n * 3 * f4 + (width * width + 6 * width) * io + 2 * batch * width * f4 \
        + n * width * io + n * 3 * f4  # raw_h, alpha, lbeta, dirs in; feat, rgb out
    tex_tc, tex_small = 2 * n * width * width, 2 * n * width * (3 + 3)
    tc_time = 1 / PEAK_BF16_TC if precision == "serving" else 3 / PEAK_TF32_TC  # s per tensor-core flop
    out = {}
    for name, nbytes, tc, small, acts in (
            ("siren_field_full", full_bytes, full_tc, full_small, n * width * (depth + 1)),
            ("siren_field_tex", tex_bytes, tex_tc, tex_small, n * width)):
        f32_pipe = (small + 16 * acts) / PEAK_F32
        terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": max(tc * tc_time, f32_pipe)}
        by = max(terms, key=terms.get)
        out[name] = {"bound_ms": terms[by] * 1e3, "bound_by": by,
                     "epilogue_floor_ms": EPILOGUE_INSTR * acts / (PEAK_F32 / 2) * 1e3}
    return out


def passes_bound_ms(passes: list[dict], renderer: dict, batch: int) -> float:
    """The least time of a list of field passes, each {"entry", "points",
    "sft", "raw_h"} over the call's `batch` items at the renderer's depth and
    width, in the precision of its `field_dtype`. "points": "render"
    (out_im_res^2 x n_samples), "image" (out_im_res^2), "uniform"
    (uniform_grid_sampling_num) or a number."""
    precision = "serving" if renderer["field_dtype"] == "bfloat16" else "highest"
    named = {"render": renderer["out_im_res"] ** 2 * renderer["n_samples"], "image": renderer["out_im_res"] ** 2,
             "uniform": renderer["uniform_grid_sampling_num"]}
    total = 0.0
    for p in passes:
        n = named[p["points"]] if isinstance(p["points"], str) else int(p["points"])
        b = field_bounds(n, precision, renderer["depth"], renderer["width"], batch, p.get("sft", False),
                         p.get("raw_h", False))
        total += b[p["entry"]]["bound_ms"]
    return total


def field_roofline(ctx, kernels: tuple[str, ...]) -> float | None:
    """The field kernel's share (%) of its roofline in a traced segment: the
    least time of the field passes that the cell's workload file states for
    one call (`"field_passes"`, implied by its configuration's shapes, not
    read from the launches) times the segment's calls, over the device time
    of the launches of `kernels`. None where the segment ran none."""
    kernel_s = ctx.trace.op_seconds(lambda name: any(k in name for k in kernels))
    if kernel_s <= 0:
        return None
    calls = ctx.trace.units / ctx.driver.units_per_call
    bound_ms = passes_bound_ms(ctx.cell["workload"]["field_passes"], ctx.renderer, ctx.driver.call_batch)
    return 100.0 * bound_ms * calls / (kernel_s * 1e3)


def flop_counter():
    """A dispatch mode counting FLOPs by torch's formulas
    (`torch.utils.flop_counter.flop_registry`: matmuls, convolutions,
    attention, forward and backward) into `.total`. Unlike FlopCounterMode it
    tracks no modules, whose hooks refuse the double backward of an R1
    penalty."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class FlopCount(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            packet = func._overloadpacket
            if packet not in flop_registry and func is not torch.ops.prim.device.default:
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if packet in flop_registry:
                self.total += flop_registry[packet](*args, **kwargs, out_val=out)
            return out

    return FlopCount()
