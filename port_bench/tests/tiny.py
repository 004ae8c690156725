"""A cell of the manifest at `tiny_full_config`, for runs on the CPU."""

from __future__ import annotations

import json

from port_bench import manifest


def tiny_cell(name: str, **traffic) -> dict:
    """Cell `name` with the port's tiny_full_config in place of its
    configuration's widths, a 32^2 D and small traffic."""
    from e3dge_torch import config as C

    cell = manifest.cell(name)
    cell["config"]["e3dge"] = json.loads(json.dumps(C.tiny_full_config().to_dict()))
    cell["config"]["control"] = {"dtype": "bfloat16", "renderer": {"field_dtype": "bfloat16"}}
    if "train" in cell["config"]:
        cell["config"]["train"]["d_res"] = 32
        cell["workload"]["traffic"].update(reals=8, traced=1)
    else:
        cell["workload"]["traffic"].update(photo_res=32, pool=4, warmup=1, sample=2, traced=1)
    cell["workload"]["traffic"].update(traffic)
    return cell
