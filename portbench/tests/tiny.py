"""Tiny cells for the CPU tests: each real cell's files with the widths,
depths and sizes cut so that a run on the CPU takes a second or two."""

from __future__ import annotations

from portbench import common


def tiny_cell(name: str) -> dict:
    cell = common.cell_files(name)
    c, t = cell["config_data"], cell["traffic_data"]
    if "stage1" in c["model"]:
        c["model"]["stage1"].update(num_feat=8, num_block=2, num_grow_ch=4)
        c["model"]["stage2"].update(embed_dim=12, depths=[2, 2],
                                    num_heads=[2, 2], window_size=4)
        c["assumed"]["init"]["out_gain"] = {"stage1": 0.3, "stage2": 0.1}
    else:
        c["model"].update(num_feat=8, num_block=2, num_grow_ch=4)
        c["assumed"]["init"]["out_gain"] = 0.05
    if t["kind"] == "photo_frames":
        t.update(height=24, width=32, pool=2, octaves=[[8, 0.5], [2, 0.5]])
        cell["entry"].update(tile=[12, 8], halo=2, tail_batch=3)
    elif name.endswith("patch_b1"):
        t.update(size=16, pool=3)
        cell["entry"]["output_size"] = 64
        cell["sample"] = 2
    elif name.endswith("upscale_1k"):
        t.update(size=32, pool=2)
        cell["entry"].update(tile=16, halo=4, batch=2)
    elif name.endswith("train_b4"):
        t.update(size=32, pool=8)
        c["train"]["hr_patch"] = 32
        c["train"]["num_workers"] = 1
    cell["trace_units"] = 2
    return cell
