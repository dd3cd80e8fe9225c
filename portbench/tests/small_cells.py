"""Small versions of the benchmark's configurations and cells, for runs on
the CPU (the program's plain versions; the kernels run only on a card)."""
from __future__ import annotations

import copy

STEREO_W, STEREO_H, STEREO_D = 256, 64, 32
FUSION_R, FUSION_W, FUSION_H = 32, 80, 60


def small_stereo(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    s = STEREO_W / cfg["image"]["width"]
    sy = STEREO_H / cfg["image"]["height"]
    cfg["image"] = {"width": STEREO_W, "height": STEREO_H}
    rig = cfg["rig"]
    rig["f_rect_px"] *= s
    rig["rect_cx"] *= s
    rig["rect_cy"] *= sy
    for k in ("K1", "K2"):
        K = rig[k]
        K[0][0] *= s
        K[0][2] *= s
        K[1][1] *= s
        K[1][2] *= sy
    cfg["matcher"]["num_disparities"] = STEREO_D
    return cfg


def small_fusion(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    s = FUSION_W / cfg["camera"]["width"]
    c = cfg["camera"]
    c.update(width=FUSION_W, height=FUSION_H, fx=c["fx"] * s, fy=c["fy"] * s, cx=c["cx"] * s,
             cy=c["cy"] * s)
    t = cfg["tsdf"]
    t["voxel_size"] *= t["resolution"] / FUSION_R
    t["sdf_trunc"] *= t["resolution"] / FUSION_R
    t["resolution"] = FUSION_R
    return cfg


def small_cell(cell: dict) -> dict:
    cell = copy.deepcopy(cell)
    t = cell["traffic"]
    if "scan_frames" in t:
        t.update(pool=6, scan_frames=24 if "batch" in t else 20)
        t.update(check_from=1, check_to=3) if "batch" in t else t.update(check_from=1, check_to=4)
    else:
        t.update(pool=4 if "batch" in t else 2, checked=1, check_from=0, check_to=2)
    cell["warmup_steps"] = 1
    cell["trace_steps"] = 2
    return cell


def small(reg, name: str):
    """(cell, config) of a cell at its small size."""
    cell = reg.cell(name)
    cfg = reg.config(cell["config"])
    cfg = small_stereo(cfg) if "matcher" in cfg else small_fusion(cfg)
    return small_cell(cell), cfg
