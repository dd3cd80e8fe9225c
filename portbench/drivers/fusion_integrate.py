"""The integrate stage of a scanner with known poses, one frame a step.

A step uploads the scan's next frame (depth metres, colour, extrinsic) and
runs `tsdf.integrate` into the scan's volume; every `scan_frames` frames a
fresh volume starts. Cell parameters (`traffic`): `pool` posed frames,
`scan_frames`, and the check: the volume after a frame count drawn from
the seed in [`check_from`, `check_to`) of the first scan, and the volume
at the window's close.
"""
from __future__ import annotations

import torch

from portbench import fusion_cells as fc
from portbench import work
from portbench.scenes import chosen


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        from recon3d_tpu_torch.fusion import tsdf

        self.cfg, self.cell, self.device = cfg, cell, torch.device(device)
        t = cell["traffic"]
        self.pool = fc.FramePool(cfg, t["pool"], seed, self.device)
        self.intr = fc.program_intrinsics(cfg)
        self.integrate = tsdf.integrate
        self.scan_frames = t["scan_frames"]
        self.snap_at = chosen(seed, 1, t["check_from"], t["check_to"])[0]
        self.vol = fc.program_volume(cfg, self.device)
        self.frame = 0
        self.snap = None
        c, ts = cfg["camera"], cfg["tsdf"]
        self.work_ = {"integrate": work.integrate_work(ts["resolution"], c["height"], c["width"],
                                                       ts["color"], 1)}

    def _integrate(self, vol, k: int):
        i = self.pool.index(k)
        d = torch.from_numpy(self.pool.depth[i]).to(self.device)
        c = torch.from_numpy(self.pool.color[i]).to(self.device)
        e = torch.from_numpy(self.pool.ext[i]).to(self.device)
        ts = self.cfg["tsdf"]
        return self.integrate(vol, d, self.intr, e, color=c, depth_trunc=ts["depth_trunc"],
                              weight_max=ts["weight_max"])

    def warmup(self) -> None:
        vol = fc.program_volume(self.cfg, self.device)
        for k in range(self.cell["warmup_steps"]):
            vol = self._integrate(vol, k)
        fc.snapshot(vol)  # the copies of a compared state, allocated once here

    def step(self) -> int:
        k = self.frame % self.scan_frames
        if k == 0 and self.frame:
            self.vol = fc.program_volume(self.cfg, self.device)
        self.vol = self._integrate(self.vol, k)
        self.frame += 1
        if self.frame == self.snap_at:
            self.snap = fc.snapshot(self.vol)
        return 1

    def work(self) -> dict:
        return self.work_

    def finish(self) -> None:
        v = self.vol
        # frames in the last scan's volume: a whole scan when the window
        # closed on its last frame (the fresh volume comes with the next)
        done = (self.frame - 1) % self.scan_frames + 1 if self.frame else 0
        self.final = ((v.tsdf, v.weight, v.color), done)
        self.vol = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        states = [(self.snap, self.snap_at)] if self.snap is not None else []
        return fc.judge(self.cfg, self.pool, states + [self.final], self.device), int(
            self.snap is None)

    def control(self, dtype):
        """The control's numbers over the frames of the state the seed chose."""
        return fc.control(self.cfg, self.pool, self.snap_at, self.device, dtype)
