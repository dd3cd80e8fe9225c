"""The sharded streaming consumer draining a backlog, `batch` frames a step.

A step stacks the scan's next `batch` frames (depth metres, colour,
extrinsics), uploads them and runs `integrate_frames_exact` over an
in-process mesh of `shards` frame shards on the one card; every
`scan_frames` frames a fresh volume starts. Cell parameters (`traffic`):
`pool`, `scan_frames` (a multiple of `batch`), `batch`, `shards`, and the
check: the volume after a step count drawn from the seed in
[`check_from`, `check_to`) of the first scan, and the volume at the
window's close.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import fusion_cells as fc
from portbench import work
from portbench.scenes import chosen


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        from recon3d_tpu_torch.parallel.fusion import integrate_frames_exact
        from recon3d_tpu_torch.parallel.mesh import make_mesh

        self.cfg, self.cell, self.device = cfg, cell, torch.device(device)
        t = cell["traffic"]
        self.batch = t["batch"]
        if t["scan_frames"] % self.batch:
            raise ValueError("a scan must hold whole batches")
        self.pool = fc.FramePool(cfg, t["pool"], seed, self.device)
        self.intr = fc.program_intrinsics(cfg)
        self.mesh = make_mesh(t["shards"], device=self.device)
        self.integrate = integrate_frames_exact
        self.scan_steps = t["scan_frames"] // self.batch
        self.snap_at = chosen(seed, 1, t["check_from"], t["check_to"])[0]
        self.vol = fc.program_volume(cfg, self.device)
        self.step_no = 0
        self.snap = None
        c, ts = cfg["camera"], cfg["tsdf"]
        self.work_ = {"integrate": work.per_frame(
            work.integrate_work(ts["resolution"], c["height"], c["width"], ts["color"],
                                self.batch), self.batch)}

    def _integrate(self, vol, s: int):
        idx = [self.pool.index(s * self.batch + b) for b in range(self.batch)]
        dev = self.device
        d = torch.from_numpy(np.stack([self.pool.depth[i] for i in idx])).to(dev)
        c = torch.from_numpy(np.stack([self.pool.color[i] for i in idx])).to(dev)
        e = torch.from_numpy(np.stack([self.pool.ext[i] for i in idx])).to(dev)
        ts = self.cfg["tsdf"]
        return self.integrate(vol, d, e, self.intr, self.mesh, colors=c,
                              depth_trunc=ts["depth_trunc"], weight_max=ts["weight_max"])

    def warmup(self) -> None:
        vol = fc.program_volume(self.cfg, self.device)
        for s in range(self.cell["warmup_steps"]):
            vol = self._integrate(vol, s)
        fc.snapshot(vol)  # the copies of a compared state, allocated once here

    def step(self) -> int:
        s = self.step_no % self.scan_steps
        if s == 0 and self.step_no:
            self.vol = fc.program_volume(self.cfg, self.device)
        self.vol = self._integrate(self.vol, s)
        self.step_no += 1
        if self.step_no == self.snap_at:
            self.snap = fc.snapshot(self.vol)
        return self.batch

    def work(self) -> dict:
        return self.work_

    def finish(self) -> None:
        v = self.vol
        # steps in the last scan's volume: a whole scan when the window
        # closed on its last step (the fresh volume comes with the next)
        done = (self.step_no - 1) % self.scan_steps + 1 if self.step_no else 0
        self.final = ((v.tsdf, v.weight, v.color), done * self.batch)
        self.vol = self.mesh = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        states = [(self.snap, self.snap_at * self.batch)] if self.snap is not None else []
        return fc.judge(self.cfg, self.pool, states + [self.final], self.device), int(
            self.snap is None)

    def control(self, dtype):
        """The control's numbers over the frames of the state the seed chose."""
        return fc.control(self.cfg, self.pool, self.snap_at * self.batch, self.device, dtype)
