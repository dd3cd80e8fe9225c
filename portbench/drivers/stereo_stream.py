"""A live rig: raw colour pairs from the host, one frame in flight.

A step uploads the next raw BGR pair of the pool (cycled; page-locked host
memory), runs `DepthPipeline.process(left, right)` and
`backproject_disparity(disp, Q, color=left)`; the harness's synchronize
ends it when the cloud is ready on the device. Cell parameters (`traffic`): `pool` scenes, `checked` frames
compared with the reference, drawn from the seed among the window's frames
[`check_from`, `check_to`) (after the traced steps, whose work a checked
frame's copies would change).
"""
from __future__ import annotations

import torch

from portbench import stereo_cells as sc
from portbench import work
from portbench.rig import rig_matrices
from portbench.scenes import StereoScenes, chosen, host_frames
from portbench.tap import Tap


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        from recon3d_tpu_torch.calib.npz import StereoParams
        from recon3d_tpu_torch.depth import sgm_cuda
        from recon3d_tpu_torch.depth.pipeline import DepthPipeline
        from recon3d_tpu_torch.ops import warp
        from recon3d_tpu_torch.pointcloud.backproject import backproject_disparity

        self.cfg, self.cell, self.device = cfg, cell, torch.device(device)
        t = cell["traffic"]
        W, H = cfg["image"]["width"], cfg["image"]["height"]
        rig = rig_matrices(cfg)
        scenes = StereoScenes(t["pool"], W, H, cfg["rig"]["f_rect_px"], cfg["rig"]["baseline_m"],
                              seed, self.device)
        left, right = scenes.raw_bgr(rig)
        self.pool = [(host_frames(left[i], device), host_frames(right[i], device))
                     for i in range(t["pool"])]
        del scenes, left, right
        params = StereoParams(mtx1=rig["K1"], dist1=rig["dist1"], mtx2=rig["K2"],
                              dist2=rig["dist2"], R=rig["R"], T=rig["T"], R1=rig["R1"],
                              R2=rig["R2"], P1=rig["P1"], P2=rig["P2"], Q=rig["Q"])
        mcfg, wcfg = sc.program_configs(cfg)
        self.pipe = DepthPipeline(params, (W, H), mcfg, wcfg, with_wls=cfg["with_wls"],
                                  device=self.device)
        if self.pipe.plans is None:
            raise RuntimeError("the rig's maps do not allow the two-pass warp")
        self.backproject = backproject_disparity
        self.tap = Tap()
        self.tap.wrap(warp, "remap_two_pass_cuda", "rect")
        self.tap.wrap(sgm_cuda, "sgm_disparity_cuda", "sgm")
        self.checked = set(chosen(seed, t["checked"], t["check_from"], t["check_to"]))
        self.kept = {}
        self.frame = 0
        self.work_ = {"sgm": work.sgm_work(H, W, mcfg.num_disparities, 4, mcfg.block_size)}

    def _frame(self, i: int):
        left, right = self.pool[i]
        lt, rt = left.to(self.device), right.to(self.device)
        disp, depth, _ = self.pipe.process(lt, rt)
        return disp, depth, self.backproject(disp, self.pipe.Q, color=lt)

    def warmup(self) -> None:
        for i in range(self.cell["warmup_steps"]):
            self.tap.armed = True  # the copies a checked frame makes, allocated once here
            self._frame(i % len(self.pool))
            self.tap.armed = False
            self.tap.take()

    def step(self) -> int:
        k = self.frame
        check = k in self.checked
        self.tap.armed = check
        disp, depth, pc = self._frame(k % len(self.pool))
        if check:
            kept = self.tap.take()
            self.kept[k] = {"rect": tuple(kept["rect"]), "sgm": kept["sgm"][0],
                            "wls": disp.clone(), "depth": depth.clone(),
                            "cloud": (pc.points.clone(), pc.valid.clone(), pc.colors.clone())}
            self.tap.armed = False
        self.frame += 1
        return 1

    def work(self) -> dict:
        return self.work_

    def finish(self) -> None:
        self.tap.restore()
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        chk = sc.StereoCheck(self.cfg, self.device, rectify=True,
                             f32_px=self.cell["wls_f32_px"])
        keys = sorted(self.kept)
        raws = [self.pool[k % len(self.pool)] for k in keys]
        samples = chk.numbers([self.kept.pop(k) for k in keys], raws=raws) if keys else []
        self.diagnostics = chk.diagnostics
        return samples, len(self.checked) - len(samples)

    def control(self, dtype):
        """The control's numbers: the reference in `dtype` in the program's
        place, on the frames the seed chose for the check."""
        chk = sc.StereoCheck(self.cfg, self.device, rectify=True,
                             f32_px=self.cell["wls_f32_px"])
        raws = [self.pool[k % len(self.pool)] for k in sorted(self.checked)]
        samples = chk.numbers(sc.control_outputs(chk, raws=raws, dtype=dtype), raws=raws)
        self.diagnostics = chk.diagnostics
        return samples
