"""Offline reprocessing of a recorded, already rectified sequence.

A step uploads the next `batch` rectified gray uint8 pairs of the pool
(cycled, in order; page-locked host memory) and runs `batched_depth` over an in-process mesh of
`shards` frame shards on the one card; the harness's synchronize ends it.
Cell parameters (`traffic`): `pool` pairs, `batch`, `shards`, and
`checked` steps compared with the reference (every frame of a step and the
batch's mean), drawn from the seed among the window's steps
[`check_from`, `check_to`) (after the traced steps).
"""
from __future__ import annotations

import torch

from portbench import stereo_cells as sc
from portbench import work
from portbench.harness import worst
from portbench.scenes import StereoScenes, chosen, host_frames
from portbench.tap import Tap


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        from recon3d_tpu_torch.depth import sgm_cuda
        from recon3d_tpu_torch.parallel.batch import batched_depth
        from recon3d_tpu_torch.parallel.mesh import make_mesh

        self.cfg, self.cell, self.device = cfg, cell, torch.device(device)
        t = cell["traffic"]
        self.batch = t["batch"]
        if t["pool"] % self.batch:
            raise ValueError("the pool must hold whole batches")
        W, H = cfg["image"]["width"], cfg["image"]["height"]
        scenes = StereoScenes(t["pool"], W, H, cfg["rig"]["f_rect_px"], cfg["rig"]["baseline_m"],
                              seed, self.device)
        left, right = scenes.rectified_gray()
        self.steps = [(host_frames(left[i:i + self.batch], device),
                       host_frames(right[i:i + self.batch], device))
                      for i in range(0, t["pool"], self.batch)]
        del scenes, left, right
        self.mcfg, self.wcfg = sc.program_configs(cfg)
        self.mesh = make_mesh(t["shards"], device=self.device)
        self.batched_depth = batched_depth
        self.tap = Tap()
        self.tap.wrap(sgm_cuda, "sgm_disparity_cuda", "sgm")
        self.checked = set(chosen(seed, t["checked"], t["check_from"], t["check_to"]))
        self.kept = {}
        self.step_no = 0
        self.work_ = {"sgm": work.sgm_work(H, W, self.mcfg.num_disparities, 4,
                                           self.mcfg.block_size)}

    def _step(self, i: int):
        left, right = self.steps[i]
        lt, rt = left.to(self.device), right.to(self.device)
        return self.batched_depth(lt, rt, self.mesh, self.mcfg, self.wcfg, self.cfg["with_wls"])

    def warmup(self) -> None:
        for i in range(self.cell["warmup_steps"]):
            self.tap.armed = True  # the copies a checked step makes, allocated once here
            self._step(i % len(self.steps))
            self.tap.armed = False
            self.tap.take()

    def step(self) -> int:
        k = self.step_no
        check = k in self.checked
        self.tap.armed = check
        disp, valid, mean = self._step(k % len(self.steps))
        if check:
            self.kept[k] = {"sgm": self.tap.take()["sgm"], "wls": disp.clone(),
                            "mean": mean.clone()}
            self.tap.armed = False
        self.step_no += 1
        return self.batch

    def work(self) -> dict:
        return self.work_

    def finish(self) -> None:
        self.tap.restore()
        self.mesh = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _grays(self, k: int) -> list:
        left, right = self.steps[k % len(self.steps)]
        return [(left[b], right[b]) for b in range(self.batch)]

    def check(self):
        chk = sc.StereoCheck(self.cfg, self.device, rectify=False,
                             f32_px=self.cell["wls_f32_px"])
        samples, missing = [], len(self.checked) - len(self.kept)
        for k in sorted(self.kept):
            kept = self.kept.pop(k)
            if len(kept["sgm"]) != self.batch:  # frames of the batch never came
                missing += 1
                continue
            outs = [{"sgm": kept["sgm"][b], "wls": kept["wls"][b]} for b in range(self.batch)]
            nums = chk.numbers(outs, grays=self._grays(k))
            top = {key: worst(n[key] for n in nums) for key in nums[0]}
            top["mean_gap"] = chk.batch_mean_gap(kept["mean"], list(kept["wls"]))
            samples.append(top)
        self.diagnostics = chk.diagnostics
        return samples, missing

    def control(self, dtype):
        """The control's numbers: the reference in `dtype` in the program's
        place, on the steps the seed chose for the check."""
        chk = sc.StereoCheck(self.cfg, self.device, rectify=False,
                             f32_px=self.cell["wls_f32_px"])
        samples = []
        for k in sorted(self.checked):
            grays = self._grays(k)
            outs = sc.control_outputs(chk, grays=grays, dtype=dtype)
            nums = chk.numbers(outs, grays=grays)
            top = {key: worst(n[key] for n in nums) for key in nums[0]}
            u = torch.stack([o["cloud_in"] for o in outs])  # the refined disparities
            ok = u > 0
            mean = torch.where(ok, u, torch.zeros_like(u)).to(dtype).sum() / ok.sum().to(dtype)
            top["mean_gap"] = chk.batch_mean_gap(mean, list(u))
            samples.append(top)
        self.diagnostics = chk.diagnostics
        return samples
