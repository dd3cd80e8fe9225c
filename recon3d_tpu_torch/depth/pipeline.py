"""Real-time stereo depth pipeline (twin of recon3d_tpu/depth/pipeline.py).

Calibrated rig -> rectification -> grayscale -> SGM -> WLS -> depth ->
display colormap, one frame a call. `depth_step_planned` rectifies with
the two-pass warp (K1 on CUDA tensors, its plain version on CPU tensors);
`depth_step` with the gather remap of ops/image.py, which `DepthPipeline`
falls back to when a map is not monotonic along its rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.calib import stereo as _stereo
from recon3d_tpu_torch.calib.npz import StereoParams
from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.depth import matcher as _matcher
from recon3d_tpu_torch.ops import image as im
from recon3d_tpu_torch.ops import warp as _warp


def _to_gray(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return im.rgb_to_gray(x) if x.ndim == 3 else x


def _finish(lg, rg, Q, mcfg, wcfg, with_wls):
    disp, valid = _matcher.compute_disparity(lg, rg, mcfg, wcfg, with_wls)
    depth = _matcher.disparity_to_depth(disp, Q)
    vis = im.colormap_jet(im.normalize_minmax(torch.where(valid, disp, 0.0), 0.0, 1.0))
    return disp, depth, vis


def depth_step(left_raw: torch.Tensor, right_raw: torch.Tensor,
               map1x: torch.Tensor, map1y: torch.Tensor,
               map2x: torch.Tensor, map2y: torch.Tensor, Q: torch.Tensor,
               mcfg: StereoMatcherConfig, wcfg: WLSConfig, with_wls: bool = True):
    """One frame: raw pair -> (disparity, depth, jet visualization), with
    the gather remap (cv2.remap -> cvtColor -> SGBM -> WLS -> normalize ->
    colormap)."""
    lg = im.remap(_to_gray(left_raw), map1x, map1y)
    rg = im.remap(_to_gray(right_raw), map2x, map2y)
    return _finish(lg, rg, Q, mcfg, wcfg, with_wls)


def depth_step_planned(left_raw: torch.Tensor, right_raw: torch.Tensor,
                       plan1: _warp.RemapPlan, plan2: _warp.RemapPlan, Q: torch.Tensor,
                       mcfg: StereoMatcherConfig, wcfg: WLSConfig, with_wls: bool = True):
    """depth_step with the two-pass rectification warp: K1 for CUDA
    tensors, the plain warp for CPU tensors."""
    lg = _warp.remap_two_pass_cuda(_to_gray(left_raw), plan1)
    rg = _warp.remap_two_pass_cuda(_to_gray(right_raw), plan2)
    return _finish(lg, rg, Q, mcfg, wcfg, with_wls)


class DepthPipeline:
    """Calibrated stereo rig -> streaming depth.

    pipe = DepthPipeline.from_npz("rig_stereo.npz", (960, 540))
    disp, depth, vis = pipe.process(left_raw, right_raw)
    pipe.adjust('w')   # live numDisparities bump

    Runs on `device` (the card unless the caller asks for the CPU).
    """

    def __init__(self, params: StereoParams, image_size: Tuple[int, int],
                 matcher_config: StereoMatcherConfig = StereoMatcherConfig(),
                 wls_config: WLSConfig = WLSConfig(), with_wls: bool = True,
                 device="cuda"):
        params.validate_for_depth()
        self.params = params
        self.image_size = image_size
        self.matcher_config = matcher_config
        self.wls_config = wls_config
        self.with_wls = with_wls
        self.device = torch.device(device)
        m1x, m1y = _stereo.rectify_maps(params.mtx1, params.dist1, params.R1, params.P1,
                                        image_size, self.device)
        m2x, m2y = _stereo.rectify_maps(params.mtx2, params.dist2, params.R2, params.P2,
                                        image_size, self.device)
        self.maps = (m1x, m1y, m2x, m2y)
        self.Q = torch.as_tensor(np.asarray(params.Q, np.float32), device=self.device)
        # two-pass warp plans; the gather remap when a map is not monotonic
        try:
            self.plans = tuple(_warp.build_remap_plan(mx.cpu().numpy(), my.cpu().numpy(),
                                                      self.device)
                               for mx, my in ((m1x, m1y), (m2x, m2y)))
        except ValueError:
            self.plans = None

    @classmethod
    def from_npz(cls, path: str, image_size: Tuple[int, int], **kw) -> "DepthPipeline":
        """A pipeline from a stereo NPZ: the full schema as saved, or the raw
        one (k1, d1, k2, d2, R, T), whose rectification is computed here by
        `stereo_rectify` in float32 on the host, as the JAX package computes
        it (64-bit floats off)."""
        params = StereoParams.load(path)
        if params.R1 is None:
            f32 = [np.asarray(a, np.float32) for a in (params.mtx1, params.dist1, params.mtx2,
                                                       params.dist2, params.R, params.T)]
            rect = _stereo.stereo_rectify(*f32[:4], image_size, *f32[4:], device="cpu")
            params = dataclasses.replace(params, **{k: v.numpy() for k, v in
                                                    rect._asdict().items()})
        return cls(params, image_size, **kw)

    def adjust(self, key: str) -> None:
        """Keyboard tuning: q/a block size, w/s disparities, e/d lambda,
        r/f sigma."""
        self.matcher_config = self.matcher_config.adjust(key)
        self.wls_config = self.wls_config.adjust(key)

    def process(self, left_raw, right_raw):
        left = torch.as_tensor(left_raw, device=self.device)
        right = torch.as_tensor(right_raw, device=self.device)
        if self.plans is not None:
            return depth_step_planned(left, right, self.plans[0], self.plans[1], self.Q,
                                      self.matcher_config, self.wls_config, self.with_wls)
        return depth_step(left, right, *self.maps, self.Q, self.matcher_config,
                          self.wls_config, self.with_wls)

    def run(self, camera_left, camera_right, max_frames: Optional[int] = None,
            on_frame=None) -> int:
        """Host capture loop over two cameras whose read() gives (ok, frame)
        with the image first in the frame."""
        from recon3d_tpu_torch.utils.logging import FPSCounter, make_logger

        fps = FPSCounter(make_logger("depth"), "depth")
        n = 0
        while max_frames is None or n < max_frames:
            ok_l, fl = camera_left.read()
            ok_r, fr = camera_right.read()
            if not (ok_l and ok_r):
                continue
            out = self.process(fl[0], fr[0])
            n += 1
            fps.tick()
            if on_frame is not None and on_frame(n, out) is False:
                break
        return n
