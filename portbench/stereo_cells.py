"""What the stereo drivers share: the program's settings from a
configuration, and the comparison of a frame's outputs with the reference.

A frame's outputs are a dict: `rect` (left, right) the rectified gray pair
(raw-frame cells only), `sgm` (disparity, valid), `wls` the refined
disparity, and for the raw-frame cells `depth` and `cloud` (points, valid,
colours); a batch adds `mean`, the batch's mean valid disparity. The
comparison runs the reference stage by stage: the rectification from the
raw frame, each later stage from the program's own output of the stage
before (judged on its own), and returns the numbers that the cell's limits
hold:

- rect_gap: the largest gray-level gap of the rectified pair, over pixels
  whose validity is not within 1e-3 px of a bound;
- sgm_valid_diff: the share of pixels whose SGM validity differs;
- sgm_disp_gap: the largest SGM disparity gap (px) where both are valid;
- wls_off_determined: the share of the pixels that the configuration's
  float32 solve determines whose refined disparity lies more than the
  cell's `wls_f32_px` from the float64 reference, or is not finite. A pixel
  is determined where the reference run in float32, in the stated
  arithmetic, lies within `wls_f32_px` of its float64 run; the others lie
  on line segments that floored guide edges cut off from every pixel with
  confidence, where the pivots nearly vanish and any float32 solve reads
  tens to billions of px off. Its limit is 0: every determined pixel is
  held to `wls_f32_px`. (A largest gap cannot be the number: the bfloat16
  control overflows to NaN and gives none.) Printed beside it, not
  compared: the undetermined share, the largest gap over the determined
  pixels, over all pixels, and to the float32 run;
- depth_gap, cloud_gap: the largest relative gap of depth and of the
  cloud's points, 1 where one side has a point and the other none;
- color_gap: the largest gap of the cloud's colours;
- mean_gap: the relative gap of the batch's mean valid disparity.
"""
from __future__ import annotations

import torch

from portbench.reference import stereo as ref
from portbench.rig import rig_matrices

F32, F64 = torch.float32, torch.float64


def program_configs(cfg: dict):
    """(StereoMatcherConfig, WLSConfig) of the configuration."""
    from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig

    return StereoMatcherConfig(**cfg["matcher"]), WLSConfig(**cfg["wls"])


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _rel_gap(a, b, has_a, has_b):
    """Largest |a - b| / |b| where both have a value, 1 where one has none."""
    both = has_a & has_b
    gap = (a - b).abs() / b.abs().clamp(min=1e-30)
    gap = torch.where(both, gap, torch.zeros_like(gap))
    if gap.ndim > 1:
        gap = gap.amax(-1)
    return max(_max(gap), 1.0 if bool((has_a != has_b).any()) else 0.0)


class StereoCheck:
    """The reference of one configuration: its rectifiers and Q; `f32_px` is
    the cell's `wls_f32_px`."""

    def __init__(self, cfg: dict, device, rectify: bool, f32_px: float):
        self.cfg = cfg
        self.f32_px = float(f32_px)
        self.m = dict(cfg["matcher"], border_cost=cfg["semantics"]["border_cost"])
        self.w = cfg["wls"]
        self.device = torch.device(device)
        W, H = cfg["image"]["width"], cfg["image"]["height"]
        rig = cfg["rig"]
        self.Q = ref.q_matrix(rig["f_rect_px"], rig["baseline_m"], rig["rect_cx"], rig["rect_cy"],
                              device=self.device)
        self.rect = None
        self.diagnostics = []  # readings beside the numbers, printed, not compared
        if rectify:
            r = rig_matrices(cfg)
            self.rect = [ref.Rectifier(r[f"K{i}"], r[f"dist{i}"], r[f"R{i}"], r[f"P{i}"], W, H,
                                       self.device) for i in (1, 2)]

    # ---- the numbers of a batch of frames --------------------------------------
    def numbers(self, outs: list, raws: list = None, grays: list = None) -> list:
        """The numbers of each frame. outs: the frames' outputs; raws: their
        (left, right) uint8 colour frames (raw-frame cells) or grays: their
        (left, right) rectified uint8 frames."""
        dev = self.device
        nums = [{} for _ in outs]
        if raws is not None:
            for n, out, raw in zip(nums, outs, raws):
                gaps = []
                for img, rect, prog in zip(raw, self.rect, out["rect"]):
                    want = rect(ref.to_gray(img.to(dev)))
                    gaps.append(_max((prog.to(dev, F64) - want).abs()[~rect.ambiguous]))
                n["rect_gap"] = max(gaps)
        pairs = [o.get("sgm_in", o.get("rect")) for o in outs] if raws is not None else grays
        left = torch.stack([p[0].to(dev, F32) for p in pairs])
        right = torch.stack([p[1].to(dev, F32) for p in pairs])
        d_ref, v_ref = ref.sgm(left, right, self.m, F32)
        d_p = torch.stack([o["sgm"][0].to(dev, F32) for o in outs])
        v_p = torch.stack([o["sgm"][1].to(dev) for o in outs])
        for b, n in enumerate(nums):
            n["sgm_valid_diff"] = float((v_ref[b] != v_p[b]).to(F64).mean())
            n["sgm_disp_gap"] = _max((d_ref[b] - d_p[b]).abs()[v_ref[b] & v_p[b]])
        del d_ref, v_ref
        d_in = torch.stack([o.get("wls_in", o["sgm"])[0].to(dev, F32) for o in outs])
        v_in = torch.stack([o.get("wls_in", o["sgm"])[1].to(dev) for o in outs])
        u_ref = ref.wls(d_in, v_in, left, self.w, F64)
        u_f32 = ref.wls(d_in, v_in, left, self.w, F32).to(F64)
        for b, (n, out) in enumerate(zip(nums, outs)):
            prog = out["wls"].to(dev, F64)
            gap = (u_ref[b] - prog).abs()
            determined = (u_f32[b] - u_ref[b]).abs() <= self.f32_px
            off = determined & ~(gap <= self.f32_px)  # NaN is off
            n["wls_off_determined"] = float(off.sum()) / max(1, int(determined.sum()))
            self.diagnostics.append({"wls_undetermined_share": float((~determined).to(F64).mean()),
                                     "wls_gap_determined": _max(gap[determined]),
                                     "wls_max_px_all": _max(gap),
                                     "wls_max_px_to_f32": _max((u_f32[b] - prog).abs())})
        del u_ref, u_f32
        if raws is not None:
            for n, out, raw in zip(nums, outs, raws):
                depth, pts, valid, cols = ref.depth_and_cloud(
                    out.get("cloud_in", out["wls"]).to(dev), self.Q, raw[0].to(dev), dtype=F64)
                d_p = out["depth"].to(dev, F64)
                n["depth_gap"] = _rel_gap(d_p, depth, d_p > 0, depth > 0)
                p_pts, p_valid, p_cols = (t.to(dev) for t in out["cloud"])
                n["cloud_gap"] = _rel_gap(p_pts.to(F64), pts, p_valid[:, None], valid[:, None])
                n["color_gap"] = _max((p_cols.to(F64) - cols).abs())
        return nums

    def batch_mean_gap(self, mean, wls_disps) -> float:
        """Relative gap of the batch's mean valid disparity, from the
        program's refined disparities."""
        d = torch.stack([u.to(self.device, F64) for u in wls_disps])
        ok = d > 0
        want = torch.where(ok, d, torch.zeros_like(d)).sum() / ok.sum().clamp(min=1)
        return abs(float(mean) - float(want)) / max(abs(float(want)), 1e-30)


def control_outputs(check: StereoCheck, raws: list = None, grays: list = None,
                    dtype=torch.bfloat16) -> list:
    """The reference in `dtype` put in the program's place, stage by stage:
    each stage computed in the lower precision from the input that the
    reference's own chain gives it (`sgm_in`, `wls_in`, `cloud_in`), as the
    check judges each stage of the program from the program's own input."""
    dev = check.device
    if raws is not None:
        rect = [tuple(check.rect[i](ref.to_gray(raw[i].to(dev), dtype)) for i in (0, 1))
                for raw in raws]
        pairs = [tuple(check.rect[i](ref.to_gray(raw[i].to(dev))).to(F32) for i in (0, 1))
                 for raw in raws]
    else:
        pairs = [tuple(g.to(dev, F32) for g in gray) for gray in grays]
    left = torch.stack([p[0] for p in pairs])
    right = torch.stack([p[1] for p in pairs])
    d_low, v_low = ref.sgm(left.to(dtype), right.to(dtype), check.m, dtype)
    d, v = ref.sgm(left, right, check.m, F32)
    u_low = ref.wls(d, v, left, check.w, dtype)
    u = ref.wls(d, v, left, check.w, F64)
    outs = []
    for b in range(len(pairs)):
        out = {"sgm_in": pairs[b], "sgm": (d_low[b], v_low[b]), "wls_in": (d[b], v[b]),
               "wls": u_low[b], "cloud_in": u[b]}
        if raws is not None:
            depth, pts, valid, cols = ref.depth_and_cloud(u[b].to(dtype), check.Q.to(dtype),
                                                          raws[b][0].to(dev), dtype=dtype)
            out.update(rect=rect[b], depth=depth, cloud=(pts, valid, cols))
        outs.append(out)
    return outs
