"""Plain reference of TSDF integration, frame by frame.

Written from the configuration's stated semantics, in plain PyTorch, and
importing nothing of the program. Each voxel centre (index * voxel +
origin) is moved into the camera by the frame's extrinsic (camera from
world), projected with the intrinsics and rounded half to even to a pixel.
A voxel in front of the camera and inside the frame whose depth sample d
lies in (1e-4, depth_trunc) and whose signed distance d - z exceeds
-sdf_trunc takes the update: its truncated distance clamp((d - z) /
sdf_trunc, -1, 1) and the colour at the pixel (/ 255) join running
averages weighted by the stored weight, which then grows by one up to
weight_max. The checks run it in float64; the control in bfloat16.
"""
from __future__ import annotations

import torch

F64 = torch.float64


class Volume:
    """Dense (R, R, R) tsdf, weight and (R, R, R, 3) colour in `dtype`."""

    def __init__(self, tsdf_cfg: dict, device, dtype=F64):
        R = int(tsdf_cfg["resolution"])
        self.cfg, self.dtype = tsdf_cfg, dtype
        self.tsdf = torch.zeros((R, R, R), dtype=dtype, device=device)
        self.weight = torch.zeros((R, R, R), dtype=dtype, device=device)
        self.color = torch.zeros((R, R, R, 3), dtype=dtype, device=device)
        idx = torch.arange(R, dtype=dtype, device=device)
        g = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1)
        origin = torch.as_tensor(tsdf_cfg["origin"], dtype=dtype, device=device)
        self.centers = g * float(tsdf_cfg["voxel_size"]) + origin

    def integrate(self, depth_m, color_u8, extrinsic, cam: dict):
        """Fuse one frame: depth (H, W) metres, colour (H, W, 3) uint8,
        extrinsic (4, 4) camera from world."""
        cfg, dt = self.cfg, self.dtype
        H, W = depth_m.shape
        E = torch.as_tensor(extrinsic, device=self.tsdf.device).to(dt)
        p = self.centers @ E[:3, :3].T + E[:3, 3]
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        zc = torch.clamp(z, min=1e-9)
        u = torch.round(cam["fx"] * x / zc + cam["cx"])
        v = torch.round(cam["fy"] * y / zc + cam["cy"])
        inb = (z > 1e-6) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        ui = torch.where(inb, u, torch.zeros_like(u)).long()
        vi = torch.where(inb, v, torch.zeros_like(v)).long()
        d = depth_m.to(dt)[vi, ui]
        trunc = float(cfg["sdf_trunc"])
        sdf = d - z
        upd = inb & (d > 1e-4) & (d < float(cfg["depth_trunc"])) & (sdf > -trunc)
        w_old = self.weight
        den = w_old + 1.0
        new_t = torch.clamp(sdf / trunc, -1.0, 1.0)
        self.tsdf = torch.where(upd, (self.tsdf * w_old + new_t) / den, self.tsdf)
        c = color_u8.to(dt)[vi, ui] / 255.0
        self.color = torch.where(upd[..., None], (self.color * w_old[..., None] + c)
                                 / den[..., None], self.color)
        self.weight = torch.where(upd, torch.clamp(den, max=float(cfg["weight_max"])), w_old)
