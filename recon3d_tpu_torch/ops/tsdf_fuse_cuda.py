"""The TSDF frame update on the card in one pass a voxel (source
csrc/tsdf_fuse.cu): the projection, K9's sample and the running average of
fusion/tsdf.py fused, bitwise with its plain version.

It replaces no TPU kernel of its own. The JAX package leaves the voxel
centers, the camera transform and the update of fusion/tsdf.py to XLA and
samples with K9; on the card that glue was some 270 full-volume PyTorch
operations a frame. One launch does a frame in either mode:

- fold (`old` given): the new (tsdf, weight, color) of a volume after the
  frame, written whole into new tensors, as integrate() returns them;
- contribution: the frame's summands (where(upd, tsdf, 0), upd as float,
  where(upd, color, 0)), as fusion/tsdf.py:_frame_contrib returns them.

The pose, origin, voxel size and sdf_trunc are read from device memory
(no host copy); fx, fy, cx, cy, depth_trunc and weight_max are float32
arguments, rounded as PyTorch rounds a Python scalar. `.launches` counts
the launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from recon3d_tpu_torch import kernels

_COLOR_KIND = {torch.uint8: 1, torch.float32: 2}


def _need(t: torch.Tensor, what: str, shape: tuple, dtypes=(torch.float32,)) -> None:
    if t.dtype not in dtypes or tuple(t.shape) != shape:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{what} must be {names} of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def fuse_voxels_cuda(origin: torch.Tensor, voxel_size: torch.Tensor, sdf_trunc: torch.Tensor,
                     resolution: int, depth: torch.Tensor, color: Optional[torch.Tensor],
                     extrinsic: torch.Tensor, intr, depth_trunc: float,
                     old: Optional[Tuple] = None, weight_max: float = 64.0):
    """One frame over an (R, R, R) volume at `origin` (3,), `voxel_size` and
    `sdf_trunc` (0-d float32): depth (H, W) float32 metres, color (H, W, 3)
    uint8 or float32 or None, extrinsic (4, 4) float32 camera_from_world, all
    contiguous CUDA tensors. With `old` = (tsdf, weight, color or None), the
    volume before the frame, returns its (tsdf, weight, color) after it
    (color None where no color is given); without, the frame's contribution
    (n, w, cf), cf None where no color is given."""
    R = int(resolution)
    if R < 1:
        raise ValueError(f"resolution must be positive, got {R}")
    _need(origin, "origin", (3,))
    _need(voxel_size, "voxel_size", ())
    _need(sdf_trunc, "sdf_trunc", ())
    _need(extrinsic, "extrinsic", (4, 4))
    if depth.ndim != 2:
        raise ValueError(f"depth must be (H, W), got {tuple(depth.shape)}")
    H, W = depth.shape
    _need(depth, "depth", (H, W))
    if color is not None:
        _need(color, "color", (H, W, 3), tuple(_COLOR_KIND))
    tensors = [origin, voxel_size, sdf_trunc, extrinsic, depth]
    if old is not None:
        t_old, w_old, c_old = old
        _need(t_old, "tsdf", (R, R, R))
        _need(w_old, "weight", (R, R, R))
        if color is not None:
            if c_old is None:
                raise ValueError("a color frame folds into a volume with color")
            _need(c_old, "volume color", (R, R, R, 3))
            tensors.append(c_old)
        tensors += [t_old, w_old]
    if color is not None:
        tensors.append(color)
    if not kernels.use_kernel(*tensors):
        raise ValueError(f"the TSDF fuse kernel runs on CUDA tensors, got {depth.device}")

    dev = depth.device
    out_t = torch.empty((R, R, R), dtype=torch.float32, device=dev)
    out_w = torch.empty((R, R, R), dtype=torch.float32, device=dev)
    out_c = (torch.empty((R, R, R, 3), dtype=torch.float32, device=dev)
             if color is not None else None)
    P = kernels.ptr
    opt = lambda t: None if t is None else P(t)  # noqa: E731
    kernels.launch(
        "r3d_tsdf_fuse", dev,
        opt(old[0]) if old is not None else None, opt(old[1]) if old is not None else None,
        opt(old[2]) if old is not None and color is not None else None,
        P(depth), opt(color), P(extrinsic), P(origin), P(voxel_size), P(sdf_trunc),
        P(out_t), P(out_w), opt(out_c), R, H, W,
        0 if color is None else _COLOR_KIND[color.dtype], int(old is not None),
        float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy), float(depth_trunc),
        float(weight_max))
    fuse_voxels_cuda.launches += 1
    return out_t, out_w, out_c


fuse_voxels_cuda.launches = 0
