"""TSDF volume: truncated signed distance fusion of depth frames (twin of
recon3d_tpu/fusion/tsdf.py).

A dense static grid (256^3 x 5 float32 channels = 335 MB on the card)
updated voxel-centrically: every voxel projects into the incoming frame,
samples depth and color at its pixel (ops/project_sample.py) and folds
the truncated distance into a running weighted average. integrate() is
O(R^3) whatever the frame size. On the card one kernel does a voxel's whole
frame update in one pass (ops/tsdf_fuse_cuda.py): the fold for integrate(),
the contribution for _frame_contrib; CPU tensors take the plain version
below (`_frame_contrib_plain`, `_combine`), which it equals bitwise
(`_on_card` decides).

The arithmetic is the JAX program's, rounded as XLA rounds the jitted
integrate on the CPU: the voxel centers g * voxel_size + origin and the
camera transform as fused multiply-adds (`_voxel_centers`, `_cam_coords`),
uint8 color times the float32 reciprocal of 255, the running averages'
old * weight + new as fused multiply-adds, every other operation rounded on
its own. Divisions are by tensors, never by Python
scalars (PyTorch's CUDA division by a scalar multiplies by its reciprocal),
so the card computes the same bits as the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from recon3d_tpu_torch import kernels
from recon3d_tpu_torch.ops.image import fma
from recon3d_tpu_torch.ops.project_sample import sample_images_at
from recon3d_tpu_torch.utils.profiling import annotate
from recon3d_tpu_torch.utils.types import CameraIntrinsics, PointCloud


@dataclasses.dataclass(frozen=True)
class TSDFVolume:
    """Dense TSDF grid.

    tsdf:   (R, R, R) float32 in [-1, 1] (distance / sdf_trunc)
    weight: (R, R, R) float32 accumulated integration weights
    color:  (R, R, R, 3) float32 running color average, or None
    origin: (3,) float32 world position of voxel (0, 0, 0)'s center
    voxel_size, sdf_trunc: 0-d float32 tensors
    """

    tsdf: torch.Tensor
    weight: torch.Tensor
    origin: torch.Tensor
    voxel_size: torch.Tensor
    sdf_trunc: torch.Tensor
    color: Optional[torch.Tensor] = None

    @property
    def resolution(self) -> int:
        return self.tsdf.shape[0]


def make_volume(resolution: int = 256, voxel_size: float = 0.004, sdf_trunc: float = 0.02,
                origin=(-0.512, -0.512, 0.0), with_color: bool = True,
                device="cuda") -> TSDFVolume:
    """An empty volume (defaults: mini1.py:33-37, a ~1 m^3 working volume
    in front of the camera)."""
    R = resolution

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return TSDFVolume(
        tsdf=torch.zeros((R, R, R), dtype=torch.float32, device=device),
        weight=torch.zeros((R, R, R), dtype=torch.float32, device=device),
        color=torch.zeros((R, R, R, 3), dtype=torch.float32, device=device)
        if with_color else None,
        origin=f32(origin), voxel_size=f32(voxel_size), sdf_trunc=f32(sdf_trunc))


def _voxel_centers(vol: TSDFVolume) -> torch.Tensor:
    """(R, R, R, 3) world positions of the voxel centers, g * voxel_size +
    origin as one fused multiply-add (XLA contracts it in the jitted
    integrate)."""
    R = vol.resolution
    idx = torch.arange(R, dtype=torch.float32, device=vol.tsdf.device)
    g = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1)
    return fma(g, vol.voxel_size.expand_as(g), vol.origin.expand_as(g))


def _cam_coords(pts: torch.Tensor, extrinsic: torch.Tensor):
    """(x, y, z) of pts @ extrinsic[:3, :3].T + extrinsic[:3, 3], the product
    rounded as XLA's CPU dot (Eigen) rounds it in the jitted integrate: each
    output column as the fused multiply-add chain fma(p2, m2, fma(p1, m1,
    p0 m0)); then the translation added."""
    M = extrinsic[:3, :3]
    out = []
    for j in range(3):
        m = [M[j, k].expand(pts.shape[:-1]) for k in range(3)]
        prod = fma(pts[..., 2], m[2], fma(pts[..., 1], m[1], pts[..., 0] * M[j, 0]))
        out.append(prod + extrinsic[j, 3])
    return out


def _pixel_indices(vol: TSDFVolume, H: int, W: int, intr: CameraIntrinsics,
                   extrinsic: torch.Tensor):
    """Each voxel's camera depth z, in-image mask and clipped pixel (vc, uc)
    (R, R, R) int32 in an (H, W) frame seen from `extrinsic`."""
    return _project(_voxel_centers(vol), H, W, intr, extrinsic)


def _project(pts: torch.Tensor, H: int, W: int, intr: CameraIntrinsics,
             extrinsic: torch.Tensor):
    """(z, in-image mask, vc, uc) of world points (..., 3) in an (H, W)
    frame seen from `extrinsic`, rounded as the jitted JAX integrate."""
    x, y, z = _cam_coords(pts, extrinsic)
    zc = torch.clamp(z, min=1e-9)
    u = intr.fx * x / zc + intr.cx
    v = intr.fy * y / zc + intr.cy
    del x, y, zc
    # round half to even as jnp.round; XLA's float -> int32 conversion
    # saturates, so clamp before the cast (voxels near z = 0 give |u| >> 2^31).
    # [-1, W] keeps every in-bounds test and clip of the saturated value.
    ui = torch.clamp(torch.round(u), -1, W).to(torch.int32)
    vi = torch.clamp(torch.round(v), -1, H).to(torch.int32)
    del u, v
    inb = (z > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    return z, inb, torch.clamp(vi, 0, H - 1), torch.clamp(ui, 0, W - 1)


def _image_stack(depth: torch.Tensor, color: Optional[torch.Tensor]) -> torch.Tensor:
    """(C, H, W) float32 stack of depth and, where given, the color channels
    (uint8 color times the float32 reciprocal of 255, as XLA turns the
    division by the constant)."""
    imgs = depth.to(torch.float32)[None]
    if color is not None:
        c = color
        if c.dtype == torch.uint8:
            c = c.to(torch.float32) * (1.0 / torch.tensor(255.0, dtype=torch.float32,
                                                          device=c.device))
        imgs = torch.cat([imgs, c.to(torch.float32).permute(2, 0, 1)], 0)
    return imgs.contiguous()


def _on_card(vol: TSDFVolume, depth: torch.Tensor, color: Optional[torch.Tensor]) -> bool:
    """True where the frame goes to the kernel (CUDA tensors), False for the
    plain version (CPU tensors); raises for mixed devices."""
    return kernels.use_kernel(vol.tsdf, depth, *(() if color is None else (color,)))


def _fuse_voxels(vol: TSDFVolume, depth: torch.Tensor, intr: CameraIntrinsics,
                 extrinsic: torch.Tensor, color: Optional[torch.Tensor], depth_trunc: float,
                 fold: bool, weight_max: float = 64.0):
    """The kernel's launch in the span `tsdf.voxels`: the inputs in the forms
    it takes (depth float32, color uint8 or float32, all contiguous)."""
    from recon3d_tpu_torch.ops.tsdf_fuse_cuda import fuse_voxels_cuda

    if color is not None:
        color = (color if color.dtype == torch.uint8 else color.to(torch.float32)).contiguous()
    old = (vol.tsdf, vol.weight, vol.color if color is not None else None) if fold else None
    with annotate("tsdf.voxels"):
        return fuse_voxels_cuda(vol.origin, vol.voxel_size, vol.sdf_trunc, vol.resolution,
                                depth.to(torch.float32).contiguous(), color,
                                extrinsic.contiguous(), intr, depth_trunc, old, weight_max)


def _frame_contrib(vol: TSDFVolume, depth: torch.Tensor, intr: CameraIntrinsics,
                   extrinsic: torch.Tensor, color: Optional[torch.Tensor] = None,
                   depth_trunc: float = 3.0):
    """One frame's TSDF contribution in weighted-sum form: (w * tsdf_new,
    w_new, w * color_sample) with w_new in {0, 1}, the summand that
    sequential integrates telescope to (integrate_frames sums them). The
    kernel's contribution mode on the card, `_frame_contrib_plain` on the
    CPU."""
    extrinsic = torch.as_tensor(extrinsic, dtype=torch.float32, device=vol.tsdf.device)
    if _on_card(vol, depth, color):
        return _fuse_voxels(vol, depth, intr, extrinsic, color, depth_trunc, fold=False)
    return _frame_contrib_plain(vol, depth, intr, extrinsic, color, depth_trunc)


def _frame_contrib_plain(vol: TSDFVolume, depth: torch.Tensor, intr: CameraIntrinsics,
                         extrinsic: torch.Tensor, color: Optional[torch.Tensor] = None,
                         depth_trunc: float = 3.0):
    """_frame_contrib's plain version: the projection, K9's sample and the
    truncation as PyTorch operations (float32 extrinsic on vol's device)."""
    H, W = depth.shape
    with annotate("tsdf.project"):
        z, inb, vc, uc = _pixel_indices(vol, H, W, intr, extrinsic)
    # depth and color at every voxel's pixel: K9 on the card, one launch
    with annotate("tsdf.sample"):
        samp = sample_images_at(vc, uc, _image_stack(depth, color))
    d = samp[0]
    valid_d = (d > 1e-4) & (d < depth_trunc) & inb

    sdf = d - z
    tsdf_new = torch.clamp(sdf / vol.sdf_trunc, -1.0, 1.0)
    # integrate only within the truncation band in front of the surface
    upd = valid_d & (sdf > -vol.sdf_trunc)
    w_new = upd.to(torch.float32)
    cf = None
    if color is not None:
        cf = torch.where(upd[..., None], samp[1:].permute(1, 2, 3, 0), 0.0).contiguous()
    return torch.where(upd, tsdf_new, 0.0), w_new, cf


def _combine(vol: TSDFVolume, n, w_new, cf, weight_max: float):
    """(tsdf, weight, color) after adding the summed contributions."""
    upd = w_new > 0.0
    w_old = vol.weight
    w_sum = w_old + w_new
    den = torch.clamp(w_sum, min=1.0)
    # tsdf * w_old + n as XLA contracts it: one fused multiply-add
    tsdf = torch.where(upd, fma(vol.tsdf, w_old, n) / den, vol.tsdf)
    w_tot = torch.clamp(w_sum, max=weight_max)
    color = vol.color
    if cf is not None:
        w3 = w_old[..., None].expand_as(cf)
        color = torch.where(upd[..., None], fma(vol.color, w3, cf) / den[..., None], vol.color)
    return tsdf, w_tot, color


def _fold(vol: TSDFVolume, depth: torch.Tensor, intr: CameraIntrinsics,
          extrinsic: torch.Tensor, color: Optional[torch.Tensor], depth_trunc: float,
          weight_max: float):
    """(tsdf, weight, color) of `vol` after one frame: the kernel's fold on
    the card; on the CPU the plain contribution, then _combine."""
    if not _on_card(vol, depth, color):
        n1, w_new, cf = _frame_contrib_plain(vol, depth, intr, extrinsic, color, depth_trunc)
        return _combine(vol, n1, w_new, cf, weight_max)
    tsdf, w_tot, cnew = _fuse_voxels(vol, depth, intr, extrinsic, color, depth_trunc,
                                     fold=True, weight_max=weight_max)
    return tsdf, w_tot, vol.color if cnew is None else cnew


def _check_extrinsic(extrinsic, dev) -> torch.Tensor:
    e = torch.as_tensor(extrinsic, dtype=torch.float32, device=dev)
    if e.shape != (4, 4):
        raise ValueError(f"extrinsic must be 4x4, got {tuple(e.shape)}")
    return e


def integrate(vol: TSDFVolume, depth: torch.Tensor, intr: CameraIntrinsics, extrinsic,
              color: Optional[torch.Tensor] = None, depth_trunc: float = 3.0,
              weight_max: float = 64.0, with_changed_z: bool = False,
              changed_weight_min: float = 1.0):
    """Fuse one depth (+ color) frame; returns a new volume.

    extrinsic: (4, 4) camera_from_world (Open3D convention). weight_max caps
    the accumulated weights so long streams keep a moving average.
    with_changed_z=True also returns the (R,) bool z-profile of mesh-relevant
    change: tsdf or color changed bitwise, or the weight crossed
    changed_weight_min.
    """
    with annotate("tsdf.integrate"):
        e = _check_extrinsic(extrinsic, vol.tsdf.device)
        use_color = color if vol.color is not None else None
        tsdf, w_tot, cnew = _fold(vol, depth, intr, e, use_color, depth_trunc, weight_max)
        out = dataclasses.replace(vol, tsdf=tsdf, weight=w_tot, color=cnew)
        if with_changed_z:
            # a fill on the device, not a blocking copy from the host
            wm = torch.full((), changed_weight_min, dtype=torch.float32, device=tsdf.device)
            changed = (tsdf != vol.tsdf) | ((w_tot >= wm) != (vol.weight >= wm))
            if vol.color is not None and color is not None:
                # color-only updates leave tsdf bitwise but stale vertex colors
                changed = changed | (cnew != vol.color).any(-1)
            return out, changed.any(1).any(0)
        return out


def integrate_donated(vol: TSDFVolume, depth: torch.Tensor, intr: CameraIntrinsics, extrinsic,
                      color: Optional[torch.Tensor] = None, depth_trunc: float = 3.0,
                      weight_max: float = 64.0, with_changed_z: bool = False,
                      changed_weight_min: float = 1.0):
    """integrate() writing into the caller's buffers, as the JAX package's
    donating twin reuses them: `vol`'s tensors hold the new volume
    afterwards, and the returned volume shares them."""
    res = integrate(vol, depth, intr, extrinsic, color, depth_trunc, weight_max,
                    with_changed_z, changed_weight_min)
    out = res[0] if with_changed_z else res
    vol.tsdf.copy_(out.tsdf)
    vol.weight.copy_(out.weight)
    if vol.color is not None:
        vol.color.copy_(out.color)
    return (vol, res[1]) if with_changed_z else vol


def integrate_frames(vol: TSDFVolume, depths: torch.Tensor, intr: CameraIntrinsics,
                     extrinsics, colors: Optional[torch.Tensor] = None,
                     depth_trunc: float = 3.0, weight_max: float = 64.0) -> TSDFVolume:
    """Integrate a batch of B frames in one order-independent step: the B
    contributions summed in frame order, then combined once (the cap applies
    at combine time). Writes into `vol`'s buffers, as the JAX package
    donates them, and returns a volume sharing them.

    Each frame's camera transform rounds as integrate's does. XLA multiplies
    the voxel centers by all B rotations in one (3, 3B) product, and at
    B = 2 (of the sizes 1-5 checked) its Eigen kernel sums frame 0's z
    column sequentially, so there the JAX package's tsdf can differ from
    this one in the last bits.
    """
    dev = vol.tsdf.device
    ext = torch.as_tensor(extrinsics, dtype=torch.float32, device=dev)
    with_c = vol.color is not None and colors is not None
    n_sum = torch.zeros_like(vol.tsdf)
    w_sum = torch.zeros_like(vol.weight)
    c_sum = torch.zeros_like(vol.color) if with_c else None
    for b in range(depths.shape[0]):
        n, w, c = _frame_contrib(vol, depths[b], intr, _check_extrinsic(ext[b], dev),
                                 colors[b] if with_c else None, depth_trunc)
        n_sum = n_sum + n
        w_sum = w_sum + w
        if with_c:
            c_sum = c_sum + c
    tsdf, w_tot, cnew = _combine(vol, n_sum, w_sum, c_sum, weight_max)
    vol.tsdf.copy_(tsdf)
    vol.weight.copy_(w_tot)
    if with_c:
        vol.color.copy_(cnew)
    return vol


def extract_point_cloud(vol: TSDFVolume, capacity: int = 1 << 18,
                        weight_min: float = 1.0) -> PointCloud:
    """Surface points: voxels where the TSDF crosses zero along +x / +y / +z,
    linearly interpolated to the crossing, packed into a fixed-capacity
    masked PointCloud (the valid ones first in (axis, voxel) order, then the
    others in order, as the JAX package's stable argsort packs them)."""
    t, w = vol.tsdf, vol.weight
    R = vol.resolution
    dev = t.device
    cross = []
    for axis in range(3):
        ta = torch.roll(t, -1, dims=axis)
        wa = torch.roll(w, -1, dims=axis)
        c = (t * ta < 0.0) & (w >= weight_min) & (wa >= weight_min)
        c.select(axis, R - 1).fill_(False)  # kill the wrap-around
        cross.append(c.reshape(-1))
    valid = torch.cat(cross)
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices[:capacity]
    n_valid = valid.sum()

    # the crossing points of the chosen (axis, voxel) entries only
    R3 = R ** 3
    axis = order // R3
    j = order % R3
    xyz = torch.stack([j // (R * R), (j // R) % R, j % R], -1)
    nb = xyz.clone()
    nb[torch.arange(len(order), device=dev), axis] += 1
    nb = nb % R
    tv = t.reshape(-1)[j]
    ta = t[nb[:, 0], nb[:, 1], nb[:, 2]]
    diff = tv - ta
    alpha = torch.clamp(tv / torch.where(diff.abs() < 1e-9, 1e-9, diff), 0.0, 1.0)
    offs = torch.nn.functional.one_hot(axis, 3).to(torch.float32)
    q = xyz.to(torch.float32) + alpha[:, None] * offs
    p = fma(q, vol.voxel_size.expand_as(q), vol.origin.expand_as(q))  # contracted by XLA
    cols = None if vol.color is None else vol.color.reshape(-1, 3)[j]
    return PointCloud(points=p, colors=cols,
                      valid=torch.arange(len(order), device=dev) < torch.clamp(n_valid,
                                                                               max=capacity))


def save_volume(path: str, vol: TSDFVolume) -> str:
    """Checkpoint a TSDF volume to one compressed NPZ (the JAX package's
    keys, so either package loads the other's checkpoints)."""
    d = {"tsdf": vol.tsdf.cpu().numpy(), "weight": vol.weight.cpu().numpy(),
         "origin": vol.origin.cpu().numpy(), "voxel_size": vol.voxel_size.cpu().numpy(),
         "sdf_trunc": vol.sdf_trunc.cpu().numpy()}
    if vol.color is not None:
        d["color"] = vol.color.cpu().numpy()
    np.savez_compressed(path, **d)
    return path


def load_volume(path: str, device="cuda") -> TSDFVolume:
    """Load a save_volume checkpoint onto `device`."""
    with np.load(path) as d:
        def put(k):
            return torch.as_tensor(np.array(d[k], np.float32), device=device)

        return TSDFVolume(tsdf=put("tsdf"), weight=put("weight"),
                          color=put("color") if "color" in d else None, origin=put("origin"),
                          voxel_size=put("voxel_size"), sdf_trunc=put("sdf_trunc"))
