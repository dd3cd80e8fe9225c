"""Device-side 3-D rendering: point splatting with a z-buffer (twin of
recon3d_tpu/pipeline/render.py).

The reference's live view is an Open3D / OpenGL window (visualizer.py:14-38).
Here the live window renders its own frames: the cloud or mesh is projected
and z-buffered on the device (a scatter-min depth resolve) and the RGB frame
is shown by pipeline/live.py's and pipeline/visualizer.py's windows.
Orbit-camera math stays on the host.

Which point colors a pixel: every splat of a point within (1 + 1e-6) of the
pixel's nearest z wins it, and the JAX package writes the winners' colors
with one scatter a splat offset, whose CPU implementation applies the
updates in order: the last winner in (offset, point index) order keeps the
pixel. The port picks the same writer with an order-free reduction (the
largest winning update index, `scatter_reduce` "amax") and one gather, so
the card and the host give the same image as the JAX package on the CPU,
ties and near ties included.
"""
from __future__ import annotations

import numpy as np
import torch

from recon3d_tpu_torch.fusion.tsdf import _cam_coords

_FAR = 1e30


def render_points(
    points: torch.Tensor,
    colors: torch.Tensor,
    valid: torch.Tensor,
    view,
    focal: float,
    height: int = 720,
    width: int = 960,
    splat: int = 2,
    background: float = 0.08,
) -> torch.Tensor:
    """Project + z-buffer splat a masked cloud. Returns (H, W, 3) float32 RGB
    on the points' device.

    view: (4, 4) camera_from_world. splat: points cover splat x splat
    pixels (2 keeps moderate clouds watertight on screen).
    """
    H, W = height, width
    p = torch.as_tensor(points, dtype=torch.float32)
    dev = p.device
    N = p.shape[0]
    view = torch.as_tensor(view, dtype=torch.float32).to(dev)
    x, y, z = _cam_coords(p, view)
    ok = torch.as_tensor(valid, dtype=torch.bool).to(dev) & (z > 1e-3)
    zc = torch.clamp(z, min=1e-3)
    f = torch.full((), focal, dtype=torch.float32, device=dev)
    u = f * x / zc + (W - 1) / 2.0
    v = f * y / zc + (H - 1) / 2.0
    # XLA's float -> int32 conversion saturates: clamp first, to values that
    # stay out of the image after any splat offset
    ui = torch.clamp(torch.floor(u), -splat - 1, W).to(torch.int64)
    vi = torch.clamp(torch.floor(v), -splat - 1, H).to(torch.int64)

    col = torch.as_tensor(colors, dtype=torch.float32).to(dev)
    if col.ndim == 1:
        col = col[:, None].expand(N, 3)

    offsets = [(du, dv) for du in range(splat) for dv in range(splat)]
    pixels = []
    for du, dv in offsets:
        uu, vv = ui + du, vi + dv
        inb = ok & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
        pixels.append((inb, torch.where(inb, vv * W + uu, H * W)))
    zbuf = torch.full((H * W + 1,), _FAR, dtype=torch.float32, device=dev)
    far = torch.full_like(z, _FAR)
    for inb, pix in pixels:
        zbuf.scatter_reduce_(0, pix, torch.where(inb, z, far), "amin")
    # the pixel's writer: the last winning update in (offset, point) order
    writer = torch.full((H * W + 1,), -1, dtype=torch.int64, device=dev)
    order = torch.arange(N, dtype=torch.int64, device=dev)
    for o, (inb, pix) in enumerate(pixels):
        won = inb & (z <= zbuf[pix] * (1.0 + 1e-6))
        writer.scatter_reduce_(0, torch.where(won, pix, H * W),
                               torch.where(won, o * N + order, -1), "amax")
    writer = writer[:-1]
    bg = torch.full((H * W, 3), background, dtype=torch.float32, device=dev)
    if N == 0:
        return bg.reshape(H, W, 3)
    img = torch.where((writer >= 0)[:, None], col[torch.clamp(writer, min=0) % N], bg)
    return img.reshape(H, W, 3)


def orbit_view(target, distance: float, azim_deg: float, elev_deg: float) -> np.ndarray:
    """(4, 4) camera_from_world orbiting `target`: the host-side stand-in for
    Open3D's view-control trackball."""
    az = np.deg2rad(azim_deg)
    el = np.deg2rad(elev_deg)
    t = np.asarray(target, np.float64)
    # camera position on the orbit sphere
    eye = t + distance * np.array([np.cos(el) * np.sin(az), np.sin(el),
                                   -np.cos(el) * np.cos(az)])
    fwd = t - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])  # y-down camera convention
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    if nr < 1e-9:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= nr
    dn = np.cross(fwd, right)
    R = np.stack([right, dn, fwd])  # world -> camera rows
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye
    return T
