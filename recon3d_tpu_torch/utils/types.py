"""Geometry containers (twin of recon3d_tpu/utils/types.py: `PointCloud`,
`compact`, `concatenate`, `transform`, `RGBDImage`, `TriangleMesh`,
`CameraIntrinsics`).

Like the JAX package, a cloud is a fixed-capacity buffer plus a validity
mask: ops that shrink data clear mask bits, and `compact` re-packs the valid
rows to the front when a smaller buffer is wanted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from recon3d_tpu_torch.ops.image import matmul3


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-capacity point cloud with a validity mask.

    points: (N, 3) float32 (invalid rows hold arbitrary data); colors:
    (N, 3) float32 in [0, 1] or None; normals: (N, 3) float32 or None;
    valid: (N,) bool.
    """

    points: torch.Tensor
    valid: torch.Tensor
    colors: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        """Number of valid points (a 0-d tensor on the cloud's device)."""
        return self.valid.sum()

    @staticmethod
    def from_numpy(points: np.ndarray, colors: Optional[np.ndarray] = None,
                   normals: Optional[np.ndarray] = None, capacity: Optional[int] = None,
                   device="cuda") -> "PointCloud":
        """Build from host arrays, padding with zeros up to `capacity`."""
        n = points.shape[0]
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < number of points {n}")

        def pad(a):
            if a is None:
                return None
            out = np.zeros((cap, 3), np.float32)
            out[:n] = a
            return torch.as_tensor(out, device=device)

        valid = np.zeros((cap,), bool)
        valid[:n] = True
        return PointCloud(points=pad(points), colors=pad(colors), normals=pad(normals),
                          valid=torch.as_tensor(valid, device=device))

    def to_numpy(self):
        """(points, colors, normals) host arrays of the valid rows only."""
        valid = self.valid.cpu().numpy()

        def host(a):
            return None if a is None else a.cpu().numpy()[valid]

        return host(self.points), host(self.colors), host(self.normals)

    def masked_points(self, fill: float = float("inf")) -> torch.Tensor:
        """Points with invalid rows replaced by `fill`."""
        return torch.where(self.valid[:, None], self.points, fill)


def compact(pc: PointCloud, capacity: int) -> PointCloud:
    """Pack valid points to the front and truncate / pad to `capacity`.

    Stable: valid rows keep their relative order (a stable sort of the
    inverted mask, as the JAX package's argsort); padding rows repeat row 0
    and are invalid.
    """
    order = torch.sort((~pc.valid).to(torch.uint8), stable=True).indices
    if capacity <= pc.capacity:
        idx = order[:capacity]
    else:
        idx = torch.cat([order, order.new_zeros(capacity - pc.capacity)])
    n_valid = pc.valid.sum()
    new_valid = torch.arange(capacity, device=pc.valid.device) < torch.clamp(n_valid,
                                                                             max=capacity)

    def take(a):
        return None if a is None else a[idx]

    return PointCloud(points=take(pc.points), colors=take(pc.colors),
                      normals=take(pc.normals), valid=new_valid)


def concatenate(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds (capacity = sum of capacities)."""

    def cat(x, y, name):
        if (x is None) != (y is None):
            raise ValueError(f"one cloud has {name}, the other does not")
        return None if x is None else torch.cat([x, y], 0)

    return PointCloud(points=torch.cat([a.points, b.points], 0),
                      colors=cat(a.colors, b.colors, "colors"),
                      normals=cat(a.normals, b.normals, "normals"),
                      valid=torch.cat([a.valid, b.valid], 0))


def transform(pc: PointCloud, T) -> PointCloud:
    """Apply a 4x4 rigid transform (reference: pointcloud_alignment.py:44),
    the rotation as the JAX package's product rounds it (`matmul3`)."""
    T = torch.as_tensor(T, dtype=torch.float32, device=pc.points.device)
    R, t = T[:3, :3], T[:3, 3]
    pts = matmul3(pc.points, R) + t
    normals = None if pc.normals is None else matmul3(pc.normals, R)
    return dataclasses.replace(pc, points=pts, normals=normals)


@dataclasses.dataclass(frozen=True)
class RGBDImage:
    """An aligned color + depth frame: color (H, W, 3) float32 in [0, 1],
    depth (H, W) float32 metric depth in meters (0 or non-finite = invalid)."""

    color: torch.Tensor
    depth: torch.Tensor

    @property
    def shape(self):
        return tuple(self.depth.shape)


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """Fixed-capacity triangle mesh with validity masks.

    vertices (V, 3) float32; triangles (F, 3) int32 vertex indices;
    vertex_valid (V,) bool; triangle_valid (F,) bool; vertex_colors and
    vertex_normals (V, 3) float32 or None.
    """

    vertices: torch.Tensor
    triangles: torch.Tensor
    vertex_valid: torch.Tensor
    triangle_valid: torch.Tensor
    vertex_colors: Optional[torch.Tensor] = None
    vertex_normals: Optional[torch.Tensor] = None

    def to_numpy(self):
        """(vertices, triangles, colors, normals) host arrays of the valid
        vertices, the valid triangles re-indexed to them (triangles that
        reference an invalid vertex are dropped)."""
        vv = self.vertex_valid.cpu().numpy()
        tv = self.triangle_valid.cpu().numpy()
        verts = self.vertices.cpu().numpy()
        tris = self.triangles.cpu().numpy()
        remap = -np.ones(len(verts), np.int64)
        remap[vv] = np.arange(vv.sum())
        out_tris = remap[tris[tv]]
        out_tris = out_tris[(out_tris >= 0).all(axis=1)]
        cols = None if self.vertex_colors is None else self.vertex_colors.cpu().numpy()[vv]
        nrm = None if self.vertex_normals is None else self.vertex_normals.cpu().numpy()[vv]
        return verts[vv], out_tris.astype(np.int32), cols, nrm


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics (fx, fy, cx, cy) as Python floats."""

    fx: float
    fy: float
    cx: float
    cy: float

    def matrix(self, device="cuda") -> torch.Tensor:
        """The (3, 3) float32 pinhole matrix K on `device`."""
        K = np.zeros((3, 3), np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[2, 2] = self.fx, self.fy, self.cx, self.cy, 1.0
        return torch.as_tensor(K, device=device)

    @staticmethod
    def from_matrix(K) -> "CameraIntrinsics":
        K = torch.as_tensor(K, dtype=torch.float32).cpu()
        return CameraIntrinsics(fx=float(K[0, 0]), fy=float(K[1, 1]),
                                cx=float(K[0, 2]), cy=float(K[1, 2]))

    @staticmethod
    def from_json(path: str) -> "CameraIntrinsics":
        """Read fx, fy and the principal point (RealSense's ppx / ppy, else
        cx / cy) from a JSON file (camera_intrinsic.json), each rounded to
        float32 as the JAX package holds them."""
        import json

        with open(path) as f:
            d = json.load(f)
        cx = d["ppx"] if "ppx" in d else d["cx"]
        cy = d["ppy"] if "ppy" in d else d["cy"]
        return CameraIntrinsics(*(float(np.float32(v)) for v in (d["fx"], d["fy"], cx, cy)))
