"""Normal estimation: neighborhood PCA + orientation (twin of
recon3d_tpu/pointcloud/normals.py).

Replaces o3d estimate_normals (CUDA k-NN PCA, normal_estimation.py:19-20)
and the two orientation modes the reference uses. Up to 32768 points the
neighborhoods come from the exact brute-force k-NN (ops/knn.py) and the
covariance's smallest eigenvector from the closed trigonometric form; above
that, from the voxel-grid moments path: K7 packs the cell table and K8
accumulates the radius-ball moments of the 27 neighboring cells and solves
the eigenvector in the same kernel (ops/grid_knn_cuda.py), as the JAX
package runs its fused Pallas kernel on a TPU. CPU tensors take the
kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from recon3d_tpu_torch.ops import grid_knn_cuda as _gkc
from recon3d_tpu_torch.ops import knn as _knn
from recon3d_tpu_torch.utils.types import PointCloud

GRID_SWITCH = 32768  # above this many points: the grid moments path


def _smallest_eigvec_3x3(C: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric (..., 3, 3):
    trigonometric eigenvalues, then the null direction as the largest cross
    product of rows of (C - lam I); +z for isotropic neighborhoods."""
    C = C.to(torch.float32)
    q = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) / 3.0
    I = torch.eye(3, dtype=C.dtype, device=C.device)
    B = C - q[..., None, None] * I
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = torch.linalg.det(B)
    r = torch.clamp(detB / (2.0 * p ** 3 + 1e-30), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    A = C - lam_min[..., None, None] * I
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    best = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                        torch.linalg.cross(r1, r2)], -2)
    which = torch.argmax((best * best).sum(-1), dim=-1)
    v = torch.gather(best, -2, which[..., None, None].expand(*which.shape, 1, 3))[..., 0, :]
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=C.dtype, device=C.device).expand_as(v)
    return torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-12), fallback)


def _eig6_channels(xx, yy, zz, xy, xz, yz):
    """Channelwise smallest-eigenvector solve on 6 covariance components of
    any (matching) shape: (vx, vy, vz) unit components, (0, 0, 1) when
    degenerate. Safeguarded Newton on the normalized characteristic cubic
    mu^3 - 3 mu - d = 0 from mu = -2 (12 steps, every clamp of the JAX
    package's), then the largest cross product of rows of (C - lam I).
    K8's fused finish runs this arithmetic op for op (csrc/grid_moments.cu)."""
    # divisors as 0-d tensors: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds otherwise than K8's divide
    three, six = (torch.full((), v, dtype=xx.dtype, device=xx.device) for v in (3.0, 6.0))
    q = (xx + yy + zz) / three
    bxx, byy, bzz = xx - q, yy - q, zz - q
    p2 = (bxx * bxx + byy * byy + bzz * bzz + 2.0 * (xy * xy + xz * xz + yz * yz)) / six
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = (bxx * (byy * bzz - yz * yz)
            - xy * (xy * bzz - yz * xz)
            + xz * (xy * yz - byy * xz))
    d = torch.clamp(detB / torch.clamp(p * p * p, min=1e-30), -2.0, 2.0)
    mu = torch.full_like(d, -2.0)
    for _ in range(12):
        f = mu * (mu * mu - 3.0) - d
        fp = 3.0 * (mu * mu - 1.0)
        mu = torch.clamp(mu - f / torch.clamp(fp, min=1e-12), -2.0, -1.0)
    lam = q + p * mu

    axx, ayy, azz = xx - lam, yy - lam, zz - lam
    # rows of (C - lam I): r0=(axx,xy,xz) r1=(xy,ayy,yz) r2=(xz,yz,azz)
    c01 = (xy * yz - xz * ayy, xz * xy - axx * yz, axx * ayy - xy * xy)
    c02 = (xy * azz - xz * yz, xz * xz - axx * azz, axx * yz - xy * xz)
    c12 = (ayy * azz - yz * yz, yz * xz - xy * azz, xy * yz - ayy * xz)
    n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
    n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
    n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
    use02 = n02 > n01
    use12 = n12 > torch.maximum(n01, n02)
    vx, vy, vz = (torch.where(use12, c12[i], torch.where(use02, c02[i], c01[i]))
                  for i in range(3))
    norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
    ok = norm > 1e-12
    inv = 1.0 / torch.clamp(norm, min=1e-12)
    return (torch.where(ok, vx * inv, 0.0), torch.where(ok, vy * inv, 0.0),
            torch.where(ok, vz * inv, 1.0))


def _smallest_eigvec_cov6(cov6: torch.Tensor) -> torch.Tensor:
    """_eig6_channels on (N, 6) covariances [xx, yy, zz, xy, xz, yz]."""
    return torch.stack(_eig6_channels(*cov6.unbind(1)), -1)


def _grid_normals(points, valid, radius, grid_size, cell_capacity):
    """Large-N normals: the packed cell table (K7) straight into the fused
    moments + eigen-solve (K8), then the 3 normal channels gathered back
    per point (the counterpart of the JAX `_grid_normals_pallas`)."""
    p = points.to(torch.float32)
    G, C = grid_size, cell_capacity
    pk, point_slot, _ = _gkc.bin_points_packed_cuda(p, valid, radius, G, C)
    r = torch.tensor(radius, dtype=torch.float32)
    out = _gkc.normals_core(pk, float(r * r), G, C)
    chan, has = _gkc.packed_chan_readback(out, point_slot)
    v = torch.stack([chan(0), chan(1), chan(2)], -1)
    fallback = torch.tensor([0.0, 0.0, 1.0], device=p.device)
    return torch.where(has[:, None], v, fallback)


def _normals_only(points, valid, radius, max_nn, grid_size, cell_capacity):
    """The (N, 3) normals of estimate_normals."""
    if points.shape[0] > GRID_SWITCH:
        return _grid_normals(points, valid, radius, grid_size, cell_capacity)
    idx, _, ok = _knn.hybrid_knn(points, valid, radius, max_nn=max_nn)
    nbrs = points[idx.long()]  # (N, K, 3)
    w = ok.to(torch.float32)[..., None]
    cnt = torch.clamp(w.sum(dim=1), min=1.0)
    mean = (nbrs * w).sum(dim=1) / cnt
    d = (nbrs - mean[:, None, :]) * w
    C = torch.einsum("nki,nkj->nij", d, d) / cnt[..., None]
    return _smallest_eigvec_3x3(C)


def estimate_normals(pc: PointCloud, radius: float = 0.05, max_nn: int = 50,
                     grid_size: int = 128, cell_capacity: int = 8) -> PointCloud:
    """Hybrid-search PCA normals (normal_estimation.py:20 semantics:
    max_nn=50, radius=0.05). Above 32768 points the voxel-binned moments
    path (exact for neighbors within `radius`, which is all the hybrid
    search keeps); the grid covers grid_size * radius per axis from the
    cloud's min corner."""
    normals = _normals_only(pc.points, pc.valid, radius, max_nn, grid_size, cell_capacity)
    return dataclasses.replace(pc, normals=normals)


def orient_normals_towards_camera(pc: PointCloud, camera_location=None) -> PointCloud:
    """Flip normals to face the camera (o3d orient_normals_towards_camera_location)."""
    cam = torch.zeros(3, device=pc.points.device) if camera_location is None else \
        torch.as_tensor(camera_location, dtype=torch.float32, device=pc.points.device)
    flip = (pc.normals * (cam[None, :] - pc.points)).sum(dim=1) < 0
    return dataclasses.replace(pc, normals=torch.where(flip[:, None], -pc.normals, pc.normals))


def orient_normals_consistent(pc: PointCloud, k: int = 10, iterations: int = 30) -> PointCloud:
    """Consistent tangent-plane orientation (normal_estimation.py:21) by
    synchronous majority propagation over the k-NN graph: from the point of
    largest z oriented +z, each sweep gives every point the sign of the
    weighted vote of its already-confident neighbors."""
    idx, d2 = _knn.knn(pc.points, pc.valid, k=k)
    idx = idx.long()
    w = torch.exp(-d2 / torch.clamp(torch.where(d2 < 1e29, d2, 0.0).mean(), min=1e-12))
    seed = torch.argmax(torch.where(pc.valid, pc.points[:, 2], -math.inf))
    n0 = pc.normals
    sign = torch.ones(pc.capacity, dtype=torch.float32, device=n0.device)
    seed_sign = torch.where(n0[seed, 2] < 0, -1.0, 1.0)
    sign[seed] = seed_sign
    conf = torch.zeros_like(sign)
    conf[seed] = 1.0
    dots = torch.einsum("ni,nki->nk", n0, n0[idx])  # alignment with neighbors
    sdots = w * torch.sign(dots)
    for _ in range(iterations):
        vote = (sdots * conf[idx] * sign[idx]).sum(dim=1)
        has_vote = vote.abs() > 1e-12
        sign = torch.where(has_vote, torch.sign(vote), sign)
        conf = torch.maximum(conf, has_vote.to(torch.float32))
        sign[seed] = seed_sign  # the seed stays pinned
        conf[seed] = 1.0
    return dataclasses.replace(pc, normals=pc.normals * sign[:, None])
