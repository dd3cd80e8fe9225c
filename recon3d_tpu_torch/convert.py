"""Carry the JAX package's state for the ported paths across to the port.

The paths have no learned weights. Their state is the matcher, WLS,
point-cloud processing, fusion and meshing configuration (passed as
``dataclasses.asdict`` dicts of the JAX package's configs), the 4x4
reprojection matrix Q, optionally the pinhole intrinsics as a 3x3 K, the
stereo calibration (`stereo_params`), the two-pass warp plans
(`remap_plan`), point clouds (`point_cloud`; with a leading batch axis,
`point_clouds`), TSDF volumes (`tsdf_volume`), scalable TSDF volumes
(`scalable_volume`; back to the JAX one's fields: `scalable_volume_arrays`),
triangle meshes
(`triangle_mesh`; Poisson's with its densities, `poisson_mesh`), RGB-D
frames (`rgbd_image`), pinhole intrinsics (`camera_intrinsics`), pose graphs
(`pose_graph`), registration results (`registration_result`), the scanners'
nested configuration (`scanner_config`) and the calibration stages' results
(`calibration_result`, `stereo_calibration_result`, `rectify_result`); all
arrive as plain Python / numpy. The JAX backends map onto the port's: 'pallas' ->
'cuda', 'xla' -> 'torch'.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from recon3d_tpu_torch.calib.mono import CalibrationResult
from recon3d_tpu_torch.calib.npz import StereoParams
from recon3d_tpu_torch.calib.stereo import RectifyResult, StereoCalibrationResult
from recon3d_tpu_torch.config import (FusionConfig, MeshConfig, ProcessingConfig,
                                      RegistrationConfig, ScannerConfig, StereoMatcherConfig,
                                      StreamConfig, WLSConfig)
from recon3d_tpu_torch.fusion.scalable import ScalableTSDFVolume
from recon3d_tpu_torch.fusion.tsdf import TSDFVolume
from recon3d_tpu_torch.ops.warp import RemapPlan
from recon3d_tpu_torch.registration.icp import RegistrationResult
from recon3d_tpu_torch.registration.posegraph import PoseGraph
from recon3d_tpu_torch.utils.types import CameraIntrinsics, PointCloud, RGBDImage, TriangleMesh

_BACKENDS = {"auto": "auto", "pallas": "cuda", "xla": "torch"}


@dataclasses.dataclass(frozen=True)
class SliceState:
    matcher: StereoMatcherConfig
    wls: WLSConfig
    Q: torch.Tensor  # (4, 4) float32 on the target device
    intrinsics: Optional[CameraIntrinsics] = None


def matcher_config(fields: dict) -> StereoMatcherConfig:
    fields = dict(fields)
    backend = fields.get("backend", "auto")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown JAX backend {backend!r}")
    fields["backend"] = _BACKENDS[backend]
    return StereoMatcherConfig(**fields)


def wls_config(fields: dict) -> WLSConfig:
    return WLSConfig(**fields)


def convert_state(matcher: dict, wls: dict, Q, intrinsics=None, device="cuda") -> SliceState:
    """The port's configs and tensors from the JAX package's state."""
    Q = np.asarray(Q, np.float32)
    if Q.shape != (4, 4):
        raise ValueError(f"Q must be 4x4, got {Q.shape}")
    intr = None if intrinsics is None else CameraIntrinsics.from_matrix(
        np.asarray(intrinsics, np.float32))
    return SliceState(matcher=matcher_config(matcher), wls=wls_config(wls),
                      Q=torch.as_tensor(Q, device=device), intrinsics=intr)


def stereo_params(fields: dict) -> StereoParams:
    """The port's StereoParams from ``dataclasses.asdict`` of the JAX one."""
    return StereoParams(**{k: None if v is None else np.asarray(v) for k, v in fields.items()})


_PLAN_ARRAYS = {"vy": np.float32, "hx": np.float32, "valid": bool, "v_coarse": np.int32,
                "h_coarse": np.int32}
_PLAN_INTS = ("v_resid_bound", "h_resid_bound", "v_coarse_bits", "h_coarse_bits")


def remap_plan(fields: dict, device="cuda") -> RemapPlan:
    """The port's RemapPlan from the JAX one's fields: its five arrays (as
    numpy) and its four ints, with the arrays on `device`."""
    arrays = {k: torch.as_tensor(np.array(fields[k], dt), device=device)
              for k, dt in _PLAN_ARRAYS.items()}
    return RemapPlan(**arrays, **{k: int(fields[k]) for k in _PLAN_INTS})


def processing_config(fields: dict) -> ProcessingConfig:
    return ProcessingConfig(**fields)


def point_cloud(arrays: dict, device="cuda") -> PointCloud:
    """The port's PointCloud from the JAX one's fields as numpy arrays
    (points, valid and, where present, colors and normals), on `device`."""
    def put(name, dtype):
        a = arrays.get(name)
        return None if a is None else torch.as_tensor(np.array(a, dtype), device=device)

    return PointCloud(points=put("points", np.float32), valid=put("valid", bool),
                      colors=put("colors", np.float32), normals=put("normals", np.float32))


def point_clouds(arrays: dict, device="cuda") -> List[PointCloud]:
    """The port's clouds from a JAX PointCloud whose fields carry a leading
    batch axis (B, N, ...), as numpy arrays: one cloud a batch row."""
    return [point_cloud({k: None if v is None else np.asarray(v)[b] for k, v in arrays.items()},
                        device)
            for b in range(np.asarray(arrays["points"]).shape[0])]


def registration_result(fields: dict, device="cuda") -> RegistrationResult:
    """The port's RegistrationResult from the JAX one's ``_asdict()`` with
    numpy arrays (batched or not): float32 transforms, fitness and rmse,
    int64 iterations."""
    f32 = {k: torch.as_tensor(np.array(fields[k], np.float32), device=device)
           for k in ("transformation", "fitness", "inlier_rmse")}
    return RegistrationResult(**f32, iterations=torch.as_tensor(
        np.array(fields["iterations"], np.int64), device=device))


def scanner_config(fields: dict) -> ScannerConfig:
    """The port's ScannerConfig from ``dataclasses.asdict`` of the JAX one
    (each nested config a dict; the matcher's backend mapped)."""
    f = dict(fields)
    f["matcher"] = matcher_config(f["matcher"])
    for k, cls in (("stream", StreamConfig), ("wls", WLSConfig), ("processing", ProcessingConfig),
                   ("registration", RegistrationConfig), ("fusion", FusionConfig),
                   ("mesh", MeshConfig)):
        f[k] = cls(**f[k])
    return ScannerConfig(**f)


def fusion_config(fields: dict) -> FusionConfig:
    return FusionConfig(**fields)


def mesh_config(fields: dict) -> MeshConfig:
    return MeshConfig(**fields)


def _put(arrays: dict, name: str, dtype, device):
    a = arrays.get(name)
    return None if a is None else torch.as_tensor(np.array(a, dtype), device=device)


def tsdf_volume(arrays: dict, device="cuda") -> TSDFVolume:
    """The port's TSDFVolume from the JAX one's fields as numpy arrays
    (tsdf, weight, origin, voxel_size, sdf_trunc and, where present, color)."""
    return TSDFVolume(**{k: _put(arrays, k, np.float32, device)
                         for k in ("tsdf", "weight", "origin", "voxel_size", "sdf_trunc",
                                   "color")})


_SCALABLE_DTYPES = dict(brick_keys=np.int32, table=np.int32, tsdf=np.float32,
                       weight=np.float32, origin=np.float32, voxel_size=np.float32,
                       sdf_trunc=np.float32, n_alloc=np.int32, n_dropped=np.int32,
                       color=np.float32)


def scalable_volume(arrays: dict, device="cuda") -> ScalableTSDFVolume:
    """The port's ScalableTSDFVolume from the JAX one's fields as numpy
    arrays (brick pool, hash table, counters and, where present, color)."""
    return ScalableTSDFVolume(**{k: _put(arrays, k, t, device)
                                 for k, t in _SCALABLE_DTYPES.items()})


def scalable_volume_arrays(vol: ScalableTSDFVolume) -> dict:
    """The fields of a port ScalableTSDFVolume as numpy arrays of the JAX
    one's dtypes (its constructor's keyword arguments; color None where the
    volume has none)."""
    return {k: None if getattr(vol, k) is None else
            np.asarray(getattr(vol, k).cpu().numpy(), t) for k, t in _SCALABLE_DTYPES.items()}


def triangle_mesh(arrays: dict, device="cuda") -> TriangleMesh:
    """The port's TriangleMesh from the JAX one's fields as numpy arrays."""
    return TriangleMesh(vertices=_put(arrays, "vertices", np.float32, device),
                        triangles=_put(arrays, "triangles", np.int32, device),
                        vertex_valid=_put(arrays, "vertex_valid", bool, device),
                        triangle_valid=_put(arrays, "triangle_valid", bool, device),
                        vertex_colors=_put(arrays, "vertex_colors", np.float32, device),
                        vertex_normals=_put(arrays, "vertex_normals", np.float32, device))


def poisson_mesh(mesh_arrays: dict, densities, device="cuda"):
    """(TriangleMesh, float32 densities) of the port from the JAX Poisson
    result: the mesh's fields and the per-vertex densities as numpy."""
    return (triangle_mesh(mesh_arrays, device),
            torch.as_tensor(np.array(densities, np.float32), device=device))


def rgbd_image(color, depth, device="cuda") -> RGBDImage:
    """The port's RGBDImage from numpy color (H, W, 3) (uint8 or float32,
    kept as given) and depth (H, W) in meters (as float32), on `device`."""
    color = np.asarray(color)
    return RGBDImage(color=torch.as_tensor(color.copy(), device=device),
                     depth=torch.as_tensor(np.array(depth, np.float32), device=device))


def camera_intrinsics(fx, fy, cx, cy) -> CameraIntrinsics:
    """The port's CameraIntrinsics from four numbers (Python floats or the
    JAX one's 0-d float32 arrays), each rounded to float32 as the JAX
    package holds them."""
    return CameraIntrinsics(*(float(np.float32(v)) for v in (fx, fy, cx, cy)))


def pose_graph(nodes, edges) -> PoseGraph:
    """The port's PoseGraph from the JAX one's node poses (4x4 arrays) and
    edges (``dataclasses.asdict`` dicts: source, target, transformation,
    information, uncertain)."""
    g = PoseGraph()
    for pose in nodes:
        g.add_node(np.asarray(pose, np.float64))
    for e in edges:
        g.add_edge(int(e["source"]), int(e["target"]), e["transformation"], e["information"],
                   bool(e["uncertain"]))
    return g


def _tensors(cls, fields: dict, device):
    """A result NamedTuple of the port from the JAX one's ``_asdict()`` with
    numpy arrays, each field as a tensor of its own dtype on `device`."""
    return cls(**{k: torch.as_tensor(np.array(fields[k]), device=device) for k in cls._fields})


def calibration_result(fields: dict, device="cuda") -> CalibrationResult:
    """The port's CalibrationResult (calib/mono.py) from the JAX one's fields."""
    return _tensors(CalibrationResult, fields, device)


def stereo_calibration_result(fields: dict, device="cuda") -> StereoCalibrationResult:
    """The port's StereoCalibrationResult from the JAX one's fields."""
    return _tensors(StereoCalibrationResult, fields, device)


def rectify_result(fields: dict, device="cuda") -> RectifyResult:
    """The port's RectifyResult (R1, R2, P1, P2, Q) from the JAX one's fields."""
    return _tensors(RectifyResult, fields, device)
