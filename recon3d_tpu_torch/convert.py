"""Carry the JAX package's state for the depth path across to the port.

The path has no learned weights. Its state is the matcher and WLS
configuration (passed as ``dataclasses.asdict`` dicts of the JAX package's
configs), the 4x4 reprojection matrix Q, optionally the pinhole intrinsics
as a 3x3 K, the stereo calibration (`stereo_params`) and the two-pass warp
plans (`remap_plan`); all arrive as plain Python / numpy. The JAX backends
map onto the port's: 'pallas' -> 'cuda', 'xla' -> 'torch'.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from recon3d_tpu_torch.calib.npz import StereoParams
from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.ops.warp import RemapPlan
from recon3d_tpu_torch.utils.types import CameraIntrinsics

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
