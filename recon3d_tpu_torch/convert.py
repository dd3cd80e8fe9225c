"""Carry the JAX package's state for the depth slice across to the port.

The slice has no learned weights. Its state is the matcher and WLS
configuration (passed as ``dataclasses.asdict`` dicts of the JAX package's
configs), the 4x4 reprojection matrix Q and, optionally, the pinhole
intrinsics as a 3x3 K; all arrive as plain Python / numpy. The JAX
backends map onto the port's: 'pallas' -> 'cuda', 'xla' -> 'torch'.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
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
