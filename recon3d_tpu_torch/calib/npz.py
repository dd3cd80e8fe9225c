"""Calibration NPZ archives (twin of recon3d_tpu/calib/npz.py: the schema
key tuples, `StereoParams` with `load`, `save`, `validate_for_depth`,
`baseline`, and the `inspect` / `describe` dumps). Host numpy.

  STEREO_FULL  keys: mtx1,dist1,mtx2,dist2,R,T,E,F,R1,R2,P1,P2,Q
  STEREO_RAW   keys: k1,d1,k2,d2,R,T
  MONO         keys: k,d,r,t
  MONO_CUSTOM  keys: K_matrix,Dist,r_vecs,t_vecs
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

STEREO_FULL_KEYS = ("mtx1", "dist1", "mtx2", "dist2", "R", "T", "E", "F", "R1", "R2", "P1", "P2",
                    "Q")
STEREO_RAW_KEYS = ("k1", "d1", "k2", "d2", "R", "T")
MONO_KEYS = ("k", "d", "r", "t")
MONO_CUSTOM_KEYS = ("K_matrix", "Dist", "r_vecs", "t_vecs")
# the 9 keys the depth path needs before it builds rectification maps
DEPTH_REQUIRED_KEYS = ("mtx1", "dist1", "mtx2", "dist2", "R1", "R2", "P1", "P2", "Q")


@dataclasses.dataclass
class StereoParams:
    """Full stereo rig parameterization (rectified)."""

    mtx1: np.ndarray  # (3,3) left intrinsics
    dist1: np.ndarray  # (1,k) left distortion, k in {4,5,8,12,14}
    mtx2: np.ndarray
    dist2: np.ndarray
    R: np.ndarray  # (3,3) right-from-left rotation
    T: np.ndarray  # (3,1) translation (same units as calibration target)
    E: Optional[np.ndarray] = None  # essential
    F: Optional[np.ndarray] = None  # fundamental
    R1: Optional[np.ndarray] = None  # rectifying rotations
    R2: Optional[np.ndarray] = None
    P1: Optional[np.ndarray] = None  # (3,4) rectified projections
    P2: Optional[np.ndarray] = None
    Q: Optional[np.ndarray] = None  # (4,4) disparity-to-depth

    @property
    def baseline(self) -> float:
        """Baseline length in calibration units."""
        return float(np.linalg.norm(self.T))

    def save(self, path: str) -> None:
        d = {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
        np.savez(path, **d)

    @staticmethod
    def load(path: str) -> "StereoParams":
        with np.load(path) as d:
            if all(k in d.files for k in STEREO_FULL_KEYS[:6]):
                names = {f.name for f in dataclasses.fields(StereoParams)}
                return StereoParams(**{k: d[k] for k in d.files if k in names})
            if all(k in d.files for k in STEREO_RAW_KEYS):
                return StereoParams(
                    mtx1=d["k1"], dist1=np.atleast_2d(d["d1"]),
                    mtx2=d["k2"], dist2=np.atleast_2d(d["d2"]),
                    R=d["R"], T=d["T"].reshape(3, 1),
                )
            raise ValueError(f"{path}: unrecognized stereo NPZ schema, keys={sorted(d.files)}")

    def validate_for_depth(self) -> None:
        """The 9-key check the depth path makes before computing maps."""
        missing = [k for k in DEPTH_REQUIRED_KEYS if getattr(self, k, None) is None]
        if missing:
            raise KeyError(f"stereo params missing keys required for depth: {missing}")


def inspect(path: str) -> Dict[str, tuple]:
    """Key -> shape of every array in the archive."""
    with np.load(path) as d:
        return {k: tuple(d[k].shape) for k in d.files}


def describe(path: str) -> str:
    """Human-readable parameter report: every array (values when small),
    the baseline and, from Q, the rectified focal and baseline."""
    with np.load(path) as d:
        lines = [f"Calibration file: {path}", "=" * 60]
        for k in d.files:
            a = d[k]
            lines.append(f"\n{k}  shape={a.shape} dtype={a.dtype}")
            if a.size <= 16:
                lines.append(np.array2string(a, precision=6, suppress_small=True))
        if "T" in d.files:
            lines.append(f"\nBaseline |T| = {np.linalg.norm(d['T']):.6f}")
        if "Q" in d.files and abs(d["Q"][3, 2]) > 1e-12:
            lines.append(f"Rectified focal (Q[2,3]) = {d['Q'][2, 3]:.4f}")
            lines.append(f"Baseline from Q = {1.0 / abs(d['Q'][3, 2]):.6f}")
    return "\n".join(lines)
