"""The yardstick: the card's peaks and the least work of each stage.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
HBM at 3.35e12 B/s and float32 outside the tensor cores at 67e12 FLOP/s,
a fused multiply-add counted as two operations; that is 132 SMs x 128 lanes
x 1.98 GHz = 33.45e12 float32 instructions a second. A run records the
card's power limit beside every share (`device.power_limit_w`).

The least work of a stage is counted from its shapes, whatever kernels
implement it: each input byte read once, each output byte written once,
and the operations the algorithm cannot do without. The least time is the
larger of the bytes over the HBM rate and the operations over their
ceiling; `least_ms` says which of the two binds.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32_INSTR_PER_S = 132 * 128 * 1.98e9


def least_ms(nbytes: float, nops: float, ops_per_s: float) -> tuple:
    """(least ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sgm_work(H: int, W: int, D: int, paths: int, block: int) -> dict:
    """The SGM stage of one frame: rectified float32 pair in, float32
    disparity and bool validity out. Operations per pixel and disparity,
    each one float32 instruction (minimum, maximum, addition or
    subtraction; none fuses into a multiply-add): the Birchfield-Tomasi
    cost 9 (two one-sided bounds of 4 each and their minimum), the box sum
    4 (a running sum along each axis adds the entering and subtracts the
    leaving tap), each path 7 (the carry's running minimum, the neighbours'
    minimum, + P1, the minimum with the carry and with min + P2, + cost,
    - min), the paths' sum paths - 1, and 3 for the winner, the uniqueness
    runner-up and the right view's winner. `block` only sizes the box,
    whose running sums cost the same at any width."""
    if block < 1 or paths < 1:
        raise ValueError("block and paths must be positive")
    per_cell = 9 + 4 + 7 * paths + (paths - 1) + 3
    return {"bytes": H * W * (4 + 4 + 4 + 1), "ops": per_cell * H * W * D,
            "ops_per_s": F32_INSTR_PER_S}


def integrate_work(R: int, H: int, W: int, color: bool, frames: int) -> dict:
    """A step that fuses `frames` frames into an R^3 volume: the volume's
    float32 tsdf and weight (and 3-channel colour) read once and written
    once, each frame's float32 depth (and uint8 colour) read once. The
    arithmetic (a projection of about 30 operations a voxel and frame) is
    two orders below the bytes and not counted."""
    per_voxel = 4 + 4 + (12 if color else 0)
    frame = H * W * (4 + (3 if color else 0))
    return {"bytes": 2 * per_voxel * R ** 3 + frames * frame, "ops": 0,
            "ops_per_s": F32_FLOP_PER_S}


def per_frame(work: dict, frames: int) -> dict:
    """A step's work divided over its frames."""
    return {"bytes": work["bytes"] / frames, "ops": work["ops"] / frames,
            "ops_per_s": work["ops_per_s"]}
