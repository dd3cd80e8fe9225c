"""Depth post-processing filters (twin of recon3d_tpu/depth/filters.py).

The reference leans on librealsense's C++ filter chain,
``rs.decimation_filter / spatial_filter / temporal_filter /
hole_filling_filter`` (check90.py:99-103, colorReco.py:94-102). These are
the same four filters in plain PyTorch on the tensor's device, so replayed
and synthetic streams get the pre-TSDF depth conditioning the live sensor
path had, next to odometry and fusion.

Semantics follow librealsense's documented behavior (invalid depth = 0):

- decimation: block-downsample by ``magnitude``, each output pixel the
  median of the valid pixels in its block (0 if none);
- spatial: iterated 1-D edge-preserving exponential smoothing swept in all
  four directions; a step larger than ``delta`` resets the recursion so
  depth discontinuities never bleed. Each sweep is a loop of row-vector
  steps over the columns (the JAX package's lax.scan);
- temporal: EMA against a persistent history with a ``delta`` gate, plus
  persistence fill of current dropouts from recently-valid history;
- hole filling: ``left`` (the last valid value along the row: a cummax over
  the index of the last valid pixel, the JAX package's associative scan)
  or ``nearest`` (8-neighbor valid fill, iterated).

All filters take and return float32 meters with 0 = invalid. Every constant
takes part in float32, as in the JAX programs, and the arithmetic rounds as
XLA's CPU code rounds the jitted filters: the spatial and the temporal
blends ``alpha * x + (1 - alpha) * y`` as fma(alpha, x, (1 - alpha) * y).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.ops.image import fma


def _valid(depth: torch.Tensor) -> torch.Tensor:
    return depth > 0.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 constant on `like`'s device, made without a host copy."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def decimation_filter(depth: torch.Tensor, magnitude: int = 2) -> torch.Tensor:
    """Block median downsample (librealsense decimation, default 2x).

    Median over the valid pixels of each magnitude x magnitude block;
    blocks with no valid pixel stay invalid (0).
    """
    m = int(magnitude)
    if m <= 1:
        return depth
    H, W = depth.shape
    Hc, Wc = (H // m) * m, (W // m) * m
    d = depth[:Hc, :Wc].reshape(Hc // m, m, Wc // m, m)
    d = d.permute(0, 2, 1, 3).reshape(Hc // m, Wc // m, m * m)
    # median of the valid values: invalids sort last as +inf, then index the
    # middle of the valid run of each block
    n = (d > 0.0).sum(-1)
    s = torch.sort(torch.where(d > 0.0, d, float("inf")), dim=-1).values
    mid = torch.clamp(n - 1, min=0) // 2
    med = torch.gather(s, -1, mid[..., None])[..., 0]
    return torch.where(n > 0, med, 0.0)


def _ema_pass(depth: torch.Tensor, alpha: float, delta: float) -> torch.Tensor:
    """One left-to-right edge-preserving EMA sweep along the last axis: a
    loop of row-vector steps over the columns, each
    prev = ok ? fma(alpha, col, (1 - alpha) * prev) : col. At alpha = 0.5
    both products are exact, so the plain float32 sum is the fused one and
    the step skips the fused multiply-add's emulation (a third of the
    launches)."""
    a, dl = _f32(alpha, depth), _f32(delta, depth)
    b = _f32(1.0, depth) - a  # 1 - alpha in float32, as in the traced JAX program
    cols = depth.t().contiguous()
    pos = cols > 0.0
    halves = float(np.float32(alpha)) == 0.5
    acols = a * cols if halves else None
    out = torch.empty_like(cols)
    prev = torch.zeros_like(cols[0])  # last filtered value a row (0: reset)
    for j in range(cols.shape[0]):
        col = cols[j]
        ok = pos[j] & (prev > 0.0) & (torch.abs(col - prev) <= dl)
        mix = acols[j] + b * prev if halves else fma(a.expand_as(col), col, b * prev)
        prev = torch.where(ok, mix, col, out=out[j])
    return out.t()


def spatial_filter(depth: torch.Tensor, alpha: float = 0.5, delta: float = 0.02,
                   iterations: int = 2) -> torch.Tensor:
    """Edge-preserving smoothing (librealsense spatial filter).

    Four directional recursive EMA passes per iteration (l2r, r2l, t2b,
    b2t); ``delta`` is in meters (the SDK's default 20 units at the D415's
    1 mm scale = 0.02 m).
    """
    for _ in range(int(iterations)):
        depth = _ema_pass(depth, alpha, delta)
        depth = _ema_pass(depth.flip(1), alpha, delta).flip(1)
        depth = _ema_pass(depth.t(), alpha, delta).t()
        depth = _ema_pass(depth.t().flip(1), alpha, delta).flip(1).t()
    return depth.contiguous()


class TemporalState(NamedTuple):
    """Persistent cross-frame state for `temporal_filter`."""

    history: torch.Tensor  # last filtered depth (H, W) float32
    age: torch.Tensor      # frames since history pixel was last valid (int32)


def make_temporal_state(shape: Tuple[int, int], device="cuda") -> TemporalState:
    return TemporalState(history=torch.zeros(shape, dtype=torch.float32, device=device),
                         age=torch.full(shape, 10_000, dtype=torch.int32, device=device))


def temporal_filter(depth: torch.Tensor, state: TemporalState, alpha: float = 0.4,
                    delta: float = 0.02,
                    persistence: int = 3) -> Tuple[torch.Tensor, TemporalState]:
    """EMA against frame history + dropout persistence (librealsense temporal).

    Valid pixels within ``delta`` of a valid history blend by ``alpha``;
    invalid pixels whose history was valid within the last ``persistence``
    frames are filled from history (0 disables persistence).
    """
    a = _f32(alpha, depth)
    cur_ok = _valid(depth)
    hist_ok = state.age == 0
    close = torch.abs(depth - state.history) <= _f32(delta, depth)
    mix = fma(a.expand_as(depth), depth, (_f32(1.0, depth) - a) * state.history)
    blended = torch.where(cur_ok & hist_ok & close, mix, depth)
    recent = (state.age <= persistence if persistence > 0
              else torch.zeros_like(hist_ok))
    out = torch.where(cur_ok, blended, torch.where(recent, state.history, 0.0))
    new_hist = torch.where(cur_ok, blended, state.history)
    new_age = torch.where(cur_ok, 0, torch.clamp(state.age + 1, max=10_000)).to(torch.int32)
    return out, TemporalState(history=new_hist, age=new_age)


def _fill_left(depth: torch.Tensor) -> torch.Tensor:
    """Propagate the last valid value rightward along each row: the running
    maximum of the index of the last valid pixel, then one gather."""
    ok = _valid(depth)
    idx = torch.arange(depth.shape[1], device=depth.device).expand_as(depth)
    last = torch.cummax(torch.where(ok, idx, -1), dim=1).values
    v = torch.gather(depth, 1, torch.clamp(last, min=0))
    return torch.where(ok, depth, torch.where(last >= 0, v, 0.0))


def _fill_nearest(depth: torch.Tensor, iterations: int) -> torch.Tensor:
    """Fill holes from the nearest valid 8-neighbor (iterated dilation)."""
    for _ in range(iterations):
        ok = _valid(depth)
        best = torch.full_like(depth, float("inf"))
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                n = torch.roll(depth, (dy, dx), dims=(0, 1))
                best = torch.minimum(best, torch.where(n > 0.0, n, float("inf")))
        depth = torch.where(ok, depth, torch.where(torch.isfinite(best), best, 0.0))
    return depth


def hole_filling_filter(depth: torch.Tensor, mode: str = "left",
                        iterations: int = 2) -> torch.Tensor:
    """Fill invalid pixels (librealsense hole_filling_filter).

    mode='left' copies the last valid value along the row (SDK mode 0);
    mode='nearest' takes the nearest valid 8-neighbor, iterated (SDK
    mode 2's cheap analog).
    """
    if mode == "left":
        return _fill_left(depth)
    if mode == "nearest":
        return _fill_nearest(depth, int(iterations))
    raise ValueError(f"unknown hole-filling mode {mode!r}")


@dataclasses.dataclass
class DepthFilterBank:
    """The reference's full filter chain, SDK order (check90.py:99-103):
    decimation -> spatial -> temporal -> hole filling. Stateful across
    frames (temporal history, on the frames' device); call per frame. A
    frame given as a tensor is filtered on its device; any other array
    (a camera's numpy frame) is put on `device` first. Any stage disables
    with its 'enabled' flag. Note decimation shrinks the image by
    `magnitude`, exactly like the SDK (adjust intrinsics accordingly).
    """

    decimation: int = 0          # 0/1 = off; >=2 = block size
    spatial: bool = True
    spatial_alpha: float = 0.5
    spatial_delta: float = 0.02
    spatial_iterations: int = 2
    temporal: bool = True
    temporal_alpha: float = 0.4
    temporal_delta: float = 0.02
    persistence: int = 3
    hole_fill: Optional[str] = "left"   # None | 'left' | 'nearest'
    device: str = "cuda"               # where a non-tensor frame goes
    _state: Optional[TemporalState] = dataclasses.field(default=None, repr=False)

    def reset(self) -> None:
        self._state = None

    def __call__(self, depth: torch.Tensor) -> torch.Tensor:
        if torch.is_tensor(depth):
            depth = depth.to(torch.float32)
        else:
            depth = torch.as_tensor(np.asarray(depth), dtype=torch.float32, device=self.device)
        if self.decimation >= 2:
            depth = decimation_filter(depth, magnitude=self.decimation)
        if self.spatial:
            depth = spatial_filter(depth, self.spatial_alpha, self.spatial_delta,
                                   iterations=self.spatial_iterations)
        if self.temporal:
            if (self._state is None or self._state.history.shape != depth.shape
                    or self._state.history.device != depth.device):
                self._state = make_temporal_state(tuple(depth.shape), depth.device)
            depth, self._state = temporal_filter(
                depth, self._state, self.temporal_alpha, self.temporal_delta,
                persistence=self.persistence)
        if self.hole_fill is not None:
            depth = hole_filling_filter(depth, mode=self.hole_fill)
        return depth
