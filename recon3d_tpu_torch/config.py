"""Matcher and WLS configuration (twin of recon3d_tpu/config.py:19-115).

Frozen dataclasses with the reference's defaults. The only difference from
the JAX package is the `backend` vocabulary: 'cuda' is the hand-written
kernel path (its plain PyTorch versions on CPU tensors), 'torch' the plain
oracle of depth/sgm.py and depth/wls.py.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StereoMatcherConfig:
    """SGM/BM matcher settings (reference defaults: depth4.py:151-177).

    P1/P2 follow OpenCV's convention 8*c*w^2 / p2_factor*c*w^2, computed in
    `p1()`/`p2()` from block_size so live tuning stays consistent.
    """

    num_disparities: int = 128  # multiple of 16 in [16, 256]
    block_size: int = 5  # odd, in [3, 11]
    channels: int = 1
    disp12_max_diff: int = 1
    uniqueness_ratio: int = 10
    speckle_window_size: int = 50
    speckle_range: int = 32
    pre_filter_cap: int = 63
    # 'sgm3' = {L, R, down}, 'sgm4' adds up, 'sgm8' adds diagonals,
    # 'bm' = block matching (SGM with zero penalties)
    mode: str = "sgm4"
    subpixel: bool = True
    lr_check: bool = True
    p2_factor: int = 32
    # 'auto' and 'cuda': the kernel path; 'torch': the plain oracle
    backend: str = "auto"  # 'auto' | 'cuda' | 'torch'
    # 'auto': box-count speckle on the kernel path, exact labeling on torch
    speckle_method: str = "auto"  # 'auto' | 'fast' | 'ccl'

    @classmethod
    def tuned(cls, **kw) -> "StereoMatcherConfig":
        """The production preset: sgm4 with P2 = 96*w^2."""
        kw.setdefault("mode", "sgm4")
        kw.setdefault("p2_factor", 96)
        return cls(**kw)

    @classmethod
    def accurate(cls, **kw) -> "StereoMatcherConfig":
        """The accuracy preset: 8-direction SGM with P2 = 128*w^2."""
        kw.setdefault("mode", "sgm8")
        kw.setdefault("p2_factor", 128)
        return cls(**kw)

    def p1(self) -> int:
        return 8 * self.channels * self.block_size ** 2

    def p2(self) -> int:
        return self.p2_factor * self.channels * self.block_size ** 2

    def adjust(self, key: str) -> "StereoMatcherConfig":
        """Clamped interactive tuning: 'q'/'a' raise/lower block size in
        [3, 11]; 'w'/'s' raise/lower num_disparities by 16 in [16, 256]."""
        if key == "q":
            return dataclasses.replace(self, block_size=min(self.block_size + 2, 11))
        if key == "a":
            return dataclasses.replace(self, block_size=max(self.block_size - 2, 3))
        if key == "w":
            return dataclasses.replace(self, num_disparities=min(self.num_disparities + 16, 256))
        if key == "s":
            return dataclasses.replace(self, num_disparities=max(self.num_disparities - 16, 16))
        return self


@dataclasses.dataclass(frozen=True)
class WLSConfig:
    """Edge-aware disparity refinement (reference: depth4.py:173-177)."""

    lam: float = 8000.0
    sigma_color: float = 1.5
    iterations: int = 3  # FGS sweeps (lambda attenuation 1/4 per sweep)

    def adjust(self, key: str) -> "WLSConfig":
        if key == "e":
            return dataclasses.replace(self, lam=min(self.lam * 2, 128000.0))
        if key == "d":
            return dataclasses.replace(self, lam=max(self.lam / 2, 500.0))
        if key == "r":
            return dataclasses.replace(self, sigma_color=min(self.sigma_color + 0.25, 5.0))
        if key == "f":
            return dataclasses.replace(self, sigma_color=max(self.sigma_color - 0.25, 0.25))
        return self
