"""Matcher, WLS, stream, point-cloud processing, registration, fusion,
meshing and scanner configuration, and the argparse bridge that makes
--flags of their fields (twin of recon3d_tpu/config.py).

Frozen dataclasses with the reference's defaults. The only difference from
the JAX package is the `backend` vocabulary: 'cuda' is the hand-written
kernel path (its plain PyTorch versions on CPU tensors), 'torch' the plain
oracle of depth/sgm.py and depth/wls.py, and 'auto' picks by the tensors'
device (kernel path on CUDA, oracle on CPU) as JAX's picks by platform.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, get_type_hints


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
    # 'cuda': the kernel path; 'torch': the plain oracle; 'auto': the kernel
    # path for CUDA tensors, the oracle for CPU tensors
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


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Capture stream settings (reference: realsense_pipeline.py:20-23, mini1.py:78-80)."""

    width: int = 640
    height: int = 480
    fps: int = 30
    depth_scale: float = 1000.0  # uint16 units per meter
    depth_trunc: float = 3.0  # meters (mini1.py create_from_color_and_depth default)
    align_depth_to_color: bool = True


@dataclasses.dataclass(frozen=True)
class ProcessingConfig:
    """Point-cloud processing (reference: pointcloud_processing.py:27-40, main flow)."""

    capture_voxel_size: float = 0.01  # pointcloud_capture.py:50
    voxel_size: float = 0.0025  # pointcloud_processing.py:27
    outlier_nb_neighbors: int = 30  # :36
    outlier_std_ratio: float = 1.2  # :36
    radius_nb_points: int = 16  # :40
    radius: float = 0.01  # :40
    normal_max_nn: int = 50  # normal_estimation.py:20
    normal_radius: float = 0.05  # :20
    capacity: int = 1 << 18  # static point buffer capacity


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Alignment settings (reference: pointcloud_alignment.py:22-40, mini1.py:263-341)."""

    voxel_size: float = 0.02
    icp_threshold: float = 0.02
    icp_max_iterations: int = 100
    icp_rel_fitness: float = 1e-6
    icp_rel_rmse: float = 1e-6
    # point_to_point | point_to_plane | gicp | ransac_fpfh | fgr | odometry
    method: str = "point_to_point"
    fitness_min: float = 0.3  # quality gate (check6.py:65-76)
    rmse_max: float = 0.02
    ransac_max_iterations: int = 100_000  # mini1.py uses 4e6; trials are batched
    ransac_confidence: float = 0.999


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """TSDF volume settings (reference: mini1.py:33-37, check90.py:36-41)."""

    voxel_size: float = 0.004
    sdf_trunc: float = 0.02
    grid_resolution: int = 256  # static dense-block resolution per axis
    block_count: int = 2048  # hashed brick capacity
    block_size: int = 8  # voxels per brick side
    depth_trunc: float = 3.0
    color: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Meshing settings (reference: mesh_reconstruction.py:13-39)."""

    poisson_depth: int = 6
    smoothing_iterations: int = 5
    density_quantile: float = 0.01  # low-density vertex cull / highlight (visualizer.py:41-57)


@dataclasses.dataclass(frozen=True)
class ScannerConfig:
    """Top-level pipeline config, superset of mini1.py:535-556 argparse flags."""

    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    matcher: StereoMatcherConfig = dataclasses.field(default_factory=StereoMatcherConfig)
    wls: WLSConfig = dataclasses.field(default_factory=WLSConfig)
    processing: ProcessingConfig = dataclasses.field(default_factory=ProcessingConfig)
    registration: RegistrationConfig = dataclasses.field(default_factory=RegistrationConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    output_dir: str = "output"
    visualize: bool = False
    max_fragments: int = 64  # fragment ring buffer cap (check83.py:318-330)
    save_frames: bool = True  # per-frame checkpointing (mini1.py:154-158)
    # stop the scan thread after this long without a single valid frame from
    # a live source (replay sources cut on a short empty-read streak instead)
    empty_timeout_s: float = 5.0


_LEAF = (int, float, str, bool)


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = "") -> None:
    """Auto-generate --flags from (nested) dataclass fields."""
    hints = get_type_hints(cls)
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(t):
            add_dataclass_args(parser, t, prefix=f"{name}.")
        elif t in _LEAF:
            default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
            if t is bool:
                parser.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                                    default=default, metavar="BOOL")
            else:
                parser.add_argument(f"--{name}", type=t, default=default)


def dataclass_from_args(cls, args: argparse.Namespace, prefix: str = ""):
    """Rebuild a (nested) dataclass from parsed args: each field from its
    dotted flag name (or the name with "_" for ".", where a caller stored it
    so), else its default."""
    hints = get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(t):
            kw[f.name] = dataclass_from_args(t, args, prefix=f"{name}.")
        elif t in _LEAF:
            kw[f.name] = getattr(args, name.replace(".", "_"), getattr(args, name, None))
            if kw[f.name] is None:
                kw[f.name] = f.default if f.default is not dataclasses.MISSING else f.default_factory()
    return cls(**kw)


def parse_scanner_config(argv: Optional[list] = None) -> ScannerConfig:
    """CLI covering (a superset of) mini1.py:538-556's flags, with the
    reference's aliases --voxel_size, --downsample_voxel_size, --sdf_trunc
    and --fps."""
    p = argparse.ArgumentParser(description="recon3d_tpu_torch scanner")
    add_dataclass_args(p, ScannerConfig)
    p.add_argument("--voxel_size", type=float, default=None, help="alias of --fusion.voxel_size")
    p.add_argument("--downsample_voxel_size", type=float, default=None,
                   help="alias of --processing.voxel_size")
    p.add_argument("--sdf_trunc", type=float, default=None, help="alias of --fusion.sdf_trunc")
    p.add_argument("--fps", type=int, default=None, help="alias of --stream.fps")
    args = p.parse_args(argv)
    ns = vars(args)
    if args.voxel_size is not None:
        ns["fusion.voxel_size"] = args.voxel_size
    if args.downsample_voxel_size is not None:
        ns["processing.voxel_size"] = args.downsample_voxel_size
    if args.sdf_trunc is not None:
        ns["fusion.sdf_trunc"] = args.sdf_trunc
    if args.fps is not None:
        ns["stream.fps"] = args.fps
    return dataclass_from_args(ScannerConfig, args)
