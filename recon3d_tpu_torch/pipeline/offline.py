"""Offline fragment pipeline: capture / save -> register -> TSDF -> mesh
(twin of recon3d_tpu/pipeline/offline.py).

The test/mini1.py twin (the reference's most complete program,
mini1.py:499-533 run()): scan frames to disk (color / depth PNG, per-frame
checkpoints, mini1.py:154-183), reload offline (load_rgbd_frames,
:188-212), register the fragments pairwise (FPFH -> RANSAC -> point-to-plane
ICP -> information matrix, :213-321), optimize the pose graph (LM,
:323-341), integrate into a TSDF (:332-356), extract, smooth and clean the
mesh (:357-390) and save it (:487-496).

Frames stay on the host as numpy (the camera's types); each stage moves
what it needs to `device`, the card unless the caller asks for the CPU.
The pairs run through parallel.batch.register_pairs_ransac_batched, the
pose graph's LM and the TSDF on `device`; on the card the TSDF folds each
frame in with one launch of the fuse kernel (ops/tsdf_fuse_cuda.py). The fragment count is
capped by a ring buffer (check83.py:318-330). `timer` holds each stage's
wall time, each ending in a device sync.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.config import ScannerConfig
from recon3d_tpu_torch.fusion import marching as _marching
from recon3d_tpu_torch.fusion import tsdf as _tsdf
from recon3d_tpu_torch.mesh import ops as mops
from recon3d_tpu_torch.parallel.batch import register_pairs_ransac_batched
from recon3d_tpu_torch.pointcloud.backproject import backproject_depth
from recon3d_tpu_torch.pointcloud.normals import estimate_normals
from recon3d_tpu_torch.pointcloud.outliers import remove_statistical_outliers
from recon3d_tpu_torch.pointcloud.voxel import voxel_downsample
from recon3d_tpu_torch.registration.features import compute_fpfh
from recon3d_tpu_torch.registration.posegraph import PoseGraph, global_optimization
from recon3d_tpu_torch.utils import io
from recon3d_tpu_torch.utils.logging import FPSCounter, make_logger
from recon3d_tpu_torch.utils.profiling import StageTimer
from recon3d_tpu_torch.utils.types import CameraIntrinsics, compact


class Scanner3D:
    """RealSense3DScanner equivalent (mini1.py) over any Camera backend."""

    def __init__(self, camera, intrinsics: CameraIntrinsics,
                 config: ScannerConfig = ScannerConfig(), device="cuda"):
        self.camera = camera
        self.intrinsics = intrinsics
        self.config = config
        self.device = torch.device(device)
        os.makedirs(config.output_dir, exist_ok=True)
        self.logger = make_logger("scanner3d", config.output_dir)
        self.frames: List[Tuple[np.ndarray, np.ndarray]] = []  # (color, depth)
        self.timer = StageTimer()

    # ---- capture (mini1.py:104-187) ----
    def capture_frames(self, n_frames: int) -> int:
        fps = FPSCounter(self.logger, "capture")
        self.camera.open()
        count = 0
        with self.timer.stage("capture"):
            while count < n_frames:
                frame = self.camera.grab()
                if frame is None:
                    break
                color, depth = frame
                if self.config.save_frames:
                    out = self.config.output_dir
                    io.write_color(os.path.join(out, f"color_{count:05d}.png"), color)
                    io.write_depth(os.path.join(out, f"depth_{count:05d}.png"), depth,
                                   self.config.stream.depth_scale)
                # cap memory like the fragment ring buffer (check83.py:318-330)
                if len(self.frames) >= self.config.max_fragments:
                    self.frames.pop(0)
                self.frames.append((color, depth))
                count += 1
                fps.tick()
        return count

    def load_rgbd_frames(self, directory: Optional[str] = None) -> int:
        """Offline reload (mini1.py:188-212), decoded by the native
        thread-pool loader: the hardware-free path."""
        self.frames = io.load_rgbd_frames_batch(
            directory or self.config.output_dir, depth_scale=self.config.stream.depth_scale,
            max_frames=self.config.max_fragments)
        return len(self.frames)

    # ---- registration (mini1.py:213-341) ----
    def _preprocess(self, color, depth, capacity=8192):
        c = self.config.registration
        pc = backproject_depth(torch.as_tensor(depth, device=self.device), self.intrinsics,
                               color=torch.as_tensor(color, device=self.device),
                               depth_trunc=self.config.stream.depth_trunc)
        pc = voxel_downsample(pc, c.voxel_size)
        pc = compact(pc, capacity)
        pc = remove_statistical_outliers(pc, nb_neighbors=20, std_ratio=2.0)
        pc = estimate_normals(pc, radius=2.0 * c.voxel_size, max_nn=30)
        feat = compute_fpfh(pc, radius=5.0 * c.voxel_size, max_nn=64)
        return pc, feat

    def register_fragments(self) -> PoseGraph:
        """Pairwise registration into a pose graph (mini1.py:263-341).

        Every pair, the sequential chain and the loop-closure candidates,
        goes through one register_pairs_ransac_batched call (RANSAC-FPFH +
        ICP refine + information matrix). A weak sequential pair becomes an
        identity edge marked uncertain; a weak loop pair is left out. Node
        poses are world_from_frame.
        """
        c = self.config.registration
        graph = PoseGraph()
        graph.add_node(np.eye(4))
        clouds, feats = [], []
        with self.timer.stage("preprocess"):
            for color, depth in self.frames:
                pc, f = self._preprocess(color, depth)
                clouds.append(pc)
                feats.append(f)
            self.timer.sync(feats)
        self.clouds, self.feats = clouds, feats
        n = len(clouds)

        seq_pairs = [(i, i - 1) for i in range(1, n)]
        stride = max(n // 4, 2)
        loop_pairs = [(i, i - stride) for i in range(stride, n, stride)]
        pairs = seq_pairs + loop_pairs
        if not pairs:
            self.pose_graph = global_optimization(graph, device=self.device)
            return self.pose_graph

        self.pairs = pairs
        with self.timer.stage("pairs"):
            res, infos = register_pairs_ransac_batched(
                [clouds[i] for i, _ in pairs], [clouds[j] for _, j in pairs],
                [feats[i] for i, _ in pairs], [feats[j] for _, j in pairs],
                distance_threshold=1.5 * c.voxel_size,
                num_trials=min(c.ransac_max_iterations, 65536))
            self.pair_results = (res, infos)
            good = res.is_good(c.fitness_min, c.rmse_max * 5).cpu().numpy()
            Ts = res.transformation.cpu().double().numpy()
            infos = infos.cpu().double().numpy()
            fitness = res.fitness.cpu().numpy()

        with self.timer.stage("pose_graph"):
            world_from_prev = np.eye(4)
            for k, (i, j) in enumerate(seq_pairs):
                if not good[k]:
                    # registration failure -> identity + uncertain edge
                    # (check82.py:200-207 pattern)
                    self.logger.warning("pair %d->%d weak (fitness %.3f); identity fallback",
                                        i, j, float(fitness[k]))
                    T, info, uncertain = np.eye(4), np.eye(6) * 1e-3, True
                else:
                    T, info, uncertain = Ts[k], infos[k], False
                world_from_i = world_from_prev @ T
                graph.add_node(world_from_i)
                # edge (source=i, target=j=i-1) measures X_{i-1}^-1 X_i = T
                graph.add_edge(i, j, T, info, uncertain=uncertain)
                world_from_prev = world_from_i
            for k, (i, j) in enumerate(loop_pairs, start=len(seq_pairs)):
                if good[k]:
                    graph.add_edge(i, j, Ts[k], infos[k], uncertain=True)
            # LM (mini1.py:323-341)
            self.pose_graph = global_optimization(graph, device=self.device)
        return self.pose_graph

    # ---- fusion + meshing (mini1.py:332-390) ----
    def integrate_fragments(self, resolution: int = 256) -> _tsdf.TSDFVolume:
        cfg = self.config.fusion
        with self.timer.stage("integrate"):
            # volume bounds from the registered clouds
            pts = np.concatenate([pc.masked_points(float("nan")).cpu().numpy()
                                  for pc in self.clouds], 0)
            pts = pts[np.isfinite(pts).all(1)]
            center = pts.mean(0)
            span = max(resolution * cfg.voxel_size, 1e-3)
            origin = center - span / 2
            vol = _tsdf.make_volume(resolution=resolution, voxel_size=cfg.voxel_size,
                                    sdf_trunc=cfg.sdf_trunc, origin=tuple(origin),
                                    with_color=cfg.color, device=self.device)
            for k, (color, depth) in enumerate(self.frames):
                pose = self.pose_graph.nodes[k]  # world_from_frame
                if not np.isfinite(pose).all():  # finite-pose gate (mini1.py:345-348)
                    self.logger.warning("skipping frame %d: non-finite pose", k)
                    continue
                extrinsic = torch.as_tensor(np.asarray(np.linalg.inv(pose), np.float32),
                                            device=self.device)
                # the volume is this call's own: integrate into its buffers
                vol = _tsdf.integrate_donated(vol, torch.as_tensor(depth, device=self.device),
                                              self.intrinsics, extrinsic,
                                              color=torch.as_tensor(color, device=self.device),
                                              depth_trunc=cfg.depth_trunc)
            self.timer.sync(vol)
        self.volume = vol
        return vol

    def extract_mesh(self):
        """Extract + smooth + clean (mini1.py:357-390)."""
        with self.timer.stage("extract"):
            mesh = _marching.extract_triangle_mesh(self.volume)
            mesh = mops.filter_smooth_laplacian(
                mesh, iterations=self.config.mesh.smoothing_iterations)
            mesh = mops.cleanup(mesh)
            mesh = mops.compute_vertex_normals(mesh)
            self.timer.sync(mesh)
        return mesh

    def save_mesh(self, mesh, name: Optional[str] = None) -> str:
        path = os.path.join(self.config.output_dir,
                            name or f"output_mesh_{time.strftime('%Y%m%d_%H%M%S')}.ply")
        with self.timer.stage("save"):
            io.write_triangle_mesh(path, mesh)
        self.logger.info("mesh saved to %s", path)
        return path

    def run(self, n_frames: int = 16) -> str:
        """Full offline pipeline (mini1.py:499-533)."""
        captured = self.capture_frames(n_frames)
        self.logger.info("captured %d frames", captured)
        self.register_fragments()
        self.integrate_fragments(resolution=self.config.fusion.grid_resolution)
        mesh = self.extract_mesh()
        return self.save_mesh(mesh)
