"""Streaming scan -> align -> accumulate -> mesh pipeline (twin of
recon3d_tpu/pipeline/scanner.py; the reference's main.py).

Mirrors the reference's packaged pipeline (main.py:14-90): a capture thread
accumulates an aligned combined cloud until stopped, then the post-scan
chain runs: process -> normals -> Poisson -> save. The combined cloud is a
fixed-capacity buffer on `device`; each frame is aligned to it by ICP and
the quality gate's accept / skip is a `torch.where` select on the device,
so the loop never reads the gate back (the ICP's own stopping rule reads
one flag an iteration). The gate's record is read once, at stop(). Stopping
is an explicit Event (the reference blocks on input(), main.py:64-66).
`timer` holds the wall time of each frame's accumulate step (no sync of
its own) and of finalize's stages (each ending in a device sync).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch

from recon3d_tpu_torch.config import ScannerConfig
from recon3d_tpu_torch.mesh_reconstruction import MeshReconstruction
from recon3d_tpu_torch.mesh_saving import MeshSaving
from recon3d_tpu_torch.normal_estimation import NormalEstimation
from recon3d_tpu_torch.pointcloud_alignment import PointCloudAlignment
from recon3d_tpu_torch.pointcloud_capture import PointCloudCapture
from recon3d_tpu_torch.pointcloud_processing import PointCloudProcessing
from recon3d_tpu_torch.utils import io
from recon3d_tpu_torch.utils.logging import FPSCounter, make_logger
from recon3d_tpu_torch.utils.profiling import StageTimer
from recon3d_tpu_torch.utils.types import (CameraIntrinsics, PointCloud, compact,
                                           concatenate)


class StreamingScanner:
    """The main.py orchestration: wire capture / align / process / mesh / save."""

    def __init__(self, camera, intrinsics: CameraIntrinsics,
                 config: ScannerConfig = ScannerConfig(), device="cuda"):
        self.camera = camera
        self.config = config
        self.device = torch.device(device)
        self.capture = PointCloudCapture(
            intrinsics, voxel_size=config.processing.capture_voxel_size,
            depth_trunc=config.stream.depth_trunc, device=self.device)
        self.alignment = PointCloudAlignment(config.registration)
        self.processing = PointCloudProcessing(config.processing)
        self.normals = NormalEstimation(config.processing)
        self.reconstruction = MeshReconstruction(config.mesh)
        self.saving = MeshSaving()
        self.logger = make_logger("scanner", config.output_dir)
        self.stop_event = threading.Event()
        self.combined: Optional[PointCloud] = None
        self._thread: Optional[threading.Thread] = None
        self.frames = 0
        # per-frame (frame number, good, fitness, rmse), the last three 0-d
        # device tensors: read once, at stop() / frames_rejected
        self._gate_log: list = []
        self.timer = StageTimer()

    def _accumulate(self, combined: PointCloud, pc: PointCloud):
        """Align the new cloud to the accumulated one, evaluate the quality
        gate (check6.py:65-76's fitness / rmse thresholds) on the device and
        select the grown or the unchanged combined cloud with torch.where:
        no host bool() of the gate (main.py:34-52's loop without its
        per-frame reads). Returns (combined, good, fitness, rmse)."""
        c = self.config
        aligned, result = self.alignment.align_point_clouds(pc, combined)
        good = (result.is_good(c.registration.fitness_min, c.registration.rmse_max)
                & (pc.count() > 0))
        grown = compact(concatenate(combined, aligned), c.processing.capacity)
        pick = lambda g, old: None if g is None else torch.where(good, g, old)  # noqa: E731
        new = PointCloud(*(pick(getattr(grown, f.name), getattr(combined, f.name))
                           for f in dataclasses.fields(PointCloud)))
        return new, good, result.fitness, result.inlier_rmse

    def _scan_loop(self, max_frames: Optional[int]):
        """simple_scanning_loop (main.py:34-52)."""
        fps = FPSCounter(self.logger, "scan")
        cap = self.config.processing.capacity
        # A non-looping replay source (camera.loop is False) returns None
        # forever once exhausted: stop on a short streak. A live camera
        # returning None is usually warming up (the reference loop,
        # main.py:49-50, skips forever), so a live source gets a wall-clock
        # bound with a short sleep per empty read.
        replay_eof = getattr(self.camera, "loop", None) is False
        empty_streak = 0
        empty_since: Optional[float] = None
        while not self.stop_event.is_set():
            if max_frames is not None and self.frames >= max_frames:
                break
            pc = self.capture.capture_point_cloud(self.camera)
            if pc is None:
                # grab returned nothing (EOF on replay, warm-up on live); a
                # captured but empty cloud is left to the gate on the device
                empty_streak += 1
                now = time.monotonic()
                empty_since = empty_since if empty_since is not None else now
                if replay_eof and empty_streak >= 3:
                    self.logger.info("replay exhausted after %d empty reads, stopping scan",
                                     empty_streak)
                    break
                if now - empty_since > self.config.empty_timeout_s:
                    self.logger.info("no frames for %.1f s, stopping scan", now - empty_since)
                    break
                time.sleep(0.005)
                continue
            empty_streak = 0
            empty_since = None
            pc = compact(pc, min(pc.capacity, cap // 4))
            if self.combined is None:
                # the first frame seeds the map; an all-invalid first cloud
                # costs one read to detect, once a scan
                if int(pc.count()) == 0:
                    continue
                self.combined = compact(pc, cap)
            else:
                with self.timer.stage("accumulate"):
                    self.combined, good, fit, rmse = self._accumulate(self.combined, pc)
                # self.frames is this frame's 0-based number (empty grabs
                # never count), so deferred warnings name the right frame
                self._gate_log.append((self.frames, good, fit, rmse))
            # max_frames counts processed attempts, accepted or rejected
            self.frames += 1
            fps.tick()

    def start(self, max_frames: Optional[int] = None) -> None:
        self.stop_event.clear()
        self._thread = threading.Thread(target=self._scan_loop, args=(max_frames,),
                                        daemon=True)
        self._thread.start()

    def _gate_record(self):
        """[(frame, good, fitness, rmse)] as host values: one device read."""
        if not self._gate_log:
            return []
        vals = torch.stack([torch.stack([g.to(torch.float32), f.to(torch.float32),
                                         r.to(torch.float32)])
                            for _, g, f, r in self._gate_log]).cpu().tolist()
        return [(n, bool(g), f, r) for (n, _, _, _), (g, f, r) in zip(self._gate_log, vals)]

    @property
    def frames_rejected(self) -> int:
        """Frames the quality gate skipped (reads the device on access)."""
        return sum(1 for _, g, _, _ in self._gate_record() if not g)

    def stop(self) -> None:
        self.stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        # deferred gate reporting: one read a run, not one a frame
        for n, g, f, r in self._gate_record():
            if not g:
                self.logger.warning("frame %d failed quality gate (fitness=%.3f rmse=%.4f), "
                                    "skipped", n, f, r)

    def finalize(self, output_prefix: str = "captured_data_on_the_fly"):
        """The post-scan chain (main.py:64-91): save the raw cloud, process,
        normals, Poisson, save the mesh. Returns (mesh, densities, paths)."""
        if self.combined is None:
            raise RuntimeError("nothing captured")
        t = self.timer
        raw_path = f"{output_prefix}.ply"
        with t.stage("save_raw"):
            io.write_point_cloud(raw_path, self.combined)
        with t.stage("process"):
            pc = self.processing.process_point_cloud(self.combined)
            t.sync(pc)
        with t.stage("normals"):
            pc = self.normals.estimate_normals(pc)
            t.sync(pc)
        with t.stage("poisson"):
            mesh, densities = self.reconstruction.reconstruct_mesh(pc)
            t.sync((mesh, densities))
        with t.stage("save"):
            paths = self.saving.save_mesh(mesh, densities, filename=f"{output_prefix}_mesh.ply")
        self.logger.info("saved %s", paths)
        return mesh, densities, (raw_path,) + tuple(p for p in paths if p)
