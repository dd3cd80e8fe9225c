"""Real-time odometry + TSDF fusion (twin of recon3d_tpu/pipeline/streaming.py;
the check90.py twin).

Producer/consumer streaming SLAM (check90.py:64, 227-277): a capture thread
feeds a bounded queue; the fusion thread tracks the camera pose with RGB-D
odometry (hybrid term, check90.py:202-206) and integrates each frame into
the TSDF. Odometry failure falls back to the previous pose and marks the
frame (check82.py:200-207). Tracking is "keyframe" (register against a
reference keyframe, promoted when overlap drops) or "frame_to_frame" (the
reference's check90.py / colorReco.py behavior).

On the card nothing in a frame's step reads the device from the host: the
accept / promote decisions are `torch.where` selects on 0-d tensors, the
trajectory is a list of device (4, 4) tensors, the inverses are
`torch.linalg.inv_ex` (no error check, no sync) and the volume is written
in place. The capture thread uploads each queue item from a fresh pinned
host buffer on its own stream and hands the fusion thread a CUDA event to
wait on, so the copy overlaps the fusion of earlier frames.

`integrate_saved_frames` re-integrates a saved scan: the same consumer on
the PNG frames of a directory, synchronously.
"""
from __future__ import annotations

import copy
import dataclasses
import queue
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from recon3d_tpu_torch.config import ScannerConfig
from recon3d_tpu_torch.fusion import marching as _marching
from recon3d_tpu_torch.fusion import tsdf as _tsdf
from recon3d_tpu_torch.mesh import ops as mops
from recon3d_tpu_torch.registration.odometry import compute_rgbd_odometry
from recon3d_tpu_torch.utils.logging import FPSCounter, make_logger
from recon3d_tpu_torch.utils.profiling import StageTimer
from recon3d_tpu_torch.utils.types import CameraIntrinsics, RGBDImage


class _TrackState(NamedTuple):
    """Device-resident tracking state: the odometry accept / promote
    decision runs on the device (selects, not host bool()), so the fusion
    consumer never waits for the device in a frame."""

    world_from_cam: torch.Tensor   # (4, 4) latest accepted pose
    world_from_key: torch.Tensor   # (4, 4) pose of the current keyframe
    rel_init: torch.Tensor         # (4, 4) cur_cam_from_key warm start
    key_color: torch.Tensor        # keyframe RGBD (same shapes as the stream)
    key_depth: torch.Tensor
    failures: torch.Tensor         # int32 scalar: odometry failures so far
    last_inliers: torch.Tensor     # float32 scalar: last frame's inlier fraction
    last_success: torch.Tensor     # bool scalar


class StreamingFusion:
    """start() spawns capture + fusion threads; stop() joins and returns.

    Mirrors check90.py run(): Queue(maxsize=10) between a scanning_loop and
    a processing_loop doing odometry + integrate per frame. The volume,
    tracking state and trajectory live on `device`.
    """

    def __init__(self, camera, intrinsics: CameraIntrinsics,
                 config: ScannerConfig = ScannerConfig(),
                 resolution: int = 256, volume_origin=None,
                 queue_size: int = 10, tracking: str = "keyframe",
                 keyframe_min_inliers: float = 0.85, profile: bool = False,
                 depth_filters=None, consume_batch="auto",
                 live_mesher: bool = False, device="cuda"):
        self.camera = camera
        self.intrinsics = intrinsics
        self.config = config
        self.device = torch.device(device)
        # u16-wire streaming: cameras exposing grab_raw() ship (u8 color,
        # u16 depth) and the step DIVIDES by this scale on the device (raw
        # units per meter, StreamConfig.depth_scale semantics). The camera's
        # own scale is trusted only when it has the raw path, and must be a
        # divisor (a meters-per-unit multiplier is refused).
        if hasattr(camera, "grab_raw"):
            self._depth_scale = float(getattr(camera, "depth_scale", 0.0) or 0.0)
            if not self._depth_scale > 1.0:
                raise ValueError("grab_raw cameras must expose depth_scale as raw units per "
                                 f"meter (a divisor, e.g. 1000); got {self._depth_scale!r}, "
                                 "which looks like a meters-per-unit multiplier")
        else:
            self._depth_scale = float(getattr(getattr(config, "stream", None), "depth_scale",
                                              None) or 1000.0)
        self.logger = make_logger("fusion", config.output_dir)
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.stop_event = threading.Event()
        cfg = config.fusion
        # volume_origin=None -> auto-fit: the origin is re-seated on the
        # first frame so the volume is centered on the scene in view (a
        # fixed default can mesh nothing when the scene is 2 m away)
        self._auto_origin = volume_origin is None
        origin = volume_origin or (-resolution * cfg.voxel_size / 2,
                                   -resolution * cfg.voxel_size / 2, 0.0)
        self.volume = _tsdf.make_volume(resolution=resolution, voxel_size=cfg.voxel_size,
                                        sdf_trunc=cfg.sdf_trunc, origin=origin,
                                        with_color=cfg.color, device=self.device)
        self.trajectory: List[torch.Tensor] = []  # (4, 4) device tensors, no sync a frame
        self.frames_integrated = 0
        self.frames_captured = 0  # enqueued by the producer (incl. in-flight)
        self._host_failures = 0  # exceptions in the fusion loop
        self._state: Optional[_TrackState] = None
        self._step = None  # the per-frame track + integrate step, built lazily
        # Backlog batching: the consumer drains up to _consume_batch queued
        # frames a round and the producer uploads that many as one stacked
        # copy. "auto" takes the largest power of two the queue holds; an
        # explicit int fixes it (1 disables batching). A batch runs the
        # per-frame step on each of its frames in turn (the JAX package
        # compiles one lax.scan program per batch size instead).
        if consume_batch == "auto":
            cap = 1
            while cap * 2 <= max(2, queue_size):
                cap *= 2
            self._consume_batch = cap
        else:
            self._consume_batch = max(1, int(consume_batch))
        self._max_frames: Optional[int] = None
        self._threads: List[threading.Thread] = []
        self._copy_stream = None  # the capture thread's upload stream (CUDA)
        # Keyframe tracking: register each frame against a reference
        # keyframe instead of the previous frame, so per-step odometry bias
        # stops accumulating while the keyframe stays good; the keyframe is
        # promoted when overlap (inlier fraction) drops. "frame_to_frame"
        # reproduces check90.py / colorReco.py (promote every frame).
        if tracking not in ("keyframe", "frame_to_frame"):
            raise ValueError(f"unknown tracking mode {tracking!r}")
        self._promote_below = (2.0 if tracking == "frame_to_frame"
                               else keyframe_min_inliers)
        # live_mesher: per-frame dirty-z-slab tracking rides the step (one
        # extra reduce over the integrate's change) and extract_mesh_live()
        # re-meshes only dirty slabs (fusion/incremental.py)
        self.mesher = None
        if live_mesher:
            from recon3d_tpu_torch.fusion.incremental import IncrementalMesher

            self.mesher = IncrementalMesher(resolution=resolution, device=self.device)
        # per-stage timing: "fuse_step" a step; profile=True also times the
        # step's stages (filters, odometry, track, integrate), each ending
        # in a device sync (without it the stages measure the enqueue)
        self.timer = StageTimer()
        self._profile = profile
        # optional depth conditioning chain applied before odometry, the
        # stand-in for the SDK filters a live RealSense applies on grab
        # (check90.py:99-103), e.g. depth.filters.DepthFilterBank
        self.depth_filters = depth_filters

    # ---- host -> device handoff ----------------------------------------
    def _upload(self, color: np.ndarray, depth: np.ndarray):
        """A queue item (color, depth, ready): on the card, each array goes
        through a fresh pinned host buffer and a non-blocking copy on the
        capture thread's stream, and `ready` is the event the fusion thread
        waits on; on the CPU, copies and None."""
        if self.device.type != "cuda":
            return torch.tensor(color), torch.tensor(depth), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            c = torch.from_numpy(np.ascontiguousarray(color)).pin_memory()
            d = torch.from_numpy(np.ascontiguousarray(depth)).pin_memory()
            c = c.to(self.device, non_blocking=True)
            d = d.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return c, d, ready

    def _ready(self, item):
        """(color, depth) of a queue item, usable on the current stream."""
        c, d, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            # the tensors were allocated on the copy stream: keep their
            # memory from being reused before this stream is done with them
            c.record_stream(stream)
            d.record_stream(stream)
        return c, d

    def _capture_loop(self):
        fps = FPSCounter(self.logger, "capture")
        queued = 0
        # Producer-side batching: grabs are grouped into the consumer's
        # batch size B and uploaded as ONE stacked (B, H, W, ...) copy per
        # stream. The first frame goes alone (the consumer's state-seeding
        # path), and end-of-stream remainders go one by one.
        B = max(1, self._consume_batch)
        pend: List = []

        def _enqueue(item, n):
            nonlocal queued
            try:
                self.queue.put(item, timeout=0.5)
                queued += n
                self.frames_captured += n
                for _ in range(n):
                    fps.tick()
            except queue.Full:
                pass  # drop under backpressure (bounded queue)

        # u16 wire format when the camera supports it
        grab = getattr(self.camera, "grab_raw", None) or self.camera.grab
        first = True
        while not self.stop_event.is_set():
            if self._max_frames is not None and queued + len(pend) >= self._max_frames:
                # stop grabbing at the cap; frames already queued still fuse
                # (the consumer drains before honoring stop_event)
                break
            try:
                frame = grab()
            except Exception:
                # a dying camera ends the stream instead of silently killing
                # this thread (check7.py retry / teardown); frames already
                # queued still get fused
                self.logger.exception("camera grab failed; stopping stream")
                break
            if frame is None:
                break
            color, depth = frame
            if first or B == 1:
                _enqueue(self._upload(color, depth), 1)
                first = False
                continue
            pend.append((color, depth))
            if len(pend) == B:
                _enqueue(self._upload(np.stack([c for c, _ in pend]),
                                      np.stack([d for _, d in pend])), B)
                pend = []
        for color, depth in pend:  # ragged tail: per-frame items
            _enqueue(self._upload(color, depth), 1)
        self.stop_event.set()

    def _fusion_loop(self):
        fps = FPSCounter(self.logger, "fuse")
        cfg = self.config.fusion
        while not (self.stop_event.is_set() and self.queue.empty()):
            try:
                items = [self.queue.get(timeout=0.5)]
            except queue.Empty:
                continue
            # drain whatever else is queued (up to the batch cap) and fuse
            # the backlog in frame order
            while len(items) < self._consume_batch:
                try:
                    items.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            n = sum(self._item_len(it) for it in items)
            try:
                self._fuse_items(items, cfg)
                for _ in range(n):
                    fps.tick()
            except Exception:  # keep the stream alive (check82-style)
                self._host_failures += 1
                self.logger.exception("fusion step failed; %d frame(s) dropped", n)

    @staticmethod
    def _item_len(item) -> int:
        """A queue item is one frame (color ndim 3) or a stacked batch."""
        return item[0].shape[0] if item[0].ndim == 4 else 1

    def _fuse_items(self, items, cfg):
        """Fuse a drained mix of per-frame items and pre-stacked producer
        batches, in frame order."""
        for item in items:
            c, d = self._ready(item)
            if c.ndim == 4:
                self._fuse_frames(list(zip(c, d)), cfg)
            else:
                self._fuse_one(c, d, cfg)

    # ---- attribute compatibility: these read the device on ACCESS
    # (end of run / tests), never on the per-frame consumer path
    @property
    def odometry_failures(self) -> int:
        dev = 0 if self._state is None else int(self._state.failures)
        return dev + self._host_failures

    @property
    def world_from_cam(self) -> np.ndarray:
        if self._state is None:
            return np.eye(4, dtype=np.float32)
        return self._state.world_from_cam.cpu().numpy()

    def _to_meters(self, depth: torch.Tensor) -> torch.Tensor:
        """u16 wire depth -> float32 meters on the device (a division by a
        0-d tensor: the same bits on the card and the host)."""
        if depth.dtype == torch.float32:
            return depth
        scale = torch.full((), self._depth_scale, dtype=torch.float32, device=depth.device)
        return depth.to(torch.float32) / scale

    def _make_step_fn(self, cfg, depth_filters=None, timed=True):
        """The per-frame consumer: depth filter -> odometry against the
        device-resident keyframe -> accept / promote selects (no host
        bool()) -> pose update -> TSDF integrate in place, so a frame
        allocates no new volume and never waits for the device. Run by
        _fuse_one (check90.py:188-226 consumer semantics). `depth_filters` stands in
        for self.depth_filters and timed=False leaves the stage timer out
        (warmup does both)."""
        intr = self.intrinsics
        promote_below = self._promote_below
        depth_filters = self.depth_filters if depth_filters is None else depth_filters
        with_color = cfg.color
        depth_trunc = cfg.depth_trunc
        mesher = self.mesher
        timer, profile = self.timer, self._profile and timed

        def stage(name, fn):
            # with profile=True a stage ends in a device sync so its wall
            # time covers its kernels; without it nothing is timed here
            if not profile:
                return fn()
            with timer.stage(name):
                out = fn()
                timer.sync(out)
            return out

        def step(volume, state: _TrackState, color, depth):
            depth = self._to_meters(depth)
            if depth_filters is not None:
                depth = stage("filters", lambda: depth_filters(depth))
            cur = RGBDImage(color=color, depth=depth)
            key = RGBDImage(color=state.key_color, depth=state.key_depth)
            # the trimmed Gauss-Newton schedule of the warm-started tracker:
            # each frame starts from the previous relative pose (the JAX
            # package measured the same pose error at (3, 7, 10) as at the
            # (10, 10, 10) default); cold-start callers keep the default
            res = stage("odometry", lambda: compute_rgbd_odometry(
                key, cur, intr, init=state.rel_init, iterations=(3, 7, 10)))

            def track():
                ok = res.success
                # success: cur_cam_from_key advances; failure: keep the last
                # pose and re-seat the keyframe so tracking recovers
                # (check82.py:200-207)
                cur_from_key = torch.where(ok, res.transformation, state.rel_init)
                wfc = torch.where(
                    ok, state.world_from_key @ torch.linalg.inv_ex(cur_from_key).inverse,
                    state.world_from_cam)
                promote = (~ok) | (res.inlier_fraction < promote_below)
                eye = torch.eye(4, dtype=torch.float32, device=wfc.device)
                return _TrackState(
                    world_from_cam=wfc,
                    world_from_key=torch.where(promote, wfc, state.world_from_key),
                    rel_init=torch.where(promote, eye, cur_from_key),
                    key_color=torch.where(promote, color, state.key_color),
                    key_depth=torch.where(promote, depth, state.key_depth),
                    failures=state.failures + (~ok).to(torch.int32),
                    last_inliers=res.inlier_fraction,
                    last_success=ok)

            new_state = stage("track", track)
            wfc = new_state.world_from_cam

            def integrate():
                extrinsic = torch.linalg.inv_ex(wfc).inverse
                use_color = color if with_color else None
                if mesher is None:
                    vol = _tsdf.integrate_donated(volume, depth, intr, extrinsic,
                                                  color=use_color, depth_trunc=depth_trunc)
                    return vol, torch.zeros((0,), dtype=torch.bool, device=wfc.device)
                vol, changed_z = _tsdf.integrate_donated(
                    volume, depth, intr, extrinsic, color=use_color, depth_trunc=depth_trunc,
                    with_changed_z=True, changed_weight_min=mesher.weight_min)
                return vol, mesher.dirty_hits(changed_z)

            new_volume, hits = stage("integrate", integrate)
            return new_volume, new_state, wfc, hits

        return step

    def _fuse_frames(self, frames, cfg):
        """Fuse a drained backlog of (color, depth) frames: the per-frame
        step on each in turn, so a backlog is the sequential _fuse_one
        calls."""
        for color, depth in frames:
            self._fuse_one(color, depth, cfg)

    def _fit_origin(self, depth: torch.Tensor, cfg):
        """Center the volume on the first frame's visible surface.

        Robust center = per-axis median of the backprojected valid-depth
        points (clipped at depth_trunc), in float64 on the host; origin =
        center - half-extent. One read of the depth at scan start, never on
        the per-frame path.
        """
        d = depth.cpu().numpy()
        m = (d > 0) & (d <= float(cfg.depth_trunc))
        if not m.any():
            return  # nothing visible: keep the configured default
        intr = self.intrinsics
        # the intrinsics and the voxel size as the float32 values the
        # JAX package and the volume hold
        fx, fy, cx, cy = (float(np.float32(v)) for v in (intr.fx, intr.fy, intr.cx, intr.cy))
        ys, xs = np.nonzero(m)
        z = d[ys, xs]
        pts = np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], -1)
        center = np.median(pts, axis=0)
        half = self.volume.resolution * float(np.float32(cfg.voxel_size)) / 2.0
        origin = torch.tensor(center - half, dtype=torch.float32, device=self.device)
        self.volume = dataclasses.replace(self.volume, origin=origin)
        self.logger.info("auto-fit volume origin to %s (scene median %s)",
                         np.round(center - half, 3), np.round(center, 3))

    def _first_frame(self, volume, color, depth, cfg, depth_filters):
        """Frame 0: filter, integrate at identity, seat the keyframe; returns
        (volume, state). The state's tensors are distinct buffers."""
        if depth_filters is not None:
            depth = depth_filters(depth)
        if volume is self.volume and self._auto_origin:
            self._fit_origin(depth, cfg)
            volume = self.volume
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        volume = _tsdf.integrate_donated(volume, depth, self.intrinsics, eye,
                                         color=color if cfg.color else None,
                                         depth_trunc=cfg.depth_trunc)
        state = _TrackState(
            world_from_cam=eye, world_from_key=eye.clone(), rel_init=eye.clone(),
            key_color=color, key_depth=depth,
            failures=torch.zeros((), dtype=torch.int32, device=self.device),
            last_inliers=torch.ones((), dtype=torch.float32, device=self.device),
            last_success=torch.ones((), dtype=torch.bool, device=self.device))
        return volume, state

    def _fuse_one(self, color, depth, cfg):
        color = torch.as_tensor(color, device=self.device)
        depth = self._to_meters(torch.as_tensor(depth, device=self.device))
        if self._state is None:
            self.volume, self._state = self._first_frame(self.volume, color, depth, cfg,
                                                         self.depth_filters)
            self.trajectory.append(self._state.world_from_cam)
        else:
            if self._step is None:
                self._step = self._make_step_fn(cfg)
            with self.timer.stage("fuse_step"):
                self.volume, self._state, wfc, hits = self._step(
                    self.volume, self._state, color, depth)
                self._mark_dirty(hits)
                if self._profile:
                    self.timer.sync(wfc)
                    if not bool(self._state.last_success):
                        self.logger.warning("odometry failed (inliers %.2f); reusing last pose",
                                            float(self._state.last_inliers))
            self.trajectory.append(wfc)
        self.frames_integrated += 1

    def warmup(self, color, depth) -> "StreamingFusion":
        """Build the kernel library and run the consumer's paths once before
        streaming starts: the first-frame path (depth filters + integrate at
        identity) and the per-frame step, on a scratch copy of the volume
        and a copy of the filter chain, with the sample frame as both
        keyframe and input. Without it the library's build lands in the
        first frames of the scan. The volume, the tracking state, the
        trajectory, the live mesher and the filters' state are untouched.
        """
        cfg = self.config.fusion
        if self.device.type == "cuda":
            from recon3d_tpu_torch import kernels

            kernels.load()
        # warm with the WIRE dtype the producer will ship: u16 when the
        # camera exposes grab_raw, float32 otherwise
        depth = np.asarray(depth.cpu() if torch.is_tensor(depth) else depth)
        if (self.camera is not None and hasattr(self.camera, "grab_raw")
                and depth.dtype != np.uint16):
            depth = np.clip(depth * self._depth_scale, 0, 65535).astype(np.uint16)
        color = torch.as_tensor(np.asarray(color.cpu() if torch.is_tensor(color) else color),
                                device=self.device)
        depth = torch.as_tensor(depth, device=self.device)
        filters = copy.deepcopy(self.depth_filters)
        v = self.volume
        vol = dataclasses.replace(v, tsdf=v.tsdf.clone(), weight=v.weight.clone(),
                                  color=None if v.color is None else v.color.clone())
        vol, state = self._first_frame(vol, color, self._to_meters(depth), cfg, filters)
        step = self._make_step_fn(cfg, depth_filters=filters, timed=False)
        vol, state, _, _ = step(vol, state, color, depth)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del vol, state
        return self

    def start(self, skip_frames: int = 0, max_frames: Optional[int] = None):
        """skip_frames discards that many grabs before queueing: how a
        restore_checkpoint'd REPLAY scan continues from where it left off
        instead of re-integrating frames 0..k against the restored keyframe
        (live cameras don't need it: their stream has moved on).

        max_frames caps how many frames the capture thread enqueues this
        run; everything enqueued still fuses, so the run integrates at most
        max_frames new frames.
        """
        self._max_frames = max_frames
        self.camera.open()
        for _ in range(skip_frames):
            if self.camera.grab() is None:
                break
        self.stop_event.clear()
        self._threads = [
            threading.Thread(target=self._capture_loop, daemon=True),
            threading.Thread(target=self._fusion_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self.stop_event.set()
        for t in self._threads:
            t.join(timeout=60.0)
        # deferred failure reporting: the consumer path never reads the
        # device, so the run's summary reads the failure counter once here
        nf = self.odometry_failures
        if nf:
            self.logger.warning("%d odometry failures over %d frames", nf,
                                self.frames_integrated)

    def _mark_dirty(self, hits):
        """OR a step's slab hits into the live mesher's dirty set: device
        tensors in, device OR, no read."""
        if self.mesher is not None and hits.shape[0]:
            self.mesher.cache = self.mesher.cache._replace(dirty=self.mesher.cache.dirty | hits)

    def extract_mesh(self):
        mesh = _marching.extract_triangle_mesh(self.volume)
        mesh = mops.cleanup(mesh)
        return mops.compute_vertex_normals(mesh)

    def extract_mesh_live(self):
        """Device-resident incremental re-mesh: refreshes only the z-slabs
        the integrates have dirtied since the last call (requires
        live_mesher=True); a live viewer can call it per displayed frame."""
        if self.mesher is None:
            raise RuntimeError("construct StreamingFusion(live_mesher=True) "
                               "for incremental extraction")
        return self.mesher.mesh_device(self.volume)

    # ---- crash-safe checkpoint / resume: one compressed NPZ holds the
    # volume, the tracking state and the trajectory (the JAX package's keys,
    # so either package resumes the other's scan)
    def save_checkpoint(self, path: str) -> str:
        """Snapshot volume + tracking state + trajectory. Call between frames
        (stopped, or from the fusion thread's cadence), not concurrently with
        an in-flight _fuse_one on another thread."""
        v = self.volume
        d = {
            "tsdf": v.tsdf.cpu().numpy(),
            "weight": v.weight.cpu().numpy(),
            "origin": v.origin.cpu().numpy(),
            "voxel_size": v.voxel_size.cpu().numpy(),
            "sdf_trunc": v.sdf_trunc.cpu().numpy(),
            "frames_integrated": np.int64(self.frames_integrated),
            "trajectory": (torch.stack(self.trajectory).cpu().numpy() if self.trajectory
                           else np.zeros((0, 4, 4), np.float32)),
        }
        if v.color is not None:
            d["color"] = v.color.cpu().numpy()
        if self._state is not None:
            for name, leaf in zip(_TrackState._fields, self._state):
                d[f"state_{name}"] = leaf.cpu().numpy()
        np.savez_compressed(path, **d)
        return path

    def restore_checkpoint(self, path: str) -> "StreamingFusion":
        """Restore a save_checkpoint snapshot (either package's) into this
        (fresh) instance; the next frame continues tracking against the
        restored keyframe."""
        self.volume = _tsdf.load_volume(path, device=self.device)
        with np.load(path) as d:
            self.frames_integrated = int(d["frames_integrated"])
            self.trajectory = list(torch.as_tensor(d["trajectory"], device=self.device))
            if "state_world_from_cam" in d:
                self._state = _TrackState(*(torch.as_tensor(d[f"state_{name}"],
                                                            device=self.device)
                                            for name in _TrackState._fields))
        return self


def integrate_saved_frames(directory: str, intrinsics: CameraIntrinsics,
                           config: ScannerConfig = ScannerConfig(),
                           resolution: int = 256, volume_origin=None,
                           max_frames: Optional[int] = None,
                           tracking: str = "keyframe",
                           depth_filters=None, device="cuda") -> StreamingFusion:
    """Offline re-integration of a saved scan (check90.py:408-463
    integrate_saved_frames): load every color / depth pair of `directory`
    (the native thread-pool decoder), run the live stream's odometry + TSDF
    consumer on each, synchronously with no threads, and return the fusion
    object (volume, trajectory, extract_mesh())."""
    from recon3d_tpu_torch.utils import io as _io

    frames = _io.load_rgbd_frames_batch(directory, depth_scale=config.stream.depth_scale,
                                        max_frames=max_frames)
    if not frames:
        raise FileNotFoundError(f"no color/depth pairs in {directory}")
    sf = StreamingFusion(None, intrinsics, config, resolution=resolution,
                         volume_origin=volume_origin, tracking=tracking,
                         depth_filters=depth_filters, device=device)
    cfg = config.fusion
    for color, depth in frames:
        sf._fuse_one(color, depth, cfg)
    return sf
