"""Jetson CSI and V4L2 USB cameras through a GStreamer subprocess (twin of
recon3d_tpu/camera/jetson.py, which reads the same pipelines through
OpenCV's GStreamer build; this package imports no OpenCV).

The capture is `gst-launch-1.0 -q <pipeline> ! fdsink fd=1`: the pipeline
ends in raw BGR frames of a fixed size, written back to back to the
process's standard output, and grab() reads one frame's H x W x 3 bytes.
Needs GStreamer's `gst-launch-1.0` on PATH (with nvarguscamerasrc on a
Jetson for the CSI camera, v4l2src for a USB one). Wrap in ThreadedCamera
for the background latest-frame loop (jetsonCam.py:57-75 equivalent).
"""
from __future__ import annotations

import shlex
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from recon3d_tpu_torch.camera.base import Camera


def gstreamer_pipeline(sensor_id=0, capture_width=1920, capture_height=1080,
                       display_width=960, display_height=540,
                       framerate=30, flip_method=0) -> str:
    """nvargus CSI source string (reference: jetsonCam.py:89-117)."""
    return (
        f"nvarguscamerasrc sensor-id={sensor_id} ! "
        f"video/x-raw(memory:NVMM), width=(int){capture_width}, "
        f"height=(int){capture_height}, framerate=(fraction){framerate}/1 ! "
        f"nvvidconv flip-method={flip_method} ! "
        f"video/x-raw, width=(int){display_width}, height=(int){display_height}, "
        f"format=(string)BGRx ! videoconvert ! "
        f"video/x-raw, format=(string)BGR ! appsink"
    )


def usb_pipeline(index: int = 0, width: int = 640, height: int = 480) -> str:
    """V4L2 source string with fixed BGR caps (the frame size must be known
    to split the byte stream into frames)."""
    return (f"v4l2src device=/dev/video{index} ! videoconvert ! videoscale ! "
            f"video/x-raw, format=(string)BGR, width=(int){width}, height=(int){height} ! "
            f"appsink")


class _GstCapture(Camera):
    """A pipeline ending in `appsink`, run with the sink replaced by
    `fdsink fd=1`; frames are (height, width, 3) uint8 BGR."""

    def __init__(self, pipeline: str, width: int, height: int, what: str):
        self.pipeline = pipeline
        self.width, self.height = int(width), int(height)
        self._what = what
        self._proc: Optional[subprocess.Popen] = None
        self._pending: Optional[np.ndarray] = None
        self._err = None

    def command(self) -> list:
        """The gst-launch-1.0 argument list (without the executable)."""
        head, sink = self.pipeline.rsplit("!", 1)
        if sink.strip() != "appsink":
            raise ValueError(f"the pipeline must end in appsink: {self.pipeline}")
        return ["-q", *shlex.split(head), "!", "fdsink", "fd=1"]

    def _read_frame(self) -> Optional[np.ndarray]:
        n = self.height * self.width * 3
        buf = bytearray()
        while len(buf) < n:
            chunk = self._proc.stdout.read(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return np.frombuffer(bytes(buf), np.uint8).reshape(self.height, self.width, 3)

    def open(self) -> None:
        exe = shutil.which("gst-launch-1.0")
        if exe is None:
            raise RuntimeError(f"failed to open {self._what}: gst-launch-1.0 not found on PATH "
                               f"({self.pipeline})")
        # stderr to a file: a full pipe nobody reads would stall the stream
        self._err = tempfile.TemporaryFile()
        self._proc = subprocess.Popen([exe, *self.command()], stdout=subprocess.PIPE,
                                      stderr=self._err, stdin=subprocess.DEVNULL)
        # the first frame proves the pipeline runs (cv2's isOpened())
        self._pending = self._read_frame()
        if self._pending is None:
            err = self._stop()
            raise RuntimeError(f"failed to open {self._what}: gst-launch-1.0 ended "
                               f"({err.strip()!r}; {self.pipeline})")

    def grab(self) -> Optional[Tuple[np.ndarray]]:
        if self._proc is None:
            return None
        frame, self._pending = self._pending, None
        if frame is None:
            frame = self._read_frame()
        return (frame,) if frame is not None else None

    def _stop(self) -> str:
        """End the process; returns what it wrote to its standard error."""
        proc, self._proc, self._pending = self._proc, None, None
        if proc is None:
            return ""
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        with self._err:
            self._err.seek(0)
            return self._err.read().decode(errors="replace")

    def close(self) -> None:
        self._stop()


class JetsonCSICamera(_GstCapture):
    def __init__(self, sensor_id=0, capture_width=1920, capture_height=1080,
                 display_width=960, display_height=540, framerate=30, flip_method=0):
        super().__init__(gstreamer_pipeline(sensor_id, capture_width, capture_height,
                                            display_width, display_height, framerate,
                                            flip_method),
                         display_width, display_height, "CSI camera")


class USBCamera(_GstCapture):
    """Plain V4L2 camera (reference: Calib_depth/test.py:4-22 smoke path).
    width / height fix the frame size of the BGR caps (OpenCV takes the
    device's own default size)."""

    def __init__(self, index: int = 0, width: int = 640, height: int = 480):
        self.index = index
        super().__init__(usb_pipeline(index, width, height), width, height,
                         f"camera index {index}")
