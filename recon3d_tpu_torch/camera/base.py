"""Camera driver interface and the threaded latest-frame capture wrapper
(copy of recon3d_tpu/camera/base.py: numpy and threads, no device code).

The reference wraps every sensor in the same shape: open/start a background
thread that continuously grabs frames under a lock, `read()` returns a copy
of the latest frame (Calib_depth/Camera/jetsonCam.py:28-85). Camera I/O is
host-bound; the frames reach the card where a pipeline turns them into
tensors.
"""
from __future__ import annotations

import abc
import threading
import time
from typing import Optional, Tuple

import numpy as np


class Camera(abc.ABC):
    """Minimal synchronous frame source."""

    @abc.abstractmethod
    def open(self) -> None:
        """Acquire the device (reference: jetsonCam.py:28-40)."""

    @abc.abstractmethod
    def grab(self) -> Optional[Tuple[np.ndarray, ...]]:
        """Blocking single-frame grab; None on failure."""

    def close(self) -> None:  # pragma: no cover - trivial default
        pass

    # Failure recovery hook (reference: realsense_pipeline.py:25-31 hardware_reset)
    def reset(self) -> None:
        self.close()
        self.open()


class ThreadedCamera:
    """Background-thread capture of the latest frame.

    Mirrors jetsonCam.py:57-75: a daemon thread updates `_frame` under a
    lock; `read()` returns (ok, copy-of-latest). `max_retries`/`timeout_s`
    reproduce check7.py:108's retry-with-timeout capture.
    """

    def __init__(self, camera: Camera, max_retries: int = 3, timeout_s: float = 0.5):
        self._camera = camera
        self._lock = threading.Lock()
        self._frame: Optional[Tuple[np.ndarray, ...]] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._max_retries = max_retries
        self._timeout_s = timeout_s
        self.frames_grabbed = 0
        self.frames_dropped = 0

    def start(self) -> "ThreadedCamera":
        self._camera.open()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while self._running:
            frame = None
            for _ in range(self._max_retries):
                try:
                    frame = self._camera.grab()
                except Exception:
                    frame = None
                if frame is not None:
                    break
                time.sleep(self._timeout_s / self._max_retries)
            if frame is None:
                self.frames_dropped += 1
                continue
            with self._lock:
                self._frame = frame
                self.frames_grabbed += 1

    def read(self) -> Tuple[bool, Optional[Tuple[np.ndarray, ...]]]:
        """Latest-frame copy under lock (reference: jetsonCam.py:70-74)."""
        with self._lock:
            if self._frame is None:
                return False, None
            return True, tuple(np.copy(a) for a in self._frame)

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._camera.close()
