"""Logger and FPS counter (twin of recon3d_tpu/utils/logging.py:
`make_logger`, `FPSCounter`)."""
from __future__ import annotations

import logging
import os
import time
from typing import Optional


def make_logger(name: str = "recon3d", output_dir: Optional[str] = None) -> logging.Logger:
    """stdout + optional <output_dir>/scanner.log."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "scanner.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class FPSCounter:
    """Per-second FPS logging.

    Consumers tick() when a call returns; PyTorch's CUDA calls return before
    the card has finished, so the logged rate is the dispatch rate unless
    the caller synchronises. It is a liveness signal, not a throughput
    measurement.
    """

    def __init__(self, logger: Optional[logging.Logger] = None, label: str = "scan"):
        self.logger = logger
        self.label = label
        self._count = 0
        self._t0 = time.perf_counter()
        self.last_fps = 0.0
        self.total_frames = 0

    def tick(self, n: int = 1) -> Optional[float]:
        """Count a frame; returns fps once per elapsed second, else None."""
        self._count += n
        self.total_frames += n
        dt = time.perf_counter() - self._t0
        if dt >= 1.0:
            self.last_fps = self._count / dt
            self._count = 0
            self._t0 = time.perf_counter()
            if self.logger:
                self.logger.info("%s fps: %.2f", self.label, self.last_fps)
            return self.last_fps
        return None
