"""Android IP-Webcam HTTP camera (host-side copy of
recon3d_tpu/camera/ipcam.py; reference: Calib_depth/Camera/IPCam.py:14-182).

Covers the reference's control surface: the /shot.jpg still grab,
zoom / quality / exposure / ISO / shutter / focus / flash endpoints, the
front / rear switch and the sensor-data query, over urllib. The JPEG is
decoded with PIL (Pillow), imported in grab(): a machine without it can
still drive the control endpoints.
"""
from __future__ import annotations

import io
import json
import urllib.request
from typing import Optional, Tuple

import numpy as np

from recon3d_tpu_torch.camera.base import Camera


class IPCamera(Camera):
    def __init__(self, url: str, timeout: float = 2.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def open(self) -> None:
        pass  # stateless HTTP

    def _get(self, path: str) -> bytes:
        with urllib.request.urlopen(f"{self.url}{path}", timeout=self.timeout) as r:
            return r.read()

    def grab(self) -> Optional[Tuple[np.ndarray]]:
        """Single JPEG still via /shot.jpg (IPCam.py uses the same endpoint),
        as (uint8 (H, W, 3) RGB,)."""
        data = self._get("/shot.jpg")
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("IPCamera.grab decodes the camera's JPEG with PIL (Pillow), "
                              "which is not installed") from e
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        return (img,)

    # --- control endpoints (reference: IPCam.py:43-170) ---
    def set_quality(self, q: int) -> None:
        self._get(f"/settings/quality?set={int(q)}")

    def set_zoom(self, z: int) -> None:
        self._get(f"/ptz?zoom={int(z)}")

    def set_exposure(self, ev: int) -> None:
        self._get(f"/settings/exposure?set={int(ev)}")

    def set_iso(self, iso: int) -> None:
        self._get(f"/settings/iso?set={int(iso)}")

    def set_shutter(self, s: float) -> None:
        self._get(f"/settings/shutter?set={s}")

    def set_focus_distance(self, d: float) -> None:
        self._get(f"/settings/focus_distance?set={d}")

    def set_flash(self, on: bool) -> None:
        self._get("/enabletorch" if on else "/disabletorch")

    def switch_camera(self, front: bool) -> None:
        self._get(f"/settings/ffc?set={'on' if front else 'off'}")

    def sensor_data(self) -> dict:
        return json.loads(self._get("/sensors.json").decode())
