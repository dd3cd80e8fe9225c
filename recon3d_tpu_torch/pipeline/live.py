"""Live display + interactive tuning: the depth4.py imshow loop equivalent
(twin of recon3d_tpu/pipeline/live.py).

The reference's real-time depth tools show the rectified view and the JET
disparity colormap in OpenCV windows and retune SGBM / WLS parameters from
the keyboard (depth4.py:278-365; Calib.py:97-131). This module is the thin
host-side twin: frames come from any DepthPipeline / StreamingScanner,
display goes through a Tk window (`TkWindow`, the frame handed over as PPM
data, as calib/gui.py does; no imaging library) when tkinter and a display
exist, and the keyboard handler maps to the same q/a/w/s/e/d/r/f
adjustments via config.adjust.

Headless machines (no tkinter, no display) still get the key-handling and
frame-sink machinery: pass a `sink` callable to capture frames instead of
showing them, which is also how the tests drive this without a screen.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

#: keyboard map, matching depth4.py:295-365 / Calib.py:97-131
KEY_HELP = {
    "q": "block size +2 (max 11)",
    "a": "block size -2 (min 3)",
    "w": "numDisparities +16 (max 256)",
    "s": "numDisparities -16 (min 16)",
    "e": "WLS lambda x2",
    "d": "WLS lambda /2",
    "r": "WLS sigma +0.25",
    "f": "WLS sigma -0.25",
    "\x1b": "quit (ESC)",
}


def _have_gui() -> bool:
    try:
        import tkinter  # noqa: F401
    except ImportError:
        return False
    return bool(os.environ.get("DISPLAY") or os.name == "nt")


def host_image(img) -> np.ndarray:
    """A frame (numpy or a tensor on any device) as a host numpy array."""
    if hasattr(img, "detach"):
        return img.detach().cpu().numpy()
    return np.asarray(img)


class TkWindow:
    """One Tk window showing RGB uint8 frames; key presses queue up for
    poll_key(). Needs tkinter and a display (imported here, on first use)."""

    def __init__(self, title: str, master=None):
        import tkinter as tk

        self._root = tk.Tk() if master is None else tk.Toplevel(master)
        self._root.title(title)
        self._label = tk.Label(self._root)
        self._label.pack()
        self._keys = deque()
        self._root.bind("<Key>", lambda e: self._keys.append(e.char))

    def show(self, rgb: np.ndarray) -> None:
        import tkinter as tk

        from recon3d_tpu_torch.calib.gui import _ppm

        img = tk.PhotoImage(master=self._root, data=_ppm(rgb))
        self._label.configure(image=img)
        self._label.image = img
        self._root.update()

    def poll_key(self) -> Optional[str]:
        self._root.update()
        return self._keys.popleft() if self._keys else None

    def close(self) -> None:
        try:
            self._root.destroy()
        except Exception:  # the user may have closed it already
            pass


class LiveDepthViewer:
    """Show disparity / depth frames and forward key presses to the pipeline.

    viewer = LiveDepthViewer(pipe)           # pipe: DepthPipeline
    viewer.run(cam_left, cam_right)          # blocks; ESC quits

    With no GUI available, pass sink=fn(name, image) to receive the frames
    (e.g. a recorder or a test probe); keys can be injected via handle_key.
    """

    def __init__(self, pipeline, sink: Optional[Callable] = None,
                 window: str = "recon3d depth"):
        self.pipeline = pipeline
        self.window = window
        self.sink = sink
        self.gui = sink is None and _have_gui()
        self.frames_shown = 0
        self.keys_handled = []
        self._windows: Dict[str, TkWindow] = {}

    def handle_key(self, key: str) -> bool:
        """Apply one tuning key; returns False when the key means quit."""
        if key == "\x1b":
            return False
        if key in KEY_HELP:
            self.pipeline.adjust(key)
            self.keys_handled.append(key)
        return True

    def show(self, name: str, img) -> None:
        arr = host_image(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * (255.0 if arr.max() <= 1.0 else 1.0), 0, 255).astype(np.uint8)
        if self.gui:
            if name not in self._windows:
                master = next(iter(self._windows.values()))._root if self._windows else None
                self._windows[name] = TkWindow(f"{self.window}:{name}", master)
            self._windows[name].show(arr)
        elif self.sink is not None:
            self.sink(name, arr)
        self.frames_shown += 1

    def run(self, camera_left, camera_right, max_frames: Optional[int] = None) -> int:
        """depth4.py main loop: process -> show -> poll keys (depth4.py:238-292)."""
        def on_frame(n, out):
            disp, depth, vis = out
            self.show("disparity", vis)
            if self.gui:
                for w in self._windows.values():
                    k = w.poll_key()
                    if k and not self.handle_key(k):
                        return False
            return True

        n = self.pipeline.run(camera_left, camera_right, max_frames=max_frames,
                              on_frame=on_frame)
        for w in reversed(list(self._windows.values())):
            w.close()
        self._windows.clear()
        return n
