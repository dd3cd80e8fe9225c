"""Tkinter stereo-calibration GUI (twin of recon3d_tpu/calib/gui.py).

A display-gated interactive layer over the headless calibration core
(calib/api.py): a live side-by-side preview from two cameras, a capture
button that appends synchronized pairs, a calibrate button that runs the
full workflow (corners -> per-camera -> stereo -> rectify -> NPZ +
report), a save-images toggle and the load-from-folder batch mode.

`CalibrationSession` holds the state and the actions and needs no display
(tests drive it directly); `CalibrationGUI.run` builds the widgets and
imports tkinter only when called. The preview is handed to Tk as PPM data,
so no imaging library is needed.
"""
from __future__ import annotations

import glob
import os
import threading
from typing import List, Optional, Tuple

import numpy as np


class CalibrationSession:
    """Headless state + actions behind the GUI (and usable without it).
    The calibration runs on `device` (the card unless the caller asks for
    the CPU)."""

    def __init__(self, cam_left, cam_right, pattern_size=(9, 6),
                 square_size: float = 1.0, output_dir: str = ".",
                 name: str = "stereo_rig", save_images: bool = False, device="cuda"):
        self.cam_left = cam_left
        self.cam_right = cam_right
        self.pattern_size = pattern_size
        self.square_size = square_size
        self.output_dir = output_dir
        self.name = name
        self.save_images = save_images
        self.device = device
        self.pairs: List[Tuple[np.ndarray, np.ndarray]] = []
        self.status = "ready"

    def read_pair(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The current frame of each camera: read() -> (ok, frame) or a
        bare frame, or grab() -> frame; a frame may be a tuple whose first
        item is the image. None when either camera has no frame."""
        fl = (self.cam_left.read() if hasattr(self.cam_left, "read")
              else (True, self.cam_left.grab()))
        fr = (self.cam_right.read() if hasattr(self.cam_right, "read")
              else (True, self.cam_right.grab()))
        okl, left = fl if isinstance(fl, tuple) and len(fl) == 2 else (fl is not None, fl)
        okr, right = fr if isinstance(fr, tuple) and len(fr) == 2 else (fr is not None, fr)
        if not okl or not okr or left is None or right is None:
            return None
        left = left[0] if isinstance(left, tuple) else left
        right = right[0] if isinstance(right, tuple) else right
        return np.asarray(left), np.asarray(right)

    def capture_pair(self) -> bool:
        """Append the current synchronized frame pair (and save it as
        left_k.png / right_k.png when save_images is on)."""
        pair = self.read_pair()
        if pair is None:
            self.status = "no frame"
            return False
        self.pairs.append(pair)
        if self.save_images:
            from recon3d_tpu_torch.utils import io

            os.makedirs(self.output_dir, exist_ok=True)
            k = len(self.pairs) - 1
            io.write_color(os.path.join(self.output_dir, f"left_{k:03d}.png"),
                           np.ascontiguousarray(pair[0]))
            io.write_color(os.path.join(self.output_dir, f"right_{k:03d}.png"),
                           np.ascontiguousarray(pair[1]))
        self.status = f"{len(self.pairs)} pairs captured"
        return True

    def load_folder(self, folder: str) -> int:
        """Batch mode: append saved pairs from disk."""
        from recon3d_tpu_torch.utils import io

        lefts = sorted(glob.glob(os.path.join(folder, "left_*.png")))
        rights = sorted(glob.glob(os.path.join(folder, "right_*.png")))
        for pl, pr in zip(lefts, rights):
            self.pairs.append((io.read_color(pl), io.read_color(pr)))
        self.status = f"{len(self.pairs)} pairs (loaded {len(lefts)})"
        return len(lefts)

    def run_calibration(self):
        """The full workflow on the captured pairs; (None, None) with fewer
        than 3."""
        from recon3d_tpu_torch.calib.api import stereo_calibrate_camera

        if len(self.pairs) < 3:
            self.status = "need >= 3 pairs"
            return None, None
        self.status = "calibrating..."
        os.makedirs(self.output_dir, exist_ok=True)
        save = os.path.join(self.output_dir, f"{self.name}_stereo.npz")
        rep = os.path.join(self.output_dir, f"{self.name}_calibration_report.txt")
        params, info = stereo_calibrate_camera(
            [p[0] for p in self.pairs], [p[1] for p in self.pairs],
            pattern_size=self.pattern_size, square_size=self.square_size,
            save_path=save, report_path=rep, device=self.device)
        self.status = (f"done: rms L/R {info['rms_left']:.4f}/"
                       f"{info['rms_right']:.4f}, saved {save}")
        return params, info


def _ppm(img: np.ndarray) -> bytes:
    """An (H, W, 3) or (H, W) image as binary PPM data for tk.PhotoImage."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    rgb = np.ascontiguousarray(np.clip(img[..., :3], 0, 255).astype(np.uint8))
    return b"P6 %d %d 255\n" % (rgb.shape[1], rgb.shape[0]) + rgb.tobytes()


class CalibrationGUI:
    """Tk window wiring a CalibrationSession (requires a display)."""

    def __init__(self, session: CalibrationSession, preview_ms: int = 30):
        self.session = session
        self.preview_ms = preview_ms
        self._stop = threading.Event()

    def run(self) -> None:  # pragma: no cover - needs a display
        import tkinter as tk

        root = tk.Tk()
        root.title("recon3d_tpu_torch stereo calibration")
        label = tk.Label(root)
        label.pack()
        status = tk.StringVar(value=self.session.status)
        tk.Label(root, textvariable=status).pack()
        save_var = tk.BooleanVar(value=self.session.save_images)

        def on_save_toggle():
            self.session.save_images = bool(save_var.get())

        def on_capture():
            self.session.capture_pair()
            status.set(self.session.status)

        calibrating = threading.Event()

        def on_calibrate():
            if calibrating.is_set():
                return
            calibrating.set()
            status.set("calibrating...")

            def work():
                try:
                    self.session.run_calibration()
                finally:
                    # Tk is not thread-safe: update the status (and resume
                    # the preview) on the Tk thread
                    def done():
                        calibrating.clear()
                        status.set(self.session.status)

                    root.after(0, done)

            threading.Thread(target=work, daemon=True).start()

        def on_load():
            from tkinter import filedialog

            folder = filedialog.askdirectory()
            if folder:
                self.session.load_folder(folder)
                status.set(self.session.status)

        bar = tk.Frame(root)
        bar.pack()
        tk.Button(bar, text="Capture", command=on_capture).pack(side=tk.LEFT)
        tk.Button(bar, text="Calibrate", command=on_calibrate).pack(side=tk.LEFT)
        tk.Button(bar, text="Load folder", command=on_load).pack(side=tk.LEFT)
        tk.Checkbutton(bar, text="Save images", variable=save_var,
                       command=on_save_toggle).pack(side=tk.LEFT)
        tk.Button(bar, text="Quit", command=root.destroy).pack(side=tk.LEFT)

        def tick():
            if self._stop.is_set():
                root.destroy()
                return
            if calibrating.is_set():
                # pause the preview: the cameras are not read while the
                # calibration worker runs
                root.after(self.preview_ms, tick)
                return
            pair = self.session.read_pair()
            if pair is not None:
                img = tk.PhotoImage(data=_ppm(np.concatenate(pair, axis=1)))
                label.configure(image=img)
                label.image = img
            root.after(self.preview_ms, tick)

        tick()
        root.mainloop()
