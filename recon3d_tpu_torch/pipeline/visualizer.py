"""Geometry visualization, headless first (twin of
recon3d_tpu/pipeline/visualizer.py).

Replaces the reference's Open3D / OpenGL GeometryVisualizer
(visualizer.py:5-127):
- GeometryVisualizer draws point clouds and meshes to PNG with matplotlib
  (imported on first use; the Agg backend when there is no display). A
  machine without matplotlib (the H100 machine has none) raises ImportError
  there; LiveVisualizer3D needs no plotting library.
- LiveVisualizer3D renders on the device (pipeline/render.py's point splat
  + z-buffer) with a keyboard trackball, shows frames in a Tk window
  (pipeline/live.py:TkWindow) when a display exists, and writes them with
  the native PNG codec (utils/native.py) instead of PIL.
- live_remesh_loop / scanning_loop_with_vis: the reference's live loops.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from recon3d_tpu_torch.mesh.ops import highlight_sparse_regions
from recon3d_tpu_torch.utils.types import PointCloud, TriangleMesh


class GeometryVisualizer:
    """initialize / update / capture / destroy lifecycle (visualizer.py:14-38)."""

    def __init__(self, width: int = 960, height: int = 720,
                 point_size: float = 0.5, elev: float = -70.0, azim: float = -90.0):
        self.width = width
        self.height = height
        self.point_size = point_size
        self.elev = elev
        self.azim = azim
        self._fig = None
        self._ax = None

    def initialize(self) -> None:
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("GeometryVisualizer draws with matplotlib, which is not "
                              "installed; LiveVisualizer3D renders without it") from e
        if not os.environ.get("DISPLAY"):
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._fig = plt.figure(figsize=(self.width / 100, self.height / 100), dpi=100)
        self._ax = self._fig.add_subplot(111, projection="3d")

    def _prep(self):
        if self._fig is None:
            self.initialize()
        self._ax.clear()
        self._ax.set_axis_off()
        self._ax.view_init(elev=self.elev, azim=self.azim)

    def update(self, geometry) -> None:
        """Re-render a PointCloud or TriangleMesh (update_geometry path)."""
        self._prep()
        if isinstance(geometry, PointCloud):
            pts, cols, _ = geometry.to_numpy()
            if len(pts) > 200_000:  # decimate for plotting speed
                step = len(pts) // 200_000 + 1
                pts = pts[::step]
                cols = None if cols is None else cols[::step]
            self._ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=self.point_size,
                             c=None if cols is None else np.clip(cols, 0, 1))
        elif isinstance(geometry, TriangleMesh):
            verts, tris, cols, _ = geometry.to_numpy()
            from mpl_toolkits.mplot3d.art3d import Poly3DCollection

            coll = Poly3DCollection(verts[tris], linewidths=0.0)
            if cols is not None:
                coll.set_facecolor(np.clip(cols[tris].mean(axis=1), 0, 1))
            self._ax.add_collection3d(coll)
            lo, hi = verts.min(0), verts.max(0)
            self._ax.set_xlim(lo[0], hi[0])
            self._ax.set_ylim(lo[1], hi[1])
            self._ax.set_zlim(lo[2], hi[2])
        else:
            raise TypeError(f"cannot visualize {type(geometry)}")

    def highlight_sparse(self, mesh: TriangleMesh, densities, quantile: float = 0.01) -> None:
        """Sparse-region highlighting (visualizer.py:41-57): low-density
        vertices painted red, then rendered."""
        self.update(highlight_sparse_regions(mesh, densities, quantile))

    def capture(self, path: str) -> str:
        """Save the current view to PNG (the headless 'window')."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fig.savefig(path, bbox_inches="tight")
        return path

    def destroy(self) -> None:
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
            self._fig = None
            self._ax = None


class LiveVisualizer3D:
    """Interactive live 3D window (visualizer.py:14-38 parity without GL).

    Frames are rendered on the device (pipeline/render.py) and shown in a Tk
    window with a keyboard orbit: a/d azimuth, w/s elevation, q/e zoom, r
    reset, ESC close. With no display (or offscreen=True) the window is
    skipped and `frame` holds the latest rendered image; the same
    initialize / update / capture / destroy lifecycle either way.
    """

    WINDOW = "recon3d_tpu_torch 3D"

    def __init__(self, width: int = 960, height: int = 720,
                 focal: Optional[float] = None, offscreen: Optional[bool] = None,
                 azim: float = 0.0, elev: float = -20.0,
                 distance: Optional[float] = None):
        self.width = width
        self.height = height
        self.focal = focal if focal is not None else 0.9 * width
        self.offscreen = not os.environ.get("DISPLAY") if offscreen is None else offscreen
        self._azim0, self._elev0, self._dist0 = azim, elev, distance
        self.azim, self.elev, self.distance = azim, elev, distance
        self.target: Optional[np.ndarray] = None
        self.frame: Optional[np.ndarray] = None
        self._open = False
        self._window = None

    def initialize(self) -> None:
        if not self.offscreen:  # pragma: no cover - needs a display
            from recon3d_tpu_torch.pipeline.live import TkWindow

            try:
                self._window = TkWindow(self.WINDOW)
            except Exception:  # no usable Tk display after all: render offscreen
                self.offscreen = True
        self._open = True

    def _fit(self, pts: np.ndarray) -> None:
        if self.target is None:
            self.target = pts.mean(0)
        if self.distance is None:
            extent = float(np.linalg.norm(pts.max(0) - pts.min(0)) + 1e-6)
            self.distance = 1.6 * extent

    def update(self, geometry) -> bool:
        """Render + present one frame. Returns False once the window was
        closed (ESC), mirroring Visualizer.poll_events()."""
        from recon3d_tpu_torch.pipeline.render import orbit_view, render_points

        if not self._open:
            self.initialize()
        if isinstance(geometry, PointCloud):
            pts_d, valid, cols = geometry.points, geometry.valid, geometry.colors
        elif isinstance(geometry, TriangleMesh):
            pts_d, valid, cols = geometry.vertices, geometry.vertex_valid, geometry.vertex_colors
        else:
            raise TypeError(f"cannot visualize {type(geometry)}")
        # auto-fit copies the cloud to the host only while the camera is
        # unset (first frame / after 'r' reset)
        if self.target is None or self.distance is None:
            pts = pts_d.cpu().numpy()[valid.cpu().numpy()]
            if len(pts) == 0:
                return self._open
            self._fit(pts)
        if cols is None:
            cols = torch.full((pts_d.shape[0], 3), 0.75, dtype=torch.float32,
                              device=pts_d.device)
        view = torch.as_tensor(orbit_view(self.target, self.distance, self.azim, self.elev))
        img = render_points(pts_d, cols, valid, view.to(pts_d.device), self.focal,
                            height=self.height, width=self.width)
        self.frame = np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        if self._window is not None:  # pragma: no cover - needs a display
            self._window.show(self.frame)
            key = self._window.poll_key()
            if key:
                self.handle_key(ord(key))
        return self._open

    def handle_key(self, key: int) -> None:
        """Keyboard trackball (also drivable headless, for tests)."""
        if key in (27,):  # ESC
            self.destroy()
        elif key == ord("a"):
            self.azim -= 10.0
        elif key == ord("d"):
            self.azim += 10.0
        elif key == ord("w"):
            self.elev = max(self.elev - 10.0, -89.0)
        elif key == ord("s"):
            self.elev = min(self.elev + 10.0, 89.0)
        elif key == ord("q") and self.distance:
            self.distance *= 1.2
        elif key == ord("e") and self.distance:
            self.distance /= 1.2
        elif key == ord("r"):
            self.azim, self.elev = self._azim0, self._elev0
            self.distance, self.target = self._dist0, None

    def capture(self, path: str) -> str:
        """Write the latest frame as an RGB PNG (the native codec)."""
        from recon3d_tpu_torch.utils import native

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        native.png_write(path, self.frame)
        return path

    def destroy(self) -> None:
        if self._window is not None:  # pragma: no cover - needs a display
            self._window.close()
            self._window = None
        self._open = False


def live_remesh_loop(scanner, visualizer, frames: int, remesh_every: int = 1,
                     poisson_depth: int = 5):
    """The reference's full live loop (visualizer.py:71-127): scan, and on
    every `remesh_every` new frames re-estimate normals, re-run Poisson on
    the accumulated cloud and push the mesh to the live window. Returns the
    meshes rendered (most recent last)."""
    from recon3d_tpu_torch.mesh_reconstruction import MeshReconstruction
    from recon3d_tpu_torch.normal_estimation import NormalEstimation

    normals = NormalEstimation(scanner.config.processing)
    recon = MeshReconstruction(dataclasses.replace(scanner.config.mesh,
                                                   poisson_depth=poisson_depth))
    scanner.start(max_frames=frames)
    meshes = []
    last = 0
    while scanner._thread.is_alive() or scanner.frames > last:
        if scanner.combined is None or scanner.frames < last + remesh_every:
            if not scanner._thread.is_alive():
                break
            time.sleep(0.1)
            continue
        last = scanner.frames
        pc = normals.estimate_normals(scanner.combined)
        mesh, densities = recon.reconstruct_mesh(pc)
        meshes.append(mesh)
        if not visualizer.update(mesh):
            break  # window closed -> stop like the reference loop
    scanner.stop()
    return meshes


def scanning_loop_with_vis(scanner, visualizer: GeometryVisualizer, frames: int,
                           snapshot_every: int = 10, out_dir: str = "vis"):
    """The reference's live-vis scan loop (visualizer.py:71-127): run the
    scanner, periodically re-render the accumulated cloud to PNG frames."""
    scanner.start(max_frames=frames)
    shots = []
    last = 0
    while scanner._thread.is_alive():
        time.sleep(0.2)
        if scanner.combined is not None and scanner.frames >= last + snapshot_every:
            last = scanner.frames
            visualizer.update(scanner.combined)
            shots.append(visualizer.capture(os.path.join(out_dir,
                                                         f"scan_{scanner.frames:04d}.png")))
    scanner.stop()
    return shots
