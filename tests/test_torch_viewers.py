"""Port parity: the viewers (pipeline/render.py, pipeline/live.py,
pipeline/visualizer.py), recon3d_tpu_torch against the JAX package on the
CPU, headless.

render_points is held bitwise to the JAX renderer on clouds with exact ties
(duplicated points of other colors) and near ties (z an ulp or two apart,
within the (1 + 1e-6) win band): the pixel's color is the last winning
update in (splat offset, point index) order, as XLA's CPU scatter applies
them. orbit_view, LiveVisualizer3D's frames and KEY_HELP are equal to the
JAX package's; LiveDepthViewer runs JAX's headless flow; live_remesh_loop's
mesh equals the port's own normals + Poisson on the scanned cloud.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.pipeline import live as jlive
from recon3d_tpu.pipeline import render as jrender
from recon3d_tpu.pipeline.visualizer import LiveVisualizer3D as JLiveVisualizer3D
from recon3d_tpu.utils.types import PointCloud as JPointCloud
from recon3d_tpu_torch import config
from recon3d_tpu_torch.pipeline import live, render, visualizer
from recon3d_tpu_torch.utils import native
from recon3d_tpu_torch.utils.types import PointCloud


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """2 torch threads: the suite runs six workers on a shared host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tied_cloud(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * 0.1 + [0, 0, 1.0]).astype(np.float32)
    pts[n // 3:n // 2] = pts[:n // 6]  # exact ties
    pts[n // 2:2 * n // 3] = pts[n // 6:n // 3] * np.float32(1 + 3e-7)  # near ties
    return pts, rng.rand(n, 3).astype(np.float32), rng.rand(n) > 0.1


def _render_both(pts, cols, valid, view, splat, H=96, W=128):
    pts, cols, valid = map(np.ascontiguousarray, (pts, cols, valid))
    a = np.asarray(jrender.render_points(jnp.asarray(pts), jnp.asarray(cols),
                                         jnp.asarray(valid), jnp.asarray(view), 120.0,
                                         height=H, width=W, splat=splat))
    b = render.render_points(torch.tensor(pts), torch.tensor(cols), torch.tensor(valid),
                             torch.tensor(view), 120.0, height=H, width=W, splat=splat)
    return a, b.numpy()


@pytest.mark.parametrize("splat", [1, 2, 3])
@pytest.mark.parametrize("azim,elev,dist", [(0, 0, 1.0), (30, -20, 0.8), (200, 40, 1.5)])
def test_render_points_is_bitwise_with_ties(azim, elev, dist, splat):
    pts, cols, valid = _tied_cloud()
    view = jrender.orbit_view(pts.mean(0), dist, azim, elev)
    np.testing.assert_array_equal(render.orbit_view(pts.mean(0), dist, azim, elev), view)
    a, b = _render_both(pts, cols, valid, view, splat)
    np.testing.assert_array_equal(b, a)
    # the ties decide pixels: the same points in the opposite order color
    # the image otherwise (in both packages alike)
    r = slice(None, None, -1)
    a_r, b_r = _render_both(pts[r], cols[r], valid[r], view, splat)
    np.testing.assert_array_equal(b_r, a_r)
    assert (b_r != b).any()


def test_render_edge_cases():
    """Gray 1-D colors, a masked cloud, points behind the camera and far off
    the image (saturating pixel casts) and an empty cloud."""
    pts = np.array([[0, 0, 1.0], [0, 0, -1.0], [1e4, 0, 1e-3], [-3e9, 2e9, 1.0],
                    [0.01, 0.0, 2.0]], np.float32)
    gray = np.array([0.9, 0.5, 0.7, 0.3, 0.2], np.float32)
    valid = np.array([True, True, True, True, False])
    a, b = _render_both(pts, gray, valid, np.eye(4, dtype=np.float32), 2, 32, 32)
    np.testing.assert_array_equal(b, a)
    empty = render.render_points(torch.zeros((0, 3)), torch.zeros((0, 3)),
                                 torch.zeros((0,), dtype=torch.bool), torch.eye(4), 100.0,
                                 height=8, width=8)
    assert torch.equal(empty, torch.full((8, 8, 3), np.float32(0.08)))


def test_live_visualizer_frames_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    pts = (rng.randn(500, 3) * 0.1 + [0, 0, 1.0]).astype(np.float32)
    cols = rng.rand(500, 3).astype(np.float32)
    jv = JLiveVisualizer3D(width=160, height=120, offscreen=True)
    tv = visualizer.LiveVisualizer3D(width=160, height=120, offscreen=True)
    jpc = JPointCloud.from_numpy(pts, colors=cols)
    tpc = PointCloud.from_numpy(pts, colors=cols, device="cpu")
    for key in (None, ord("d"), ord("e"), ord("w"), ord("r")):
        if key is not None:
            jv.handle_key(key)
            tv.handle_key(key)
        assert jv.update(jpc) and tv.update(tpc)
        np.testing.assert_array_equal(tv.frame, jv.frame)
        assert (tv.azim, tv.elev, tv.distance) == (jv.azim, jv.elev, jv.distance)
    assert tv.frame.shape == (120, 160, 3) and tv.frame.max() > 30
    p = tv.capture(str(tmp_path / "v" / "frame.png"))
    np.testing.assert_array_equal(native.png_read(p), tv.frame)
    # no colors: a uniform gray cloud in both
    tv.update(PointCloud.from_numpy(pts, device="cpu"))
    jv.update(JPointCloud.from_numpy(pts))
    np.testing.assert_array_equal(tv.frame, jv.frame)
    tv.handle_key(27)  # ESC closes
    assert not tv._open


class _FakePipe:
    """tests/test_pipelines.py:307-323's stand-in DepthPipeline."""

    def __init__(self):
        self.matcher_config = config.StereoMatcherConfig()
        self.wls_config = config.WLSConfig()

    def adjust(self, key):
        self.matcher_config = self.matcher_config.adjust(key)
        self.wls_config = self.wls_config.adjust(key)

    def run(self, cl, cr, max_frames=None, on_frame=None):
        n = 0
        while n < (max_frames or 3):
            out = (torch.zeros((8, 8)), torch.zeros((8, 8)), torch.rand((8, 8, 3)))
            n += 1
            if on_frame is not None and on_frame(n, out) is False:
                break
        return n


def test_live_depth_viewer_headless_sink_and_key_tuning():
    assert live.KEY_HELP == jlive.KEY_HELP
    frames = []
    v = live.LiveDepthViewer(_FakePipe(), sink=lambda nm, im: frames.append((nm, im)))
    assert not v.gui
    assert v.run(None, None, max_frames=3) == 3
    assert [nm for nm, _ in frames] == ["disparity"] * 3
    assert all(im.dtype == np.uint8 and im.shape == (8, 8, 3) for _, im in frames)
    assert v.handle_key("w")
    assert v.pipeline.matcher_config.num_disparities == 144
    assert v.handle_key("e")
    assert v.pipeline.wls_config.lam == 16000.0
    assert v.handle_key("\x1b") is False
    assert v.keys_handled == ["w", "e"] and v.frames_shown == 3


def test_headless_without_tk_or_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert not live._have_gui()
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setitem(sys.modules, "tkinter", None)
    assert not live._have_gui()
    assert not live.LiveDepthViewer(_FakePipe()).gui


def test_geometry_visualizer_png_and_missing_matplotlib(tmp_path, monkeypatch):
    from recon3d_tpu_torch.fusion import marching
    from recon3d_tpu_torch.fusion.tsdf import integrate, make_volume
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    rng = np.random.RandomState(0)
    pc = PointCloud.from_numpy(rng.randn(500, 3).astype(np.float32),
                               colors=rng.rand(500, 3).astype(np.float32), device="cpu")
    vis = visualizer.GeometryVisualizer(width=320, height=240)
    vis.update(pc)
    assert os.path.getsize(vis.capture(str(tmp_path / "cloud.png"))) > 1000
    vol = make_volume(32, voxel_size=0.04, sdf_trunc=0.12, origin=(-0.64, -0.64, 0.5),
                      device="cpu")
    vol = integrate(vol, torch.full((40, 48), 1.0), CameraIntrinsics(40.0, 40.0, 23.5, 19.5),
                    torch.eye(4), color=torch.full((40, 48, 3), 128, dtype=torch.uint8))
    mesh = marching.extract_triangle_mesh(vol)
    vis.highlight_sparse(mesh, torch.rand(mesh.vertices.shape[0]))
    assert os.path.getsize(vis.capture(str(tmp_path / "mesh.png"))) > 1000
    vis.destroy()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        visualizer.GeometryVisualizer().update(pc)


def test_scanning_loop_with_vis_snapshots(tmp_path):
    """The loop re-renders the accumulated cloud each snapshot_every frames
    while the scan thread runs (a stand-in scanner, deterministic)."""
    class Thread:
        def __init__(self, sc):
            self.sc = sc

        def is_alive(self):
            self.sc.frames += 1
            return self.sc.frames <= 4

    class Scanner:
        frames = 0
        combined = PointCloud.from_numpy(np.random.RandomState(0).randn(64, 3).astype(
            np.float32), device="cpu")

        def start(self, max_frames):
            self._thread = Thread(self)

        def stop(self):
            self.stopped = True

    class Vis:
        def update(self, g):
            self.g = g

        def capture(self, path):
            return path

    sc = Scanner()
    shots = visualizer.scanning_loop_with_vis(sc, Vis(), frames=4, snapshot_every=2,
                                              out_dir=str(tmp_path))
    assert shots == [str(tmp_path / "scan_0002.png"), str(tmp_path / "scan_0004.png")]
    assert sc.stopped


def test_live_remesh_loop(tmp_path):
    """The full visualizer.py:71-127 loop on a 2-frame scan: the last mesh is
    the port's normals + Poisson of the scanned cloud, rendered."""
    import dataclasses

    from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
    from recon3d_tpu_torch.mesh_reconstruction import MeshReconstruction
    from recon3d_tpu_torch.normal_estimation import NormalEstimation
    from recon3d_tpu_torch.pipeline.scanner import StreamingScanner
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    from .test_torch_offline import _small_cfg

    cfg = _small_cfg(config, tmp_path)
    cfg = dataclasses.replace(cfg, save_frames=False, registration=dataclasses.replace(
        cfg.registration, icp_max_iterations=10))
    cam = SyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, n_frames=2, step=0.005)
    sc = StreamingScanner(cam, CameraIntrinsics(130.0, 130.0, 79.5, 59.5), cfg, device="cpu")
    vis = visualizer.LiveVisualizer3D(width=160, height=120, offscreen=True)
    meshes = visualizer.live_remesh_loop(sc, vis, frames=2, remesh_every=2, poisson_depth=4)
    assert len(meshes) == 1 and sc.frames == 2
    v, t, _, _ = meshes[-1].to_numpy()
    assert len(t) > 50 and vis.frame is not None and vis.frame.max() > 0
    want, _ = MeshReconstruction(dataclasses.replace(cfg.mesh, poisson_depth=4)).reconstruct_mesh(
        NormalEstimation(cfg.processing).estimate_normals(sc.combined))
    for f in dataclasses.fields(want):
        a, b = getattr(meshes[-1], f.name), getattr(want, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
