"""Port parity for the whole point-cloud slice: an RGBD frame ->
pointcloud_from_rgbd -> PointCloudProcessing (voxel 0.0025, compact,
statistical and radius outliers) -> estimate_normals on the grid path
(K7 + K8, their plain versions on CPU tensors) -> orient_normals_consistent
(k = 10, 100 sweeps), recon3d_tpu_torch against the JAX package on the CPU.

The frame is frame 0 of a SyntheticRGBDCamera 192 x 176 window at the
camera's 525 px focal length with the principal point left of the image:
33792 points (above the 32768 switch) as dense as a 640 x 480 frame's, on
the sphere's limb and the plane z = 1.8 behind it. Normals at radius 0.03,
cell capacity 16 on a 32-cell grid (0.96 m): the JAX package's XLA route
materializes (C, C, G^3) intermediates, and at the defaults (radius 0.05,
C = 8) a cell keeps its first 8 points in index order, pixels of one image
row, whose covariance has no defined normal (PERF.md).
Bars: the cloud bitwise; processing masks equal, points and colors rtol
1e-6 / atol 1e-6; oriented normals signed dot > 0.999 on at least 99 % of
the points with at least 5 neighbors; on the plane, at least 95 % of those
within 5 degrees of the z axis.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu import pointcloud_processing as jpp
from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.ops import grid_knn as jgk
from recon3d_tpu.pointcloud import backproject as jbp
from recon3d_tpu.pointcloud import normals as jn
from recon3d_tpu.utils import types as jtypes
from recon3d_tpu_torch import pointcloud_processing
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.pointcloud import backproject
from recon3d_tpu_torch.pointcloud import normals as tn
from recon3d_tpu_torch.utils import types


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this module's k-NN tiles: several test
    workers share one host, and more threads a worker oversubscribe its
    cores (each op's fork / join then waits on descheduled threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


SLICE = dict(W=192, H=176, cx=-40.0, radius=0.03, grid_size=32, cell_capacity=16)


def _frame(W, H, cx):
    j, t = (cls(W, H, cx=cx) for cls in (JSyntheticRGBDCamera, SyntheticRGBDCamera))
    for cam in (j, t):
        cam.open()
    (cj, dj), (ct, dt) = j.grab(), t.grab()
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(dt, dj)
    return ct, dt


def _assert_signed_dots(a, b, what):
    dots = np.sum(a * b, -1)
    assert (dots > 0.999).mean() >= 0.99, f"{what}: {(dots > 0.999).mean()} above 0.999"


@pytest.fixture(scope="module")
def whole_slice():
    s = SLICE
    color, depth = _frame(s["W"], s["H"], s["cx"])
    K = np.array([[525.0, 0, s["cx"]], [0, 525.0, s["H"] / 2 - 0.5], [0, 0, 1]], np.float32)
    kw = dict(radius=s["radius"], grid_size=s["grid_size"], cell_capacity=s["cell_capacity"])
    out = {}
    for side, bp, proc, nrm, put in (
            ("jax", jbp, jpp.PointCloudProcessing(), jn, jnp.asarray),
            ("port", backproject, pointcloud_processing.PointCloudProcessing(), tn,
             torch.tensor)):
        intr = (jtypes if side == "jax" else types).CameraIntrinsics.from_matrix(K)
        pc = bp.pointcloud_from_rgbd(put(color), put(depth), intr)
        q = proc.process_point_cloud(pc)
        o = nrm.orient_normals_consistent(nrm.estimate_normals(q, **kw), k=10, iterations=100)
        out[side] = (pc, q, o)
    return out


def test_whole_slice_cloud_and_masks_match_jax(whole_slice):
    (jpc, jq, _), (tpc, tq, _) = whole_slice["jax"], whole_slice["port"]
    np.testing.assert_array_equal(tpc.points.numpy(), np.asarray(jpc.points))
    assert tq.capacity == jq.capacity > 32768
    v = np.asarray(jq.valid)
    np.testing.assert_array_equal(tq.valid.numpy(), v)
    assert 0.5 < v.sum() / np.asarray(jpc.valid).sum() < 1.0
    np.testing.assert_allclose(tq.points.numpy()[v], np.asarray(jq.points)[v], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tq.colors.numpy()[v], np.asarray(jq.colors)[v], rtol=1e-6,
                               atol=1e-6)


def test_whole_slice_oriented_normals_match_jax(whole_slice):
    (_, jq, jo), (_, _, to) = whole_slice["jax"], whole_slice["port"]
    s = SLICE
    cnt = np.asarray(jgk.grid_pca_moments(jq.points, jq.valid, s["radius"],
                                          grid_size=s["grid_size"],
                                          cell_capacity=s["cell_capacity"])[0])
    well = np.asarray(jq.valid) & (cnt >= 5)
    assert well.sum() > 5000
    _assert_signed_dots(to.normals.numpy()[well], np.asarray(jo.normals)[well], "whole slice")
    # the plane z = 1.8 (z = -1.8 after the flip): normals along the z axis
    plane = well & (np.asarray(jq.points)[:, 2] < -1.79)
    assert plane.sum() > 1000
    assert (np.abs(to.normals.numpy()[plane, 2]) > np.cos(np.radians(5))).mean() >= 0.95
