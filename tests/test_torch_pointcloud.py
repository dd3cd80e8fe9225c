"""Port parity for the point-cloud containers and operations
(recon3d_tpu_torch/utils/types.py, camera/, pointcloud/backproject.py,
pointcloud/voxel.py, ops/knn.py, pointcloud/outliers.py) against the JAX
package on the CPU, on seeded numpy inputs. Bars:
  containers, compact, concatenate, transform, pointcloud_from_rgbd,
  voxel_ids: bitwise (the same float32 operations; the 3x3 products as
  XLA's CPU product rounds them, ops.image.matmul3);
  voxel_downsample: valid and the voxel count equal, points / colors /
  normals rtol 1e-6, atol 1e-6 (the per-voxel sums are added in another
  order: a segmented reduction against an associative scan);
  knn: indices equal, squared distances rtol 1e-5, also on a lattice
  cloud full of tied distances (ties go to the lower index, as lax.top_k);
  outlier filters: kept masks equal, except for points whose statistic lies
  within 1e-5 (relative) of the threshold, listed in the message.
"""
import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.config import ProcessingConfig as JProcessingConfig
from recon3d_tpu.ops import knn as jknn
from recon3d_tpu.pointcloud import backproject as jbp
from recon3d_tpu.pointcloud import outliers as joutliers
from recon3d_tpu.pointcloud import voxel as jvoxel
from recon3d_tpu.utils import types as jtypes
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.camera.base import Camera, ThreadedCamera
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.config import ProcessingConfig
from recon3d_tpu_torch.ops import knn
from recon3d_tpu_torch.pointcloud import backproject, outliers, voxel
from recon3d_tpu_torch.pointcloud_capture import PointCloudCapture
from recon3d_tpu_torch.utils import types


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread for this module's many small tensor ops: several test
    workers share one host, and more threads a worker oversubscribe its
    cores (each op's fork / join then waits on descheduled threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _clouds(seed=0, n=3000):
    """Seeded (points, valid) pairs: the unit cube, a patch 1.5 m away, and a
    3 mm lattice 1.5 m away (many exactly tied distances)."""
    rng = np.random.RandomState(seed)
    lattice = np.stack(np.meshgrid(np.arange(20), np.arange(20), np.arange(8), indexing="ij"),
                       -1).reshape(-1, 3) * 0.003 + [0.1, -0.2, 1.5]
    out = {"cube": rng.rand(n, 3), "far": rng.rand(n, 3) * 0.3 + [0.1, -0.2, 1.5],
           "lattice": lattice}
    return {k: (p.astype(np.float32), rng.rand(len(p)) > 0.05) for k, p in out.items()}


def _jpc(points, valid, colors=None, normals=None):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return jtypes.PointCloud(points=j(points), valid=j(valid), colors=j(colors),
                             normals=j(normals))


def _tpc(points, valid, colors=None, normals=None):
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    return types.PointCloud(points=t(points), valid=t(valid), colors=t(colors),
                            normals=t(normals))


def _equal(t, j):
    if j is None:
        assert t is None
        return
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def test_point_cloud_container_matches_jax():
    rng = np.random.RandomState(1)
    pts, cols, nrm = (rng.rand(7, 3).astype(np.float32) for _ in range(3))
    j = jtypes.PointCloud.from_numpy(pts, cols, nrm, capacity=10)
    t = types.PointCloud.from_numpy(pts, cols, nrm, capacity=10, device="cpu")
    assert t.capacity == j.capacity == 10 and int(t.count()) == int(j.count()) == 7
    for a, b in zip((t.points, t.colors, t.normals, t.valid), (j.points, j.colors, j.normals,
                                                                j.valid)):
        _equal(a, b)
    for a, b in zip(t.to_numpy(), j.to_numpy()):
        np.testing.assert_array_equal(a, b)
    _equal(t.masked_points(), j.masked_points())
    _equal(t.masked_points(-1.0), j.masked_points(-1.0))
    with pytest.raises(ValueError, match="capacity"):
        types.PointCloud.from_numpy(pts, capacity=3, device="cpu")
    back = convert.point_cloud({f.name: np.asarray(getattr(j, f.name))
                                for f in dataclasses.fields(j)}, device="cpu")
    _equal(back.points, j.points)
    _equal(back.valid, j.valid)
    assert back.valid.dtype == torch.bool
    assert convert.processing_config(dataclasses.asdict(JProcessingConfig())) == \
        ProcessingConfig()


@pytest.mark.parametrize("capacity", [5, 40, 60])
def test_compact_matches_jax(capacity):
    """Stable valid-first packing, truncated (5) or padded (60)."""
    rng = np.random.RandomState(capacity)
    pts, cols = rng.rand(40, 3).astype(np.float32), rng.rand(40, 3).astype(np.float32)
    valid = rng.rand(40) > 0.4
    j = jtypes.compact(_jpc(pts, valid, cols), capacity)
    t = types.compact(_tpc(pts, valid, cols), capacity)
    for a, b in ((t.points, j.points), (t.colors, j.colors), (t.valid, j.valid)):
        _equal(a, b)
    assert t.normals is None


def test_concatenate_and_transform_match_jax():
    rng = np.random.RandomState(2)
    a = [rng.rand(9, 3).astype(np.float32) for _ in range(3)] + [rng.rand(9) > 0.3]
    b = [rng.rand(4, 3).astype(np.float32) for _ in range(3)] + [rng.rand(4) > 0.3]
    ja, jb = (_jpc(p, v, c, n) for p, c, n, v in (a, b))
    ta, tb = (_tpc(p, v, c, n) for p, c, n, v in (a, b))
    jc, tc = jtypes.concatenate(ja, jb), types.concatenate(ta, tb)
    for x, y in ((tc.points, jc.points), (tc.colors, jc.colors), (tc.normals, jc.normals),
                 (tc.valid, jc.valid)):
        _equal(x, y)
    with pytest.raises(ValueError, match="colors"):
        types.concatenate(ta, dataclasses.replace(tb, colors=None))
    ang = 0.3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0.0], [np.sin(ang), np.cos(ang), 0.0],
                 [0.0, 0.0, 1.0]]
    T[:3, 3] = (0.1, -0.25, 1.5)
    # a cloud of some rows: XLA's CPU product of a handful of rows rounds
    # every column as a fused multiply-add chain (ops.image.matmul3)
    pts, nrm = rng.randn(300, 3).astype(np.float32), rng.randn(300, 3).astype(np.float32)
    valid = rng.rand(300) > 0.2
    jt = jtypes.transform(_jpc(pts, valid, normals=nrm), jnp.asarray(T))
    tt = types.transform(_tpc(pts, valid, normals=nrm), T)
    _equal(tt.points, jt.points)
    _equal(tt.normals, jt.normals)


def test_synthetic_rgbd_camera_copy_renders_the_same():
    j, t = JSyntheticRGBDCamera(64, 48, n_frames=2), SyntheticRGBDCamera(64, 48, n_frames=2)
    for cam in (j, t):
        cam.open()
    for k in range(2):
        np.testing.assert_array_equal(t.true_pose(k), j.true_pose(k))
        for a, b in zip(t.grab(), j.grab()):
            np.testing.assert_array_equal(a, b)
    assert t.grab() is None and j.grab() is None


class _Flaky(Camera):
    """Fails every other grab: ThreadedCamera retries."""

    def __init__(self):
        self.n = 0

    def open(self):
        pass

    def grab(self):
        self.n += 1
        if self.n % 2:
            raise RuntimeError("dropped")
        return (np.full((2, 2, 3), self.n, np.uint8), np.ones((2, 2), np.float32))


def test_threaded_camera_reads_latest_frame():
    cam = ThreadedCamera(_Flaky(), max_retries=3, timeout_s=0.01).start()
    try:
        deadline = time.monotonic() + 5.0
        ok = False
        while not ok and time.monotonic() < deadline:
            ok, frame = cam.read()
            time.sleep(0.005)
        assert ok and frame[0].shape == (2, 2, 3) and frame[0][0, 0, 0] % 2 == 0
    finally:
        cam.stop()
    assert not cam._thread.is_alive() and cam.frames_grabbed >= 1
    assert threading.active_count() >= 1


@pytest.mark.parametrize("flip", [True, False])
def test_pointcloud_from_rgbd_matches_jax(flip):
    cam = JSyntheticRGBDCamera(80, 60, fx=70.0, fy=70.0)
    cam.open()
    color, depth = cam.grab()
    depth = depth.copy()
    depth[::7, ::5] = 0.0
    depth[3, :10] = 5.0  # beyond depth_trunc
    K = np.array([[70.0, 0, 39.5], [0, 70.0, 29.5], [0, 0, 1]], np.float32)
    j = jbp.pointcloud_from_rgbd(jnp.asarray(color), jnp.asarray(depth),
                                 jtypes.CameraIntrinsics.from_matrix(K), flip=flip)
    t = backproject.pointcloud_from_rgbd(torch.tensor(color), torch.tensor(depth),
                                         types.CameraIntrinsics.from_matrix(K), flip=flip)
    for a, b in ((t.points, j.points), (t.colors, j.colors), (t.valid, j.valid)):
        _equal(a, b)
    np.testing.assert_array_equal(backproject.FLIP_TRANSFORM, jbp.FLIP_TRANSFORM)
    cap = PointCloudCapture(types.CameraIntrinsics.from_matrix(K), flip=flip, device="cpu")
    out = cap.capture_point_cloud((color, depth))
    ref = jvoxel.voxel_downsample(j, 0.01)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))


def _assert_voxel_close(t, j):
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), v)
    assert t.valid.sum() == v.sum() > 0
    for a, b in ((t.points, j.points), (t.colors, j.colors), (t.normals, j.normals)):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy()[v], np.asarray(b)[v], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("voxel_size,capacity", [(0.05, None), (0.02, 300), (0.1, 4096)])
def test_voxel_downsample_matches_jax(voxel_size, capacity):
    """Capacity None (the input's), 300 (fewer than the voxels: the
    overflow bucket drops the last ones in lexicographic order) and 4096."""
    rng = np.random.RandomState(4)
    n = 4000
    pts = (rng.rand(n, 3) * [0.6, 0.4, 0.3] - [0.3, 0.1, 0.0]).astype(np.float32)
    cols, nrm = rng.rand(n, 3).astype(np.float32), rng.randn(n, 3).astype(np.float32)
    valid = rng.rand(n) > 0.1
    j = jvoxel.voxel_downsample(_jpc(pts, valid, cols, nrm), voxel_size, capacity=capacity)
    t = voxel.voxel_downsample(_tpc(pts, valid, cols, nrm), voxel_size, capacity=capacity)
    assert t.capacity == j.capacity
    _assert_voxel_close(t, j)
    jp = jvoxel.voxel_downsample(_jpc(pts, valid), voxel_size, capacity=capacity, origin=0.013)
    tp = voxel.voxel_downsample(_tpc(pts, valid), voxel_size, capacity=capacity, origin=0.013)
    _assert_voxel_close(tp, jp)
    _equal(voxel.voxel_ids(torch.tensor(pts), torch.tensor(valid), voxel_size),
           jvoxel.voxel_ids(jnp.asarray(pts), jnp.asarray(valid), voxel_size))


@pytest.mark.parametrize("cloud", ["cube", "far", "lattice"])
@pytest.mark.parametrize("k", [10, 30])
def test_knn_matches_jax(cloud, k):
    p, v = _clouds()[cloud]
    ij, dj = jknn.knn(jnp.asarray(p), jnp.asarray(v), k=k)
    it, dt = knn.knn(torch.tensor(p), torch.tensor(v), k=k)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_smallest_k_breaks_ties_to_the_lower_index():
    d2 = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, 1.0, 2.0]])
    vals, idx = knn.smallest_k(d2, 3)
    assert idx.tolist() == [[3, 1, 2]] and vals.tolist() == [[0.5, 1.0, 1.0]]
    vals, idx = knn.smallest_k(d2.flip(1), 4)
    assert idx.tolist() == [[3, 1, 2, 4]]


@pytest.mark.parametrize("cloud", ["cube", "far", "lattice"])
def test_radius_nearest_and_hybrid_match_jax(cloud):
    p, v = _clouds()[cloud]
    r = {"cube": 0.08, "far": 0.02, "lattice": 0.0061}[cloud]
    cj = jknn.radius_count(jnp.asarray(p), jnp.asarray(v), r)
    ct = knn.radius_count(torch.tensor(p), torch.tensor(v), r)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert np.asarray(cj).mean() > 1
    q = p[::3] + np.float32(0.001)
    qv = v[::3]
    ij, dj = jknn.nearest_neighbor(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(p),
                                   jnp.asarray(v))
    it, dt = knn.nearest_neighbor(torch.tensor(q), torch.tensor(qv), torch.tensor(p),
                                  torch.tensor(v))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    hj = jknn.hybrid_knn(jnp.asarray(p), jnp.asarray(v), r, max_nn=12)
    ht = knn.hybrid_knn(torch.tensor(p), torch.tensor(v), r, max_nn=12)
    for a, b in zip(ht, hj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _assert_masks_equal_near_threshold(keep_t, keep_j, stat, thresh):
    """Masks equal, except points whose statistic is within 1e-5 (relative)
    of the threshold."""
    diff = np.nonzero(keep_t != keep_j)[0]
    near = np.abs(stat - thresh) <= 1e-5 * np.abs(thresh)
    far = [int(i) for i in diff if not near[i]]
    assert not far, (f"{len(diff)} masks differ, {len(far)} away from the threshold "
                     f"{thresh}: {far[:20]}; near it: {[int(i) for i in diff if near[i]][:20]}")


@pytest.mark.parametrize("cloud", ["cube", "far", "lattice"])
def test_outlier_filters_match_jax(cloud):
    p, v = _clouds()[cloud]
    jpc, tpc = _jpc(p, v), _tpc(p, v)
    js = joutliers.remove_statistical_outliers(jpc, nb_neighbors=20, std_ratio=1.2)
    ts = outliers.remove_statistical_outliers(tpc, nb_neighbors=20, std_ratio=1.2)
    # the statistic and its threshold, as the JAX package computes them
    _, d2 = jknn.knn(jnp.asarray(p), jnp.asarray(v), k=20)
    mean_d = np.asarray(jnp.mean(jnp.sqrt(jnp.maximum(d2, 0.0)), axis=1))
    mu = mean_d[v].mean()
    thresh = mu + 1.2 * mean_d[v].std(ddof=1)
    keep_j = np.asarray(js.valid)
    assert 0.5 < keep_j.sum() / v.sum() < 1.0
    _assert_masks_equal_near_threshold(ts.valid.numpy(), keep_j, mean_d, thresh)
    r = {"cube": 0.08, "far": 0.02, "lattice": 0.0061}[cloud]
    jr = joutliers.remove_radius_outliers(jpc, nb_points=3, radius=r)
    tr = outliers.remove_radius_outliers(tpc, nb_points=3, radius=r)
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
