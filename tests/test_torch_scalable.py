"""Port parity: the hashed-brick scalable TSDF (fusion/scalable.py),
recon3d_tpu_torch against the JAX package on the CPU.

Inputs: SyntheticRGBDCamera frames at 96x80 (with color, at their true
poses) and flat walls swept sideways, into 512-brick pools. Bars: the hash,
brick keys, table, n_alloc and n_dropped bitwise; tsdf, weight and color
bitwise (the port rounds as the jitted JAX integrate: fused multiply-adds
for the voxel centers, the camera transform and the running averages);
export_dense bitwise; a checkpoint saved by either package loads in the
other and continues bitwise; the weight cap; meshes within a voxel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from recon3d_tpu.camera.fake import SyntheticRGBDCamera
from recon3d_tpu.fusion import scalable as js
from recon3d_tpu.utils.types import CameraIntrinsics as JIntr
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.fusion import scalable as ts

JI = JIntr(fx=jnp.float32(80.0), fy=jnp.float32(80.0), cx=jnp.float32(47.5),
           cy=jnp.float32(39.5))
TI = convert.camera_intrinsics(80.0, 80.0, 47.5, 39.5)
FIELDS = ("brick_keys", "table", "n_alloc", "n_dropped", "tsdf", "weight", "color")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """2 torch threads: the suite runs six workers on a shared host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _frames(n=3):
    cam = SyntheticRGBDCamera(width=96, height=80, fx=80.0, fy=80.0, n_frames=n + 1, step=0.01)
    cam.open()
    out = []
    for k in range(n):
        color, depth = cam.grab()
        out.append((color, depth, np.linalg.inv(cam.true_pose(k)).astype(np.float32)))
    return out


def _wall_pose(k, dx=-0.08):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = dx * k
    return T


def _assert_same(jv, tv, fields=FIELDS):
    for f in fields:
        a, b = getattr(jv, f), getattr(tv, f)
        if a is None:
            assert b is None, f
            continue
        np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a), err_msg=f)


def _both(**kw):
    return js.make_scalable_volume(**kw), ts.make_scalable_volume(**kw, device="cpu")


def test_hash_and_key_packing_are_bitwise():
    rng = np.random.RandomState(0)
    keys = np.concatenate([rng.randint(-2 ** 31, 2 ** 31 - 1, 4096).astype(np.int32),
                           np.array([2 ** 30, -1, 0, 2 ** 31 - 1], np.int32)])
    for T in (256, 16384, 1 << 20):
        np.testing.assert_array_equal(ts._hash(torch.tensor(keys), T).numpy(),
                                      np.asarray(js._hash(jnp.asarray(keys), T)))
    bc = rng.randint(-600, 600, (1000, 3)).astype(np.int32)
    np.testing.assert_array_equal(ts._pack_key(torch.tensor(bc)).numpy(),
                                  np.asarray(js._pack_key(jnp.asarray(bc))))
    k = np.asarray(js._pack_key(jnp.asarray(np.clip(bc, -512, 511))))
    np.testing.assert_array_equal(ts._unpack_key(torch.tensor(k)).numpy(),
                                  np.asarray(js._unpack_key(jnp.asarray(k))))


@pytest.mark.parametrize("voxel,capacity,stride", [(0.02, 512, 2), (0.01, 96, 1)],
                         ids=["fits", "overflows"])
def test_integrate_is_bitwise(voxel, capacity, stride):
    """Frames with color into a pool that holds them, and into one that
    overflows (drops counted, the table full of the first claims)."""
    jv, tv = _both(voxel_size=voxel, sdf_trunc=4 * voxel, capacity=capacity, table_size=2048,
                   origin=(-1.0, -1.0, 0.0))
    for color, depth, ext in _frames():
        jv = js.integrate(jv, jnp.asarray(depth), JI, jnp.asarray(ext),
                          color=jnp.asarray(color), alloc_stride=stride)
        tv = ts.integrate(tv, torch.tensor(depth), TI, torch.tensor(ext),
                          color=torch.tensor(color), alloc_stride=stride)
        _assert_same(jv, tv)
    if capacity == 512:
        assert 0 < int(tv.n_alloc) < capacity and int(tv.n_dropped) == 0
    else:
        assert int(tv.n_alloc) == capacity and int(tv.n_dropped) > 0
    found = ts._lookup(tv, tv.brick_keys[tv.brick_keys >= 0])
    assert bool((found >= 0).all())


def test_maybe_grow_and_rehash_are_bitwise():
    """A wall sweep through a 64-brick pool grown between frames: every
    grow, rehash and later claim bitwise; the final state drops nothing."""
    jv, tv = _both(voxel_size=0.02, sdf_trunc=0.08, capacity=64, table_size=256,
                   with_color=False)
    depth = np.full((80, 96), 1.0, np.float32)
    grew = 0
    for k in range(8):
        e = _wall_pose(k)
        jv = js.maybe_grow(js.integrate(jv, jnp.asarray(depth), JI, jnp.asarray(e),
                                        depth_trunc=2.5))
        before = tv.capacity
        tv = ts.maybe_grow(ts.integrate(tv, torch.tensor(depth), TI, torch.tensor(e),
                                        depth_trunc=2.5))
        grew += tv.capacity > before
        assert tv.capacity == jv.capacity
        _assert_same(jv, tv)
    assert grew >= 2
    T4 = 4 * tv.table.shape[0]
    _assert_same(js.grow(jv, table_size=T4), ts.grow(tv, table_size=T4))


def test_export_dense_and_mesh():
    """Bounds, window origins and export_dense bitwise; the meshes of the
    occupied windows within a voxel of each other (a coarse 0.05 m pool, so
    the JAX side marches a few 40^3 windows)."""
    jv, tv = _both(voxel_size=0.05, sdf_trunc=0.2, capacity=512, table_size=2048,
                   origin=(-1.0, -1.0, 0.0))
    for color, depth, ext in _frames(2):
        jv = js.integrate(jv, jnp.asarray(depth), JI, jnp.asarray(ext), color=jnp.asarray(color),
                          depth_trunc=2.5)
        tv = ts.integrate(tv, torch.tensor(depth), TI, torch.tensor(ext),
                          color=torch.tensor(color), depth_trunc=2.5)
    _assert_same(jv, tv)
    lo_j, hi_j = js.occupied_bounds(jv)
    lo_t, hi_t = ts.occupied_bounds(tv)
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)
    wins_j, wins_t = js.occupied_window_origins(jv, 40), ts.occupied_window_origins(tv, 40)
    assert len(wins_t) == len(wins_j) > 1
    for a, b in zip(wins_t, wins_j):
        np.testing.assert_array_equal(a, b)
    dj, dt = js.export_dense(jv, jnp.asarray(wins_j[0]), 40), ts.export_dense(tv, wins_t[0], 40)
    for f in ("tsdf", "weight", "color", "origin"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(), np.asarray(getattr(dj, f)),
                                      err_msg=f)

    vj, fj, _, _ = js.extract_triangle_mesh(jv, window=40).to_numpy()
    vt, ft, ct, _ = ts.extract_triangle_mesh(tv, window=40).to_numpy()
    assert len(ft) > 200 and np.isfinite(vt).all() and ct is not None
    assert abs(len(ft) - len(fj)) <= 0.01 * len(fj)
    # every vertex within a voxel (0.05) of the other package's vertices
    for a, b in ((vt, vj), (vj, vt)):
        d, _ = cKDTree(b).query(a)
        assert d.max() < 0.05, d.max()


def test_weight_cap_keeps_moving_average():
    jv, tv = _both(voxel_size=0.02, sdf_trunc=0.08, capacity=512, table_size=2048,
                   origin=(-1.0, -1.0, 0.0))
    depth = np.full((80, 96), 1.0, np.float32)
    color = np.full((80, 96, 3), 200, np.uint8)
    for _ in range(6):
        jv = js.integrate(jv, jnp.asarray(depth), JI, jnp.eye(4), color=jnp.asarray(color),
                          depth_trunc=2.5, weight_max=4.0)
        tv = ts.integrate(tv, torch.tensor(depth), TI, torch.eye(4), color=torch.tensor(color),
                          depth_trunc=2.5, weight_max=4.0)
    _assert_same(jv, tv)
    assert float(tv.weight.max()) == 4.0


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_checkpoint_crosses_packages_and_continues_bitwise(tmp_path, saver):
    """A checkpoint saved by either package loads in the other (and through
    convert.py), and continuing after the reload equals an uninterrupted run
    of either package (JAX tests/test_scalable_tsdf.py:207)."""
    ji = JIntr(fx=jnp.float32(60.0), fy=jnp.float32(60.0), cx=jnp.float32(31.5),
               cy=jnp.float32(23.5))
    ti = convert.camera_intrinsics(60.0, 60.0, 31.5, 23.5)
    rng = np.random.RandomState(0)
    depths = [0.4 + 0.1 * rng.rand(48, 64).astype(np.float32) for _ in range(3)]
    kw = dict(voxel_size=0.01, capacity=512, table_size=2048)
    a_j, a_t = _both(**kw)
    for d in depths:
        a_j = js.integrate(a_j, jnp.asarray(d), ji, jnp.eye(4))
        a_t = ts.integrate(a_t, torch.tensor(d), ti, torch.eye(4))
    _assert_same(a_j, a_t)

    b_j, b_t = _both(**kw)
    for d in depths[:2]:
        b_j = js.integrate(b_j, jnp.asarray(d), ji, jnp.eye(4))
        b_t = ts.integrate(b_t, torch.tensor(d), ti, torch.eye(4))
    path = str(tmp_path / "scalable.npz")
    if saver == "jax":
        js.save_scalable_volume(path, b_j)
    else:
        ts.save_scalable_volume(path, b_t)
    r_j, r_t = js.load_scalable_volume(path), ts.load_scalable_volume(path, device="cpu")
    _assert_same(b_j, r_t)
    _assert_same(r_j, b_t)
    r_j = js.integrate(r_j, jnp.asarray(depths[2]), ji, jnp.eye(4))
    r_t = ts.integrate(r_t, torch.tensor(depths[2]), ti, torch.eye(4))
    _assert_same(a_j, r_t)
    _assert_same(r_j, a_t)

    # and across convert.py in both directions
    c_t = convert.scalable_volume({k: np.asarray(getattr(b_j, k)) for k in FIELDS + (
        "origin", "voxel_size", "sdf_trunc")}, device="cpu")
    c_j = js.ScalableTSDFVolume(**{k: None if v is None else jnp.asarray(v) for k, v in
                                   convert.scalable_volume_arrays(b_t).items()})
    c_t = ts.integrate(c_t, torch.tensor(depths[2]), ti, torch.eye(4))
    c_j = js.integrate(c_j, jnp.asarray(depths[2]), ji, jnp.eye(4))
    _assert_same(a_j, c_t)
    _assert_same(c_j, a_t)
