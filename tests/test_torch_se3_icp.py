"""Port parity for registration/se3.py, registration/icp.py,
pointcloud_alignment.py and config.RegistrationConfig against the JAX
package on the CPU, on seeded numpy inputs (the JAX tests' 800-point
surfaces, targets with 3 mm noise). Bars and the largest differences
measured:
  se3 maps, each on the same twists x and transforms T = exp(x) (the JAX
  package's): atol 1e-6, also at angles within 1e-4 of 0 and of pi
  (measured 2.4e-7; hat bitwise), except se3_log: atol 5e-6 (measured
  2.9e-6 at an angle pi - 3e-3, where V^-1's (1 + cos t) / (2 t sin t)
  holds 1 + cos t = 4.5e-6 to a few float32 ulps of 1, and the JAX
  package's cos and the C library's differ by one);
  ICP at a fixed count (relative tolerances 0, both run 15 iterations):
  iterations equal, transform atol 1e-5 (measured 1.7e-6), fitness rtol
  1e-6 (equal), rmse rtol 5e-4 (measured 1.2e-4). The rmse bar is looser
  than 1e-5: the rmse reads d^2 from the distance expansion
  |q|^2 + |p|^2 - 2 q.p, whose float32 cancellation leaves an ulp of
  |q|^2 (1.2e-7 here) in each d^2 of ~3e-5, ~1e-4 relative in the mean
  over 800 points, and transforms that differ in the last bits redraw it;
  ICP with the default rule: transform atol 1e-5 (measured 2.0e-6) and
  fitness rtol 1e-6; the iteration counts are reported, not held equal:
  the rule stops once the rmse changed by less than 1e-6 relative in an
  iteration, below the same noise, so where a run stops is decided by
  rounding (JAX / port: point-to-point 40 / 46, point-to-plane 10 / 50,
  GICP 14 / 30);
  covariances_for_gicp: atol 2e-6 (measured 1.07e-6 on a noisy target:
  V diag(e, 1, 1) V^T of float32 eigenvectors a few ulps apart, entries
  near 1);
  evaluate_registration: fitness and rmse equal (the transform applied as
  the JAX package's product rounds it, the brute-force 1-NN bitwise);
  information_matrix: rtol 1e-4 of its largest entry (measured 8e-8);
  PointCloudAlignment (both methods, grid 1-NN): transform atol 1e-5
  (measured 8.9e-7), fitness rtol 1e-6 (equal), aligned points atol 1e-4
  (measured 1.1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.config import RegistrationConfig as JRegistrationConfig
from recon3d_tpu.pointcloud.normals import estimate_normals as jestimate_normals
from recon3d_tpu.pointcloud_alignment import PointCloudAlignment as JPointCloudAlignment
from recon3d_tpu.registration import icp as jicp
from recon3d_tpu.registration import se3 as jse3
from recon3d_tpu.utils import types as jtypes
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.config import RegistrationConfig
from recon3d_tpu_torch.pointcloud_alignment import PointCloudAlignment
from recon3d_tpu_torch.registration import icp, se3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: several test workers share one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def surface_cloud(n=800, seed=0):
    """The JAX tests' noisy curved surface (tests/test_registration.py:20-27)."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 2 - 1
    z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(3.0 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def pose(rvec, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(rvec, jnp.float32)))
    T[:3, 3] = t
    return T


def port_cloud(jpc):
    """The port's PointCloud (CPU) from a JAX one."""
    return convert.point_cloud({k: None if getattr(jpc, k) is None else np.asarray(getattr(jpc, k))
                                for k in ("points", "valid", "colors", "normals")}, device="cpu")


def pair(seed, noise=0.003, n=800):
    """(JAX source, JAX target): the surface and its image under a small
    pose, with Gaussian noise on the target."""
    pts = surface_cloud(n, seed)
    T_true = pose([0.03, -0.02, 0.04], [0.02, -0.015, 0.01])
    rng = np.random.RandomState(seed + 10)
    tgt = pts @ T_true[:3, :3].T + T_true[:3, 3] + rng.randn(*pts.shape).astype(np.float32) * noise
    return jtypes.PointCloud.from_numpy(pts), jtypes.PointCloud.from_numpy(tgt)


def _twists():
    """Random twists plus rotations 1e-5 / 3e-7 rad and pi - 1e-4 / pi - 3e-3
    rad about random axes."""
    rng = np.random.RandomState(0)
    axis = rng.randn(20, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.repeat([1e-5, 3e-7, np.pi - 1e-4, np.pi - 3e-3], 5)
    edge = np.concatenate([rng.randn(20, 3) * 0.1, axis * ang[:, None]], 1)
    return np.concatenate([rng.randn(50, 6) * 0.7, edge]).astype(np.float32)


# each case maps twists x, or the JAX package's transforms T = exp(x), the
# same inputs on both sides
SE3_CASES = {
    "hat": (lambda m, x, T: m.hat(x[:, 3:])),
    "so3_exp": (lambda m, x, T: m.so3_exp(x[:, 3:])),
    "se3_exp": (lambda m, x, T: m.se3_exp(x)),
    "so3_log": (lambda m, x, T: m.so3_log(T[:, :3, :3])),
    "se3_log": (lambda m, x, T: m.se3_log(T)),
    "inverse": (lambda m, x, T: m.inverse(T)),
    "compose": (lambda m, x, T: m.compose(T, T[REVERSED])),
}
REVERSED = np.arange(len(_twists()))[::-1].copy()


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_maps_match_jax(name):
    x = _twists()
    T = np.asarray(jax.jit(jse3.se3_exp)(jnp.asarray(x)))
    fn = SE3_CASES[name]
    ref = np.asarray(jax.jit(lambda v, M: fn(jse3, v, M))(jnp.asarray(x), jnp.asarray(T)))
    got = fn(se3, torch.tensor(x), torch.tensor(T)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6 if name == "se3_log" else 1e-6)


def test_se3_apply_matches_jax_bitwise():
    x = _twists()
    T = np.asarray(jse3.se3_exp(jnp.asarray(x[7])))
    pts = surface_cloud(500, 3)
    ref = np.asarray(jse3.apply(jnp.asarray(T), jnp.asarray(pts)))
    np.testing.assert_array_equal(se3.apply(torch.tensor(T), torch.tensor(pts)).numpy(), ref)


def test_registration_config_defaults_match():
    assert dataclasses.asdict(RegistrationConfig()) == dataclasses.asdict(JRegistrationConfig())


def _icp_inputs(method, seed):
    js, jt = pair(seed)
    kw, pkw = {}, {}
    if method == "point_to_plane":
        jt = jestimate_normals(jt, radius=0.3, max_nn=20)
    ps, pt = port_cloud(js), port_cloud(jt)
    if method == "gicp":
        kw = dict(source_cov=jicp.covariances_for_gicp(js),
                  target_cov=jicp.covariances_for_gicp(jt))
        pkw = {k: torch.tensor(np.asarray(v)) for k, v in kw.items()}
    return (js, jt, kw), (ps, pt, pkw)


METHODS = ("point_to_point", "point_to_plane", "gicp")


@pytest.mark.parametrize("method", METHODS)
def test_icp_fixed_iterations_match_jax(method):
    (js, jt, kw), (ps, pt, pkw) = _icp_inputs(method, METHODS.index(method))
    fixed = dict(threshold=0.1, method=method, max_iterations=15, relative_fitness=0.0,
                 relative_rmse=0.0)
    a = jicp.registration_icp(js, jt, **fixed, **kw)
    b = icp.registration_icp(ps, pt, **fixed, **pkw)
    assert int(b.iterations) == int(a.iterations) == 15
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(b.fitness), float(a.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(b.inlier_rmse), float(a.inlier_rmse), rtol=5e-4)


@pytest.mark.parametrize("method", METHODS)
def test_icp_default_rule_matches_jax(method):
    (js, jt, kw), (ps, pt, pkw) = _icp_inputs(method, METHODS.index(method))
    a = jicp.registration_icp(js, jt, threshold=0.1, method=method, max_iterations=50, **kw)
    b = icp.registration_icp(ps, pt, threshold=0.1, method=method, max_iterations=50, **pkw)
    msg = f"iterations: JAX {int(a.iterations)}, port {int(b.iterations)}"
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), rtol=0,
                               atol=1e-5, err_msg=msg)
    np.testing.assert_allclose(float(b.fitness), float(a.fitness), rtol=1e-6, err_msg=msg)
    assert 1 <= int(b.iterations) <= 50, msg


@pytest.mark.parametrize("seed", [2, 4])
def test_covariances_for_gicp_match_jax(seed):
    js, jt = pair(seed)
    for jpc in (js, jt):
        ref = np.asarray(jax.jit(jicp.covariances_for_gicp)(jpc))
        got = icp.covariances_for_gicp(port_cloud(jpc)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_evaluate_and_information_match_jax():
    js, jt = pair(5)
    ps, pt = port_cloud(js), port_cloud(jt)
    T = pose([0.028, -0.021, 0.041], [0.019, -0.014, 0.012])
    for thr in (0.05, 0.01):
        a = jicp.evaluate_registration(js, jt, thr, jnp.asarray(T))
        b = icp.evaluate_registration(ps, pt, thr, torch.tensor(T))
        assert float(b.fitness) == float(a.fitness)
        assert float(b.inlier_rmse) == float(a.inlier_rmse)
        assert bool(b.is_good()) == bool(a.is_good())
        ia = np.asarray(jicp.information_matrix(js, jt, thr, jnp.asarray(T)))
        ib = icp.information_matrix(ps, pt, thr, torch.tensor(T)).numpy()
        np.testing.assert_allclose(ib, ia, rtol=1e-4, atol=1e-4 * np.abs(ia).max())
    far = jtypes.PointCloud.from_numpy(surface_cloud(800, 3) + np.float32([10, 0, 0]))
    res = icp.evaluate_registration(port_cloud(js), port_cloud(far), threshold=0.02)
    assert not bool(res.is_good())  # check6.py:65-76's gate rejects


@pytest.mark.parametrize("method", ["point_to_point", "point_to_plane"])
def test_point_cloud_alignment_matches_jax(method):
    """The shim on two 160x120 synthetic frames: voxel 0.02 keeps the
    frames' capacity (19200), so N * M > 2^26 and ICP takes the grid 1-NN
    in both packages."""
    from recon3d_tpu.camera.fake import SyntheticRGBDCamera
    from recon3d_tpu.pointcloud.backproject import backproject_depth

    cam = SyntheticRGBDCamera(160, 120, fx=130.0, fy=130.0, step=0.02)
    cam.open()
    intr = jtypes.CameraIntrinsics(fx=jnp.float32(130.0), fy=jnp.float32(130.0),
                                   cx=jnp.float32(79.5), cy=jnp.float32(59.5))
    clouds = [backproject_depth(jnp.asarray(cam.grab()[1]), intr) for _ in range(2)]
    assert icp.uses_grid(clouds[0].capacity, clouds[1].capacity)
    cfg = dict(method=method, icp_max_iterations=4)
    a_pc, a = JPointCloudAlignment(JRegistrationConfig(**cfg)).align_point_clouds(*clouds)
    b_pc, b = PointCloudAlignment(RegistrationConfig(**cfg)).align_point_clouds(
        *(port_cloud(c) for c in clouds))
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(b.fitness), float(a.fitness), rtol=1e-6)
    assert float(a.fitness) > 0.3
    np.testing.assert_allclose(b_pc.points.numpy(), np.asarray(a_pc.points), rtol=0, atol=1e-4)
