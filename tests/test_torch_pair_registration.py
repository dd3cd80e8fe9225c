"""Port parity for parallel/batch.py's pair registration against the JAX
package on the CPU.

- register_pairs_batched (ICP point-to-point over 4 pairs of the JAX
  tests' scene, tests/test_parallel.py:54-67: 256 points, small rigid
  motions, threshold 0.1, 30 iterations): transforms against the JAX
  package's vmapped program atol 1e-4 (the ICP tests' bar); against the
  truth 5e-3, as the JAX test.
- register_pairs_ransac_batched on 2 pairs of synthetic frames (160x120,
  Scanner3D's preprocessing at voxel 0.05, compacted to 2048 points):
  bitwise equal to the port's per-pair registration_ransac_fpfh +
  information_matrix (one seed a pair); against the true relative pose,
  what the scene fixes within 5e-3: the sphere's center (m) and the plane's
  normal (tests/_scene.py). The rotation about the plane's normal through
  the sphere's center moves neither surface and FPFH sees no texture, so
  the pose is not held elementwise (measured: 0.238 rad about that axis on
  pair 1 -> 0, 0.0018 on 2 -> 0, with the center within 1.1e-4 m and the
  normal within 1e-5; the registration tests' scene bars have the same
  cause).
- register_pairs_sharded on an in-process mesh of 2 shards: bitwise equal
  to register_pairs_batched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.parallel import batch as jbatch
from recon3d_tpu.registration.se3 import se3_exp
from recon3d_tpu.utils.types import PointCloud as JPointCloud
from recon3d_tpu_torch import config, convert
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.parallel import batch
from recon3d_tpu_torch.parallel.mesh import make_mesh
from recon3d_tpu_torch.pipeline.offline import Scanner3D
from recon3d_tpu_torch.registration.icp import information_matrix
from recon3d_tpu_torch.registration.ransac import registration_ransac_fpfh
from recon3d_tpu_torch.utils.types import CameraIntrinsics

from ._scene import scene_motion

B = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def icp_pairs():
    """B (source, target) pairs with known rigid transforms, as JAX clouds
    with a batch axis and as the port's list."""
    rng = np.random.RandomState(0)
    base = rng.randn(256, 3).astype(np.float32) * 0.2
    srcs, tgts, truths = [], [], []
    for _ in range(B):
        xi = np.concatenate([rng.randn(3) * 0.01, rng.randn(3) * 0.02])
        T = np.asarray(se3_exp(jnp.asarray(xi, jnp.float32)))
        pts = base + rng.randn(256, 3).astype(np.float32) * 0.001
        srcs.append(pts)
        tgts.append(pts @ T[:3, :3].T + T[:3, 3])
        truths.append(T)
    stack = lambda cs: jax.tree.map(lambda *xs: jnp.stack(xs),  # noqa: E731
                                    *[JPointCloud.from_numpy(p) for p in cs])
    return stack(srcs), stack(tgts), np.stack(truths)


def _port(jcloud):
    return convert.point_clouds({"points": np.asarray(jcloud.points),
                                 "valid": np.asarray(jcloud.valid)}, device="cpu")


def test_register_pairs_batched_matches_jax(icp_pairs):
    jsrc, jtgt, truths = icp_pairs
    ref = jbatch.register_pairs_batched(jsrc, jtgt, threshold=0.1, max_iterations=30)
    res = batch.register_pairs_batched(_port(jsrc), _port(jtgt), threshold=0.1,
                                       max_iterations=30)
    assert res.transformation.shape == (B, 4, 4) and res.fitness.shape == (B,)
    np.testing.assert_allclose(res.transformation.numpy(), np.asarray(ref.transformation),
                               atol=1e-4)
    np.testing.assert_allclose(res.transformation.numpy(), truths, atol=5e-3)
    ref = convert.registration_result({k: np.asarray(v) for k, v in ref._asdict().items()},
                                      device="cpu")
    np.testing.assert_allclose(res.fitness.numpy(), ref.fitness.numpy(), atol=1e-6)
    assert ref.iterations.dtype == res.iterations.dtype == torch.int64
    # a cloud with a batch axis is the same batch; explicit inits are used
    stacked = convert.point_cloud({"points": np.asarray(jsrc.points),
                                   "valid": np.asarray(jsrc.valid)}, device="cpu")
    again = batch.register_pairs_batched(stacked, _port(jtgt), threshold=0.1,
                                         max_iterations=30)
    assert torch.equal(again.transformation, res.transformation)
    inits = torch.as_tensor(truths, dtype=torch.float32)
    warm = batch.register_pairs_batched(_port(jsrc), _port(jtgt), inits, threshold=0.1,
                                        max_iterations=1)
    np.testing.assert_allclose(warm.transformation.numpy(), truths, atol=5e-3)


def test_register_pairs_sharded_equals_batched(icp_pairs):
    jsrc, jtgt, _ = icp_pairs
    ref = batch.register_pairs_batched(_port(jsrc), _port(jtgt), threshold=0.1,
                                       max_iterations=30)
    res = batch.register_pairs_sharded(_port(jsrc), _port(jtgt),
                                       make_mesh(2, ("frame",), device="cpu"), threshold=0.1,
                                       max_iterations=30)
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        batch.register_pairs_sharded(_port(jsrc)[:3], _port(jtgt)[:3],
                                     make_mesh(2, ("frame",), device="cpu"))


@pytest.fixture(scope="module")
def fragments(tmp_path_factory):
    """Scanner3D's preprocessing of 3 synthetic 160x120 frames."""
    cam = SyntheticRGBDCamera(160, 120, fx=130.0, fy=130.0, n_frames=3, step=0.015)
    cfg = config.ScannerConfig(
        stream=config.StreamConfig(width=160, height=120, depth_trunc=2.5),
        registration=config.RegistrationConfig(voxel_size=0.05),
        output_dir=str(tmp_path_factory.mktemp("pairs")), save_frames=False)
    sc = Scanner3D(cam, CameraIntrinsics(130.0, 130.0, 79.5, 59.5), cfg, device="cpu")
    sc.capture_frames(3)
    prep = [sc._preprocess(c, d, capacity=2048) for c, d in sc.frames]
    assert all(int(p.valid.sum()) < 2048 for p, _ in prep)
    return cam, [p for p, _ in prep], [f for _, f in prep]


def test_register_pairs_ransac_batched_equals_per_pair_calls(fragments):
    cam, clouds, feats = fragments
    pairs = [(1, 0), (2, 0)]
    thr, trials = 0.075, 1024
    res, infos = batch.register_pairs_ransac_batched(
        [clouds[i] for i, _ in pairs], [clouds[j] for _, j in pairs],
        torch.stack([feats[i] for i, _ in pairs]), [feats[j] for _, j in pairs],
        distance_threshold=thr, num_trials=trials)
    assert infos.shape == (2, 6, 6)
    for k, (i, j) in enumerate(pairs):
        one = registration_ransac_fpfh(clouds[i], clouds[j], feats[i], feats[j], thr,
                                       num_trials=trials)
        for a, b in zip(one, res):
            assert torch.equal(a, b[k])
        assert torch.equal(information_matrix(clouds[i], clouds[j], thr, one.transformation),
                           infos[k])
        # the transform maps frame i's camera into frame j's
        truth = cam.true_pose(j) @ np.linalg.inv(cam.true_pose(i))
        center, normal = scene_motion(res.transformation[k].numpy(), truth, cam.true_pose(j))
        assert center <= 5e-3 and normal <= 5e-3, (i, j, center, normal)
        assert bool(res.is_good(0.3, 0.1)[k])
    with pytest.raises(ValueError):
        batch.register_pairs_ransac_batched(clouds[:2], clouds[:2], feats[:2], feats[:1], thr)
