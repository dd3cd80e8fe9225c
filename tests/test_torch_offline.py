"""Port parity for pipeline/offline.py:Scanner3D and
pipeline/streaming.py:integrate_saved_frames against the JAX package on the
CPU, at tests/test_pipelines.py's _small_cfg: 3 SyntheticRGBDCamera frames
of 160x120 (fx = fy = 130, step 0.015), registration voxel 0.03 with 4096
RANSAC trials, a 96^3 TSDF of voxel 0.015.

Scanner3D: the two packages draw different RANSAC trials (the port's come
from a CPU torch.Generator), so they are compared by what the scene fixes
(tests/_scene.py): every node's sphere center within 5 mm and plane normal
within 5e-3 of the JAX node's and of the truth (world_from_frame k =
true_pose(0) true_pose(k)^-1); the same edge count; the mesh vertices'
median distance to the JAX mesh under one voxel; 3 PNG pairs written;
load_rgbd_frames' reload equal to the JAX package's and to the captured
frames (the depth as the writer's truncation to raw units, within 1 /
depth_scale). The rotation about the plane's
normal through the sphere's center is free (neither surface moves), so the
poses are not compared elementwise.

integrate_saved_frames on the saved pairs: bitwise the port's own
`_fuse_one` loop on the same decoded frames; against the JAX function the
streaming tests' bars (tests/test_torch_streaming.py): trajectory atol
1e-4, tsdf / weight / color within 1e-4 on all but 0.1 % of the voxels, the
origin equal.
"""
import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from recon3d_tpu import config as jconfig
from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.pipeline.offline import Scanner3D as JScanner3D
from recon3d_tpu.pipeline.streaming import integrate_saved_frames as jintegrate_saved_frames
from recon3d_tpu.utils.types import CameraIntrinsics as JIntrinsics
from recon3d_tpu_torch import config, convert
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.pipeline.offline import Scanner3D
from recon3d_tpu_torch.pipeline.streaming import StreamingFusion, integrate_saved_frames
from recon3d_tpu_torch.utils import io
from recon3d_tpu_torch.utils.types import CameraIntrinsics

from ._scene import scene_motion

N = 3
INTR = CameraIntrinsics(130.0, 130.0, 79.5, 59.5)
KW = dict(resolution=96, volume_origin=(-0.72, -0.72, 0.3))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _small_cfg(pkg, out):
    return pkg.ScannerConfig(
        stream=pkg.StreamConfig(width=160, height=120, depth_trunc=2.5),
        processing=pkg.ProcessingConfig(capture_voxel_size=0.02, voxel_size=0.02,
                                        outlier_nb_neighbors=10, radius_nb_points=4,
                                        radius=0.05, normal_radius=0.08, normal_max_nn=20,
                                        capacity=1 << 14),
        registration=pkg.RegistrationConfig(voxel_size=0.03, icp_threshold=0.06,
                                            icp_max_iterations=30,
                                            ransac_max_iterations=4096),
        fusion=pkg.FusionConfig(voxel_size=0.015, sdf_trunc=0.06, grid_resolution=96,
                                depth_trunc=2.5),
        mesh=pkg.MeshConfig(poisson_depth=5, smoothing_iterations=2),
        output_dir=str(out), max_fragments=8)


def _jintr():
    return JIntrinsics(fx=jnp.float32(130.0), fy=jnp.float32(130.0), cx=jnp.float32(79.5),
                       cy=jnp.float32(59.5))


def _cam(pkg_cls, n=N):
    return pkg_cls(width=160, height=120, fx=130.0, fy=130.0, n_frames=n, step=0.015)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jout, out = tmp_path_factory.mktemp("jax_offline"), tmp_path_factory.mktemp("offline")
    jsc = JScanner3D(_cam(JSyntheticRGBDCamera), _jintr(), _small_cfg(jconfig, jout))
    jpath = jsc.run(n_frames=N)
    # the JAX configuration carried across (convert.scanner_config)
    cfg = convert.scanner_config({**dataclasses.asdict(jsc.config), "output_dir": str(out)})
    assert cfg == _small_cfg(config, out)
    sc = Scanner3D(_cam(SyntheticRGBDCamera), INTR, cfg, device="cpu")
    path = sc.run(n_frames=N)
    return jsc, jpath, sc, path


def test_scanner3d_run_matches_jax(runs):
    jsc, jpath, sc, path = runs
    assert os.path.exists(path)
    d = io.read_ply(path)
    assert len(d["points"]) > 500 and "triangles" in d
    for (c, dep), (jc, jd) in zip(sc.frames, jsc.frames):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(dep, jd)
    nodes, jnodes = sc.pose_graph.nodes, jsc.pose_graph.nodes
    assert len(nodes) == len(jnodes) == N
    assert len(sc.pose_graph.edges) == len(jsc.pose_graph.edges)
    cam = _cam(SyntheticRGBDCamera)
    pose0 = cam.true_pose(0)
    for k, (a, b) in enumerate(zip(nodes, jnodes)):
        assert np.isfinite(a).all()
        truth = pose0 @ np.linalg.inv(cam.true_pose(k))
        for other in (b, truth):
            center, normal = scene_motion(a, other, pose0)
            assert center <= 5e-3 and normal <= 5e-3, (k, center, normal)
    verts = d["points"]
    jverts = io.read_ply(jpath)["points"]
    dist, _ = cKDTree(jverts).query(verts)
    assert np.median(dist) < sc.config.fusion.voxel_size, np.median(dist)
    # the pairs' batch went through register_pairs_ransac_batched
    res, infos = sc.pair_results
    assert res.transformation.shape == (len(sc.pairs), 4, 4) and infos.shape[0] == len(sc.pairs)
    assert set(sc.timer.totals) >= {"capture", "preprocess", "pairs", "pose_graph",
                                    "integrate", "extract", "save"}


def test_frames_checkpointed_and_reloaded(runs):
    jsc, _, sc, _ = runs
    out = sc.config.output_dir
    assert len(glob.glob(os.path.join(out, "color_*.png"))) == N
    assert len(glob.glob(os.path.join(out, "depth_*.png"))) == N
    re = Scanner3D(_cam(SyntheticRGBDCamera, 0), INTR, sc.config, device="cpu")
    jre = JScanner3D(_cam(JSyntheticRGBDCamera, 0), _jintr(), jsc.config)
    assert re.load_rgbd_frames(out) == jre.load_rgbd_frames(out) == N
    for (c, dep), (jc, jd), (c0, d0) in zip(re.frames, jre.frames, sc.frames):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(dep, jd)
        np.testing.assert_array_equal(c, c0)
        # the writer truncates meters x depth_scale to u16: within one unit
        scale = sc.config.stream.depth_scale
        raw = np.clip(d0.astype(np.float64) * scale, 0, 65535).astype(np.uint16)
        np.testing.assert_array_equal(dep, raw.astype(np.float32) / np.float32(scale))


def test_integrate_saved_frames_matches_the_loop_and_jax(runs):
    jsc, _, sc, _ = runs
    out = sc.config.output_dir
    cfg = sc.config
    sf = integrate_saved_frames(out, INTR, cfg, device="cpu", **KW)
    loop = StreamingFusion(None, INTR, cfg, device="cpu", **KW)
    for c, dep in io.load_rgbd_frames_batch(out, depth_scale=cfg.stream.depth_scale):
        loop._fuse_one(c, dep, cfg.fusion)
    assert sf.frames_integrated == loop.frames_integrated == N
    for name in ("tsdf", "weight", "color", "origin"):
        assert torch.equal(getattr(sf.volume, name), getattr(loop.volume, name)), name
    for a, b in zip(sf.trajectory, loop.trajectory):
        assert torch.equal(a, b)
    jsf = jintegrate_saved_frames(out, _jintr(), jsc.config, **KW)
    assert len(sf.trajectory) == len(jsf.trajectory) == N
    traj = max(float(np.abs(p.numpy() - np.asarray(q)).max())
               for p, q in zip(sf.trajectory, jsf.trajectory))
    assert traj <= 1e-4, traj
    for name in ("tsdf", "weight", "color"):
        diff = np.abs(getattr(sf.volume, name).numpy() - np.asarray(getattr(jsf.volume, name)))
        assert int((diff > 1e-4).sum()) <= 1e-3 * diff.size, name
    np.testing.assert_array_equal(sf.volume.origin.numpy(), np.asarray(jsf.volume.origin))
    with pytest.raises(FileNotFoundError):
        integrate_saved_frames(os.path.join(out, "missing"), INTR, cfg, device="cpu")
