"""Port parity for the whole fusion-and-meshing slice, recon3d_tpu_torch
against the JAX package on the CPU: posed RGB-D frames -> integrate x 3 ->
extract_triangle_mesh -> filter_smooth_laplacian (MeshConfig's 5
iterations) -> cleanup -> compute_vertex_normals -> binary PLY, the steps
of Scanner3D.extract_mesh / save_mesh (pipeline/offline.py:194-208) driven
from the camera's true poses.

R = 64 (voxel 0.016, sdf_trunc 0.05, origin (-0.512, -0.512, 0.902): the
slice's origin, at a quarter of its resolution and four times its voxel),
SyntheticRGBDCamera(160, 120, fx = fy = 130), 3 frames, FusionConfig's
depth_trunc and color. Bars: the volume, every mesh stage and the PLY file
bitwise / byte-identical, and the mesh on the scene's sphere and plane.
Also PointCloudProcessing.process_point_cloud(path) on a PLY the JAX
package wrote (the masks equal, the points rtol 1e-6 / atol 1e-6: the bars
of the point-cloud slice).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu import config as jconfig
from recon3d_tpu import pointcloud_processing as jpp
from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.fusion import marching as jm
from recon3d_tpu.fusion import tsdf as jt
from recon3d_tpu.mesh import ops as jo
from recon3d_tpu.utils import io as jio
from recon3d_tpu.utils.types import CameraIntrinsics as JCameraIntrinsics
from recon3d_tpu_torch import convert, pointcloud_processing
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.fusion import marching as tm
from recon3d_tpu_torch.fusion import tsdf as tt
from recon3d_tpu_torch.mesh import ops as to
from recon3d_tpu_torch.utils import io as tio
from recon3d_tpu_torch.utils.types import CameraIntrinsics

R, VOXEL, TRUNC, ORIGIN = 64, 0.016, 0.05, (-0.512, -0.512, 0.902)
W, H, F, N_FRAMES = 160, 120, 130.0, 3

@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: several test workers share one host, and more
    threads a worker oversubscribe its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)



def _jax_slice(frames, fusion, mesh_cfg, path):
    intr = JCameraIntrinsics(fx=jnp.float32(F), fy=jnp.float32(F), cx=jnp.float32(W / 2 - 0.5),
                             cy=jnp.float32(H / 2 - 0.5))
    vol = jt.make_volume(resolution=R, voxel_size=VOXEL, sdf_trunc=TRUNC, origin=ORIGIN,
                         with_color=fusion.color)
    for c, d, pose in frames:
        vol = jt.integrate(vol, jnp.asarray(d), intr, jnp.asarray(pose), color=jnp.asarray(c),
                           depth_trunc=fusion.depth_trunc)
    stages = [jm.extract_triangle_mesh(vol)]
    stages.append(jo.filter_smooth_laplacian(stages[-1],
                                             iterations=mesh_cfg.smoothing_iterations))
    stages.append(jo.cleanup(stages[-1]))
    stages.append(jo.compute_vertex_normals(stages[-1]))
    jio.write_triangle_mesh(path, stages[-1])
    return vol, stages


def _port_slice(frames, fusion, mesh_cfg, path):
    intr = CameraIntrinsics(F, F, W / 2 - 0.5, H / 2 - 0.5)
    vol = tt.make_volume(resolution=R, voxel_size=VOXEL, sdf_trunc=TRUNC, origin=ORIGIN,
                         with_color=fusion.color, device="cpu")
    for c, d, pose in frames:
        vol = tt.integrate(vol, torch.tensor(d), intr, torch.tensor(pose), color=torch.tensor(c),
                           depth_trunc=fusion.depth_trunc)
    stages = [tm.extract_triangle_mesh(vol)]
    stages.append(to.filter_smooth_laplacian(stages[-1], mesh_cfg.smoothing_iterations))
    stages.append(to.cleanup(stages[-1]))
    stages.append(to.compute_vertex_normals(stages[-1]))
    tio.write_triangle_mesh(path, stages[-1])
    return vol, stages


@pytest.fixture(scope="module")
def frames():
    cam = SyntheticRGBDCamera(W, H, fx=F, fy=F, n_frames=N_FRAMES)
    jcam = JSyntheticRGBDCamera(W, H, fx=F, fy=F, n_frames=N_FRAMES)
    cam.open()
    jcam.open()
    out = []
    for k in range(N_FRAMES):
        (c, d), (jc, jd) = cam.grab(), jcam.grab()
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(d, jd)
        out.append((c, d, cam.true_pose(k).astype(np.float32)))
    return out


def test_fusion_slice_matches_jax(frames, tmp_path):
    fusion = convert.fusion_config(dataclasses.asdict(jconfig.FusionConfig()))
    mesh_cfg = convert.mesh_config(dataclasses.asdict(jconfig.MeshConfig()))
    jvol, jstages = _jax_slice(frames, jconfig.FusionConfig(), jconfig.MeshConfig(),
                               str(tmp_path / "jax.ply"))
    tvol, tstages = _port_slice(frames, fusion, mesh_cfg, str(tmp_path / "port.ply"))
    for name in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(tvol, name).numpy(), np.asarray(getattr(jvol, name)))
    for stage, (js, ts) in zip(("extract", "smooth", "cleanup", "normals"),
                               zip(jstages, tstages)):
        for f in dataclasses.fields(js):
            a, b = getattr(js, f.name), getattr(ts, f.name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=f"{stage}: {f.name}")
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()

    # the mesh lies on the scene: the sphere (center (0, 0, 1.2), r 0.3) and
    # the plane z = 1.8, within a voxel at the median
    back = tio.read_triangle_mesh(str(tmp_path / "port.ply"))
    v = back["points"]
    assert len(v) > 5000 and len(back["triangles"]) > 10000
    d_sph = np.abs(np.linalg.norm(v - np.array([0.0, 0.0, 1.2]), axis=1) - 0.3)
    near_s, near_p = d_sph < 0.05, np.abs(v[:, 2] - 1.8) < 0.05
    assert near_s.sum() > 500 and near_p.sum() > 500
    assert np.median(d_sph[near_s]) < VOXEL and np.median(np.abs(v[near_p, 2] - 1.8)) < VOXEL
    n = back["normals"]
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)


def test_processing_reads_a_ply_the_jax_package_wrote(frames, tmp_path):
    """extract_point_cloud's surface points written by the JAX writer, then
    PointCloudProcessing.process_point_cloud(path) in both packages."""
    vol = jt.make_volume(resolution=R, voxel_size=VOXEL, sdf_trunc=TRUNC, origin=ORIGIN)
    intr = JCameraIntrinsics(fx=jnp.float32(F), fy=jnp.float32(F), cx=jnp.float32(W / 2 - 0.5),
                             cy=jnp.float32(H / 2 - 0.5))
    for c, d, pose in frames:
        vol = jt.integrate(vol, jnp.asarray(d), intr, jnp.asarray(pose), color=jnp.asarray(c))
    path = str(tmp_path / "surface.ply")
    n = jio.write_point_cloud(path, jt.extract_point_cloud(vol, capacity=1 << 13))
    assert n > 1000
    # the defaults' 1 cm radius filter suits 2.5 mm scans, not a 1.6 cm grid
    cfg = jconfig.ProcessingConfig(voxel_size=0.008, radius=0.04, radius_nb_points=8)
    jq = jpp.PointCloudProcessing(cfg).process_point_cloud(path)
    tq = pointcloud_processing.PointCloudProcessing(
        convert.processing_config(dataclasses.asdict(cfg))).process_point_cloud(path, device="cpu")
    v = np.asarray(jq.valid)
    np.testing.assert_array_equal(tq.valid.numpy(), v)
    assert 0 < v.sum() < n
    for name in ("points", "colors"):
        np.testing.assert_allclose(getattr(tq, name).numpy()[v], np.asarray(getattr(jq, name))[v],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
