"""Port parity for K9's sampler and the TSDF module: recon3d_tpu_torch's
plain versions (CPU tensors) against the jitted JAX functions on the CPU.

K9: bitwise against the Pallas sampler (interpret mode) on in-window
projection fields, and against the XLA gather `img[:, vc, uc]` on fields
scattered over the whole image, where the Pallas kernel reads 0 outside its
64 x 128 window and the port, a gather, misses no pixel.

TSDF: an R = 64 volume (voxel 0.016, sdf_trunc 0.05, origin (-0.512,
-0.512, 0.902): the sphere z 0.9-1.5 and the plane z = 1.8 inside) fed
SyntheticRGBDCamera(160, 120, fx = fy = 130) frames at their true poses,
as tests/test_fusion.py integrates them. Bars: each frame's contribution
and update mask bitwise; tsdf, weight and color bitwise after every frame
(so the projected pixels are the JAX program's); the changed-z profile
equal; integrate_frames, extract_point_cloud and the checkpoint round trip
bitwise. The port
reproduces XLA's CPU rounding of the jitted integrate: the voxel centers,
the camera transform and the running averages as fused multiply-adds, the
uint8 colors times the float32 reciprocal of 255.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.fusion import tsdf as jt
from recon3d_tpu.ops.project_sample import sample_images_at as j_sample_images_at
from recon3d_tpu.utils.types import CameraIntrinsics as JCameraIntrinsics
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.fusion import tsdf as tt
from recon3d_tpu_torch.ops.project_sample import sample_images_at
from recon3d_tpu_torch.ops.project_sample_cuda import sample_images_cuda
from recon3d_tpu_torch.ops.tsdf_fuse_cuda import fuse_voxels_cuda
from recon3d_tpu_torch.utils import types
from recon3d_tpu_torch.utils.types import CameraIntrinsics

VOLUME = dict(resolution=64, voxel_size=0.016, sdf_trunc=0.05, origin=(-0.512, -0.512, 0.902))
CAMERA = dict(width=160, height=120, fx=130.0, fy=130.0, n_frames=3)

@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: several test workers share one host, and more
    threads a worker oversubscribe its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)



def _projection_fields(R, H, W, fx=200.0):
    """tests/test_project_sample.py's in-window fields: a real perspective
    projection of an R^3 volume, clipped as _frame_contrib clips it."""
    idx = np.arange(R, dtype=np.float32)
    gx, gy, gz = np.meshgrid(idx, idx, idx, indexing="ij")
    vs = 1.0 / R
    x, y, z = gx * vs - 0.5, gy * vs - 0.5, gz * vs + 1.0
    uc = np.clip(np.round(fx * x / z + W / 2).astype(np.int32), 0, W - 1)
    vc = np.clip(np.round(fx * y / z + H / 2).astype(np.int32), 0, H - 1)
    return vc, uc


def test_sampler_matches_pallas_on_projection_fields():
    rng = np.random.RandomState(3)
    H, W, R = 480, 640, 32
    img = rng.rand(4, H, W).astype(np.float32)
    vc, uc = _projection_fields(R, H, W)
    ref = np.asarray(j_sample_images_at(jnp.asarray(vc), jnp.asarray(uc), jnp.asarray(img),
                                        interpret=True))
    out = sample_images_at(torch.tensor(vc), torch.tensor(uc), torch.tensor(img))
    assert out.shape == (4, R, R, R)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampler_reads_every_pixel_where_the_pallas_window_misses():
    rng = np.random.RandomState(4)
    H, W, R = 480, 640, 32
    img = 0.5 + rng.rand(1, H, W).astype(np.float32)  # strictly nonzero
    vc = rng.randint(0, H, size=(R, R, R)).astype(np.int32)
    uc = rng.randint(0, W, size=(R, R, R)).astype(np.int32)
    pallas = np.asarray(j_sample_images_at(jnp.asarray(vc), jnp.asarray(uc), jnp.asarray(img),
                                           interpret=True))
    out = sample_images_at(torch.tensor(vc), torch.tensor(uc), torch.tensor(img)).numpy()
    np.testing.assert_array_equal(out, img[:, vc, uc])  # the XLA gather
    hit = pallas != 0.0
    assert 0.0 < hit.mean() < 1.0 and (out != 0.0).all()
    np.testing.assert_array_equal(out[hit], pallas[hit])


def test_sampler_checks_its_inputs():
    img = torch.zeros((2, 4, 5))
    vc = torch.zeros((3, 3, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        sample_images_at(vc.long(), vc, img)
    with pytest.raises(ValueError, match="float32"):
        sample_images_at(vc, vc, img.double())
    with pytest.raises(ValueError, match="different devices"):
        sample_images_at(vc, vc, img.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):  # K9 itself: no CPU route
        sample_images_cuda(vc, vc, img)


def _fuse_inputs(R=4, H=5, W=6):
    """Valid CPU inputs of the TSDF fuse kernel's wrapper, fold mode."""
    vol = tt.make_volume(resolution=R, device="cpu")
    return dict(origin=vol.origin, voxel_size=vol.voxel_size, sdf_trunc=vol.sdf_trunc,
                resolution=R, depth=torch.zeros((H, W)),
                color=torch.zeros((H, W, 3), dtype=torch.uint8), extrinsic=torch.eye(4),
                intr=CameraIntrinsics(1.0, 1.0, 1.0, 1.0), depth_trunc=3.0,
                old=(vol.tsdf, vol.weight, vol.color), weight_max=64.0)


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA tensors"),  # valid inputs on the CPU: the kernel has no CPU route
    ({"old": None}, "CUDA tensors"),  # the contribution mode alike
    ({"depth": torch.zeros((5, 6), device="meta")}, "different devices"),
    ({"resolution": 0}, "resolution"),
    ({"depth": torch.zeros((5, 6), dtype=torch.float64)}, "depth"),
    ({"depth": torch.zeros((5, 6, 1))}, "depth"),
    ({"depth": torch.zeros((6, 5)).t()}, "contiguous"),
    ({"color": torch.zeros((5, 6, 3), dtype=torch.int32)}, "color"),
    ({"color": torch.zeros((5, 6, 4), dtype=torch.uint8)}, "color"),
    ({"extrinsic": torch.eye(3)}, "extrinsic"),
    ({"extrinsic": torch.eye(4, dtype=torch.float64)}, "extrinsic"),
    ({"origin": torch.zeros(4)}, "origin"),
    ({"voxel_size": torch.tensor([0.004])}, "voxel_size"),
    ({"sdf_trunc": torch.tensor(0.02, dtype=torch.float64)}, "sdf_trunc"),
    ({"old": (torch.zeros((4, 4, 5)), torch.zeros((4, 4, 4)), None)}, "tsdf"),
    ({"old": (torch.zeros((4, 4, 4)), torch.zeros((4, 4, 4), dtype=torch.float16), None)},
     "weight"),
    ({"old": (torch.zeros((4, 4, 4)), torch.zeros((4, 4, 4)), None)}, "volume with color"),
    ({"old": (torch.zeros((4, 4, 4)), torch.zeros((4, 4, 4)), torch.zeros((4, 4, 4, 4)))},
     "volume color"),
])
def test_fuse_kernel_checks_its_inputs(change, match):
    """The TSDF fuse kernel's wrapper refuses what the kernel does not take:
    CPU and meta tensors, wrong dtypes, shapes and layouts, a non-4x4 pose."""
    before = fuse_voxels_cuda.launches
    with pytest.raises(ValueError, match=match):
        fuse_voxels_cuda(**{**_fuse_inputs(), **change})
    assert fuse_voxels_cuda.launches == before


def test_fuse_kernel_launcher_is_registered():
    """The launcher the wrapper calls is the source's, with as many
    arguments as SIGNATURES gives it (the stream last)."""
    import re

    from recon3d_tpu_torch import kernels

    src = (kernels.CSRC / "tsdf_fuse.cu").read_text()
    decl = re.search(r'extern "C" int (r3d_\w+)\(([^)]*)\)', src)
    assert decl.group(1) == "r3d_tsdf_fuse" and decl.group(1) in kernels.SIGNATURES
    params = [p.strip() for p in decl.group(2).split(",")]
    assert len(params) == len(kernels.SIGNATURES["r3d_tsdf_fuse"])
    assert params[-1] == "cudaStream_t stream"
    assert kernels.SIGNATURES["r3d_tsdf_fuse"][-1] is kernels.ctypes.c_void_p


@pytest.fixture(scope="module")
def frames():
    j, t = JSyntheticRGBDCamera(**CAMERA), SyntheticRGBDCamera(**CAMERA)
    j.open()
    t.open()
    out = []
    for k in range(CAMERA["n_frames"]):
        (cj, dj), (ct, dtp) = j.grab(), t.grab()
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(dtp, dj)
        np.testing.assert_array_equal(t.true_pose(k), j.true_pose(k))
        out.append((ct, dtp, t.true_pose(k).astype(np.float32)))
    return out


def _intrinsics():
    f, cx, cy = CAMERA["fx"], CAMERA["width"] / 2 - 0.5, CAMERA["height"] / 2 - 0.5
    return (JCameraIntrinsics(fx=jnp.float32(f), fy=jnp.float32(f), cx=jnp.float32(cx),
                              cy=jnp.float32(cy)), CameraIntrinsics(f, f, cx, cy))


def _volumes(with_color=True):
    return (jt.make_volume(**VOLUME, with_color=with_color),
            tt.make_volume(**VOLUME, with_color=with_color, device="cpu"))


def _assert_volume_equal(tv, jv, what):
    for name in ("tsdf", "weight", "color", "origin", "voxel_size", "sdf_trunc"):
        a, b = getattr(jv, name), getattr(tv, name)
        assert (a is None) == (b is None), (what, name)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}")


@pytest.mark.parametrize("with_color", [True, False])
def test_integrate_matches_jax_every_frame(frames, with_color):
    ji, ti = _intrinsics()
    jv, tv = _volumes(with_color)
    before = fuse_voxels_cuda.launches  # CPU tensors: the plain version, no launch
    for k, (c, d, pose) in enumerate(frames):
        jv = jt.integrate(jv, jnp.asarray(d), ji, jnp.asarray(pose),
                          color=jnp.asarray(c) if with_color else None)
        tv = tt.integrate(tv, torch.tensor(d), ti, torch.tensor(pose),
                          color=torch.tensor(c) if with_color else None)
        _assert_volume_equal(tv, jv, f"frame {k}")
    assert fuse_voxels_cuda.launches == before
    w = tv.weight.numpy()
    assert w.max() == 3.0 and 0.05 < (w > 0).mean() < 0.95


def test_frame_contrib_matches_jax(frames):
    """One frame's summand (w * tsdf_new, the update mask w_new, w * color)
    from an empty volume, bitwise against the jitted JAX _frame_contrib."""
    ji, ti = _intrinsics()
    jv, tv = _volumes()
    j_contrib = jax.jit(jt._frame_contrib)
    for c, d, pose in frames:
        jout = j_contrib(jv, jnp.asarray(d), ji, jnp.asarray(pose), jnp.asarray(c))
        tout = tt._frame_contrib(tv, torch.tensor(d), ti, torch.tensor(pose), torch.tensor(c))
        for name, a, b in zip(("n", "w_new", "cf"), jout, tout):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        assert 0.05 < float(tout[1].mean()) < 0.95


def test_integrate_changed_z_and_donated_match_jax(frames):
    ji, ti = _intrinsics()
    jv, tv = _volumes()
    donated = tt.make_volume(**VOLUME, device="cpu")
    # the JAX package traces with_changed_z statically (fusion/incremental.py)
    j_changed = jax.jit(lambda v, d, e, c: jt._integrate(v, d, ji, e, color=c,
                                                         with_changed_z=True,
                                                         changed_weight_min=2.0))
    for c, d, pose in frames:
        jv, jz = j_changed(jv, jnp.asarray(d), jnp.asarray(pose), jnp.asarray(c))
        tv, tz = tt.integrate(tv, torch.tensor(d), ti, torch.tensor(pose),
                              color=torch.tensor(c), with_changed_z=True,
                              changed_weight_min=2.0)
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        buf = donated.tsdf
        out = tt.integrate_donated(donated, torch.tensor(d), ti, torch.tensor(pose),
                                   color=torch.tensor(c))
        assert out.tsdf is buf and torch.equal(buf, tv.tsdf)
        assert torch.equal(donated.weight, tv.weight) and torch.equal(donated.color, tv.color)
    assert 0 < int(tz.sum()) < VOLUME["resolution"]
    _assert_volume_equal(tv, jv, "changed_z")


def test_integrate_frames_matches_jax(frames):
    """The three frames as one batch. (At a batch of 2 XLA's (3, 6) product
    rounds one column otherwise: tsdf.integrate_frames' docstring.)"""
    ji, ti = _intrinsics()
    jv, tv = _volumes()
    stack = [np.stack([f[i] for f in frames]) for i in range(3)]
    jv = jt.integrate_frames(jv, jnp.asarray(stack[1]), ji, jnp.asarray(stack[2]),
                             colors=jnp.asarray(stack[0]))
    buf = tv.tsdf
    tv = tt.integrate_frames(tv, torch.tensor(stack[1]), ti, torch.tensor(stack[2]),
                             colors=torch.tensor(stack[0]))
    assert tv.tsdf is buf and tv.weight.max() == 3.0
    _assert_volume_equal(tv, jv, "integrate_frames")


@pytest.fixture(scope="module")
def fused(frames):
    """The JAX volume after the three frames, and the port's copy of it."""
    ji, _ = _intrinsics()
    jv = jt.make_volume(**VOLUME)
    for c, d, pose in frames:
        jv = jt.integrate(jv, jnp.asarray(d), ji, jnp.asarray(pose), color=jnp.asarray(c))
    arrays = {f.name: np.asarray(getattr(jv, f.name)) for f in dataclasses.fields(jv)}
    return jv, convert.tsdf_volume(arrays, device="cpu")


@pytest.mark.parametrize("capacity,weight_min", [(1 << 14, 1.0), (1 << 11, 2.0)])
def test_extract_point_cloud_matches_jax(fused, capacity, weight_min):
    jv, tv = fused
    jp = jt.extract_point_cloud(jv, capacity=capacity, weight_min=weight_min)
    tp = tt.extract_point_cloud(tv, capacity=capacity, weight_min=weight_min)
    for name in ("points", "colors", "valid"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert tp.capacity == capacity and 0 < int(tp.valid.sum()) <= capacity


def test_checkpoints_load_in_either_package(fused, tmp_path):
    jv, tv = fused
    tt.save_volume(str(tmp_path / "port.npz"), tv)
    jt.save_volume(str(tmp_path / "jax.npz"), jv)
    _assert_volume_equal(tt.load_volume(str(tmp_path / "jax.npz"), device="cpu"), jv, "load")
    _assert_volume_equal(tv, jt.load_volume(str(tmp_path / "port.npz")), "save")


def test_converters_and_configs():
    from recon3d_tpu import config as jconfig
    from recon3d_tpu_torch import config

    assert convert.fusion_config(dataclasses.asdict(jconfig.FusionConfig())) == \
        config.FusionConfig()
    assert convert.mesh_config(dataclasses.asdict(jconfig.MeshConfig())) == config.MeshConfig()
    assert dataclasses.asdict(config.FusionConfig()) == dataclasses.asdict(jconfig.FusionConfig())
    frame = types.RGBDImage(color=torch.zeros((5, 7, 3)), depth=torch.zeros((5, 7)))
    assert frame.shape == (5, 7)
    vol = tt.make_volume(resolution=4, device="cpu")
    assert vol.resolution == 4 and vol.color.shape == (4, 4, 4, 3)
    with pytest.raises(ValueError, match="4x4"):
        tt.integrate(vol, torch.zeros((3, 4)), CameraIntrinsics(1.0, 1.0, 1.0, 1.0),
                     torch.eye(3))
