"""Port parity: the raw-pair depth path (recon3d_tpu_torch/depth/pipeline.py)
and what it needs from calibration (calib/model.py, calib/stereo.py,
calib/npz.py) against the JAX package on the CPU.

The rig is in memory: JAX-computed stereo rectification of two pinhole
cameras with radial and tangential distortion and a small relative
rotation, so the warp plans' shifts are real. The JAX pipeline runs backend
"pallas" (its kernels in interpret mode), the port backend "cuda" on CPU
tensors (its kernels' plain versions). Bars:
  rectify_maps: bitwise (both compute in float32 on the host, op for op:
  the JAX function runs outside jit, so each operation rounds once; the
  port takes LAPACK's 3x3 inverse and the sequential 3x3 products as the
  JAX package does, and the one contraction XLA makes inside the sensor
  tilt's lax.cond); the warp plans built from them: bitwise;
  pipeline: valid equal, disparity |delta| < 1e-4 on valid pixels (the
  SGM bar, test_sgm_pallas.py:38-43), depth through z = f b / d within
  rtol 1e-4 / atol 1e-3 carried through, visualization atol 1e-3.
The frames are compared before the WLS refine (with_wls=False): with
sigma_color 1.5 almost every edge weight of this textured guide sits at the
1e-6 floor, so a run of pixels without a valid disparity makes its FGS
system nearly singular in float32, and two solvers that differ only in the
last bit of exp() give values far outside the data (up to 1e2 - 1e16 px
on a 192x64 version of this rig, on the JAX side as on the port's).
tests/test_torch_wls.py holds the WLS stage to rtol 1e-4 / atol 1e-3 on a
bounded-contrast guide, where its systems are well conditioned; here WLS
is checked for running on the pipeline's output.
SGM costs of non-integer gray levels are truncated to 16 bits, so a
last-bit difference in a map could flip a cost and move a disparity; the
maps and plans are bitwise, so the pipelines run on their own.

The JAX frame is assembled from the JAX package's own functions as
depth_step_planned / sgm_disparity_pallas assemble it, with one difference:
sgm_pallas.cost_fwd_down runs its forward scan on the cost before the
16-bit store truncates it, while every later path reads the stored cost.
On a rectified (non-integer) gray pair the aggregate S then is not
integer-valued and the finalize's packed argmin breaks (on a 192x64,
D = 32 version of this rig the JAX pipeline kept under 1 % of its pixels
valid, its XLA backend 60 %).
The reference frame therefore takes the stored cost and runs
aggregate_and_finalize(v1=None), whose standalone scans read it, as the
port's kernel path does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.calib import model as jmodel
from recon3d_tpu.calib import npz as jnpz
from recon3d_tpu.calib import stereo as jstereo
from recon3d_tpu.camera.fake import FakeStereoCamera
from recon3d_tpu.config import StereoMatcherConfig as JMatcher
from recon3d_tpu.config import WLSConfig as JWLS
from recon3d_tpu.depth import matcher as jmatcher
from recon3d_tpu.depth import pipeline as jpipeline
from recon3d_tpu.depth import sgm as jsgm
from recon3d_tpu.depth import sgm_pallas, wls_pallas
from recon3d_tpu.ops import image as jimage
from recon3d_tpu.ops import warp as jwarp
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.calib import model, npz, stereo
from recon3d_tpu_torch.depth import DepthPipeline, depth_step, pipeline

W, H, D = 128, 48, 16
PLAN_FIELDS = ("vy", "hx", "valid", "v_coarse", "h_coarse", "v_resid_bound",
               "h_resid_bound", "v_coarse_bits", "h_coarse_bits")


def _rig(dist_len=5):
    """JAX StereoParams of a rectified rig: nonzero k1, small rotations."""
    K1 = np.array([[160.0, 0.0, W / 2 + 1.5], [0.0, 161.0, H / 2 - 1.0], [0, 0, 1]])
    K2 = np.array([[158.0, 0.0, W / 2 - 2.0], [0.0, 159.5, H / 2 + 0.5], [0, 0, 1]])
    d = np.zeros((1, dist_len))
    d[0, :4] = (-0.12, 0.03, 0.001, -0.0008)
    if dist_len == 14:
        d[0, 12:] = (0.01, -0.005)  # sensor tilt
    R = np.asarray(jmodel.rodrigues(jnp.asarray([0.004, -0.006, 0.003], jnp.float32)))
    T = np.array([[-0.05], [0.0005], [0.0]])
    rect = jstereo.stereo_rectify(K1, d, K2, d * 0.9, (W, H), R, T)
    return jnpz.StereoParams(mtx1=K1, dist1=d, mtx2=K2, dist2=d * 0.9, R=R, T=T,
                             R1=np.asarray(rect.R1, np.float64),
                             R2=np.asarray(rect.R2, np.float64),
                             P1=np.asarray(rect.P1, np.float64),
                             P2=np.asarray(rect.P2, np.float64),
                             Q=np.asarray(rect.Q, np.float64))


def _raw_pair(seed=1):
    gl, gr, _, _ = FakeStereoCamera(width=W, height=H, focal=80.0, baseline=0.05).render(seed)
    return gl.astype(np.float32), gr.astype(np.float32)


def _port_params(jp):
    return convert.stereo_params(dataclasses.asdict(jp))


@pytest.mark.parametrize("dist_len", [5, 14])
def test_rectify_maps_match(dist_len):
    jp = _rig(dist_len)
    tp = _port_params(jp)
    for K, dist, R, P in ((jp.mtx1, jp.dist1, jp.R1, jp.P1), (jp.mtx2, jp.dist2, jp.R2, jp.P2)):
        ref = jstereo.rectify_maps(K, dist, R, P, (W, H))
        out = stereo.rectify_maps(K, dist, R, P, (W, H), device="cpu")
        for o, r in zip(out, ref):
            assert o.dtype == torch.float32 and o.shape == (H, W)
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # jnp.asarray makes the float64 vector float32 with 64-bit floats off;
    # the port's pad_dist keeps the dtype it is given
    np.testing.assert_array_equal(
        model.pad_dist(torch.as_tensor(tp.dist1, dtype=torch.float32)).numpy(),
        np.asarray(jmodel.pad_dist(jnp.asarray(jp.dist1))))
    np.testing.assert_allclose(model.tilt_matrix(0.01, -0.005).numpy(),
                               np.asarray(jmodel.tilt_matrix(0.01, -0.005, jnp.float32)),
                               atol=1e-6)


def test_stereo_params_roundtrip_and_validation(tmp_path):
    jp = _rig()
    tp = _port_params(jp)
    assert tp.baseline == pytest.approx(jp.baseline, rel=1e-12)
    assert npz.STEREO_FULL_KEYS == jnpz.STEREO_FULL_KEYS
    assert npz.DEPTH_REQUIRED_KEYS == jnpz.DEPTH_REQUIRED_KEYS
    tp.save(str(tmp_path / "full.npz"))
    back = npz.StereoParams.load(str(tmp_path / "full.npz"))
    ref = jnpz.StereoParams.load(str(tmp_path / "full.npz"))  # the JAX loader reads it too
    for f in dataclasses.fields(npz.StereoParams):
        a, b = getattr(back, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    back.validate_for_depth()
    np.savez(str(tmp_path / "raw.npz"), k1=jp.mtx1, d1=jp.dist1[0], k2=jp.mtx2, d2=jp.dist2[0],
             R=jp.R, T=jp.T.ravel())
    raw = npz.StereoParams.load(str(tmp_path / "raw.npz"))
    assert raw.T.shape == (3, 1) and raw.dist1.shape == (1, 5) and raw.R1 is None
    with pytest.raises(KeyError, match="R1"):
        raw.validate_for_depth()
    # a raw-schema NPZ: from_npz rectifies it in float32 on the host, as the
    # JAX package does with 64-bit floats off
    jpipe = jpipeline.DepthPipeline.from_npz(str(tmp_path / "raw.npz"), (W, H))
    tpipe = DepthPipeline.from_npz(str(tmp_path / "raw.npz"), (W, H), device="cpu")
    for k in ("R1", "R2", "P1", "P2", "Q"):
        ref = np.asarray(getattr(jpipe.params, k))
        np.testing.assert_allclose(getattr(tpipe.params, k), ref, rtol=2e-6,
                                   atol=2e-6 * np.abs(ref).max(), err_msg=k)
    for o, r in zip(tpipe.maps, jpipe.maps):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-3)
    np.savez(str(tmp_path / "bad.npz"), k=jp.mtx1)
    with pytest.raises(ValueError, match="unrecognized"):
        npz.StereoParams.load(str(tmp_path / "bad.npz"))


def _pipelines(mcfg):
    jp = _rig()
    jpipe = jpipeline.DepthPipeline(jp, (W, H), matcher_config=mcfg, wls_config=JWLS())
    st = convert.convert_state(dataclasses.asdict(mcfg), dataclasses.asdict(JWLS()), jp.Q,
                               device="cpu")
    tpipe = DepthPipeline(_port_params(jp), (W, H), matcher_config=st.matcher,
                          wls_config=st.wls, device="cpu")
    return jpipe, tpipe


def _jax_frame(lg, rg, Q, mcfg, wcfg, with_wls):
    """The JAX package's frame after rectification (matcher.compute_disparity
    on backend "pallas", interpret mode, then depth and the jet view), with
    the SGM paths all on the stored 16-bit cost (module docstring)."""
    num_directions = {"sgm8": 8, "sgm3": 3}.get(mcfg.mode, 4)
    p1, p2 = float(mcfg.p1()), float(mcfg.p2())
    HP, WP, DP = 64 * -(-H // 64), 128 * -(-W // 128), 128 * -(-D // 128)
    cost, _ = sgm_pallas.cost_fwd_down(lg, rg, D, 0, mcfg.block_size, mcfg.pre_filter_cap,
                                       p1, p2, HP, WP, DP, num_directions >= 4, True)
    disp, valid = sgm_pallas.aggregate_and_finalize(
        cost, p1, p2, D, mcfg.uniqueness_ratio, mcfg.disp12_max_diff, mcfg.subpixel, W, True,
        v1=None, final_dir="up" if num_directions >= 4 else "down",
        with_diag=num_directions == 8)
    disp, valid = disp[:H, :W], valid[:H, :W]
    valid = jsgm.speckle_filter_fast(disp, valid, float(mcfg.speckle_range),
                                     mcfg.speckle_window_size, max_disparity=DP)
    disp = jnp.where(valid, disp, -1.0)
    if with_wls:
        disp = wls_pallas.wls_refine_pallas(disp, valid, lg, wcfg.lam, wcfg.sigma_color,
                                            wcfg.iterations, interpret=True)
        valid = disp > 0
    depth = jmatcher.disparity_to_depth(disp, Q)
    vis = jimage.colormap_jet(jimage.normalize_minmax(jnp.where(valid, disp, 0.0), 0.0, 1.0))
    return disp, depth, vis


def _jax_planned(left, right, plans, Q, mcfg, wcfg, with_wls):
    lg, rg = (jwarp.remap_two_pass_pallas(jnp.asarray(img), plan, interpret=True)
              for img, plan in ((left, plans[0]), (right, plans[1])))
    return _jax_frame(lg, rg, Q, mcfg, wcfg, with_wls)


def _assert_frame_close(out, ref):
    (d_t, z_t, vis_t), (d_j, z_j, vis_j) = out, [np.asarray(a) for a in ref]
    assert d_t.shape == (H, W) and z_t.shape == (H, W) and vis_t.shape == (H, W, 3)
    valid = d_j > 0
    np.testing.assert_array_equal(d_t.numpy() > 0, valid)
    assert valid.mean() > 0.4
    assert np.abs(d_t.numpy() - d_j)[valid].max() < 1e-4
    np.testing.assert_array_equal(d_t.numpy()[~valid], d_j[~valid])
    bound = np.abs(z_j[valid]) * (1e-4 + 1e-3 / d_j[valid])
    assert (np.abs(z_t.numpy() - z_j)[valid] <= bound + 1e-6).all()
    np.testing.assert_array_equal(z_t.numpy()[~valid], z_j[~valid])
    np.testing.assert_allclose(vis_t.numpy(), vis_j, atol=1e-3)


def test_pipeline_process_matches_jax():
    """DepthPipeline.process (two-pass warp, tuned sgm4) against the JAX
    frame on backend "pallas"; then the same pipeline with its WLS refine."""
    mcfg, wcfg = JMatcher.tuned(num_disparities=D, backend="pallas"), JWLS()
    jpipe, tpipe = _pipelines(mcfg)
    assert jpipe.plans is not None and tpipe.plans is not None
    for tplan, jplan in zip(tpipe.plans, jpipe.plans):  # the port's own plans, bitwise
        for k in PLAN_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(tplan, k)),
                                          np.asarray(getattr(jplan, k)), err_msg=k)
    tpipe.with_wls = False
    left, right = _raw_pair()
    ref = _jax_planned(left, right, jpipe.plans, jpipe.Q, mcfg, wcfg, False)
    out = tpipe.process(torch.tensor(left), torch.tensor(right))
    _assert_frame_close(out, ref)
    # process takes what a camera gives (numpy, 3-channel) as the JAX one does
    rgb_l, rgb_r = (np.repeat(a[..., None], 3, -1) for a in (left, right))
    np.testing.assert_array_equal(tpipe.process(rgb_l, rgb_r)[0].numpy(), out[0].numpy())
    tpipe.with_wls = True
    disp, depth, vis = tpipe.process(torch.tensor(left), torch.tensor(right))
    assert disp.shape == depth.shape == (H, W) and vis.shape == (H, W, 3)
    assert torch.isfinite(disp).all() and (disp > 0).float().mean() > 0.9


def test_depth_step_matches_jax():
    """depth_step (gather remap) and depth_step_planned on the port's own
    maps / plans, sgm3 without WLS (the mode the reference runs)."""
    mcfg, wcfg = JMatcher(num_disparities=D, mode="sgm3", backend="pallas"), JWLS()
    jpipe, tpipe = _pipelines(mcfg)
    left, right = _raw_pair(seed=2)
    maps = [np.asarray(m) for m in jpipe.maps]
    remap = jax.jit(jimage.remap)  # as depth_step runs it, inside one program
    ref = _jax_frame(remap(jnp.asarray(left), *maps[:2]), remap(jnp.asarray(right), *maps[2:]),
                     jpipe.Q, mcfg, wcfg, False)
    for tm, jm in zip(tpipe.maps, maps):
        np.testing.assert_array_equal(tm.numpy(), jm)
    out = depth_step(torch.tensor(left), torch.tensor(right), *tpipe.maps,
                     tpipe.Q, tpipe.matcher_config, tpipe.wls_config, False)
    _assert_frame_close(out, ref)
    ref = _jax_planned(left, right, jpipe.plans, jpipe.Q, mcfg, wcfg, False)
    out = pipeline.depth_step_planned(torch.tensor(left), torch.tensor(right), *tpipe.plans,
                                      tpipe.Q, tpipe.matcher_config, tpipe.wls_config, False)
    _assert_frame_close(out, ref)


class _Camera:
    def __init__(self, frames):
        self.frames = list(frames)
        self.reads = 0

    def read(self):
        self.reads += 1
        if self.reads == 2:  # one dropped frame: the loop reads again
            return False, None
        return True, (self.frames[self.reads % len(self.frames)],)


def test_from_npz_adjust_and_run(tmp_path):
    jp = _rig()
    path = str(tmp_path / "rig.npz")
    _port_params(jp).save(path)
    pipe = DepthPipeline.from_npz(path, (W, H), matcher_config=convert.matcher_config(
        dataclasses.asdict(JMatcher(num_disparities=16, block_size=3, mode="sgm3"))),
        device="cpu")
    pipe.adjust("w")
    pipe.adjust("e")
    assert pipe.matcher_config.num_disparities == 32 and pipe.wls_config.lam == 16000.0
    left, right = _raw_pair()
    seen = []
    n = pipe.run(_Camera([left]), _Camera([right]), max_frames=3,
                 on_frame=lambda i, out: seen.append(out[0].shape))
    assert n == 3 and seen == [(H, W)] * 3
    assert pipe.run(_Camera([left]), _Camera([right]), on_frame=lambda i, out: False) == 1


def test_depth_exports():
    import recon3d_tpu_torch.depth as tdepth

    assert tdepth.DepthPipeline is pipeline.DepthPipeline and tdepth.depth_step is depth_step
