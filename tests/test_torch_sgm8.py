"""Port parity: 8-direction SGM on the kernel path (K5, the diagonal pairs)
and aggregate_and_finalize without v1 (K14, the standalone scans),
recon3d_tpu_torch against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port runs each
kernel wrapper's plain PyTorch version (CPU tensors). All SGM arithmetic is
integer-valued f32, so the bars are those of test_torch_cost_sgm.py: path
volumes exact; valid masks equal and |delta disp| < 1e-4 on valid pixels.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import FakeStereoCamera
from recon3d_tpu.config import StereoMatcherConfig as JMatcher
from recon3d_tpu.config import WLSConfig as JWLS
from recon3d_tpu.depth import sgm as jsgm
from recon3d_tpu.depth import sgm_pallas
from recon3d_tpu_torch import config, convert
from recon3d_tpu_torch.depth import sgm_cuda

PACK_CLAMP = 2.0 ** 24 / 128 - 1  # K4's clamp of S at DP = 128: 131071


def _pair(H, W, seed=1):
    gl, gr, _, _ = FakeStereoCamera(width=W, height=H, focal=80.0, baseline=0.05).render(seed)
    return gl.astype(np.float32), gr.astype(np.float32)


def _accurate(D, bs):
    """The JAX accuracy preset and the port's, carried across by convert."""
    j = JMatcher.accurate(num_disparities=D, block_size=bs, backend="pallas")
    t = convert.convert_state(dataclasses.asdict(j), dataclasses.asdict(JWLS()), np.eye(4),
                              device="cpu").matcher
    return j, t


def _kw(m):
    return dict(num_disparities=m.num_disparities, block_size=m.block_size,
                p1=float(m.p1()), p2=float(m.p2()), num_directions=8,
                uniqueness_ratio=m.uniqueness_ratio, disp12_max_diff=m.disp12_max_diff,
                speckle_window_size=m.speckle_window_size,
                speckle_range=float(m.speckle_range), pre_filter_cap=m.pre_filter_cap)


def test_accurate_preset_matches():
    j, t = _accurate(128, 5)
    assert t == config.StereoMatcherConfig.accurate(backend="cuda")
    assert (t.mode, t.p2(), t.p1()) == ("sgm8", j.p2(), j.p1()) == ("sgm8", 3200, 200)


@pytest.mark.parametrize("H,W,D,bs", [(64, 128, 16, 3), (24, 100, 32, 5)],
                         ids=["64x128xD16", "24x100xD32"])
def test_sgm8_kernel_path_matches_pallas(H, W, D, bs):
    """sgm_disparity_cuda(num_directions=8) against sgm_disparity_pallas,
    with the accuracy preset's P2 = 128 * w^2 and its speckle filter."""
    gl, gr = _pair(H, W)
    j, t = _accurate(D, bs)
    d_j, v_j = sgm_pallas.sgm_disparity_pallas(jnp.asarray(gl), jnp.asarray(gr),
                                               interpret=True, **_kw(j))
    d_t, v_t = sgm_cuda.sgm_disparity_cuda(torch.tensor(gl), torch.tensor(gr), **_kw(t))
    v_j = np.asarray(v_j)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_j.mean() > 0.5
    assert np.abs(d_t.numpy() - np.asarray(d_j))[v_j].max() < 1e-4


def test_sgm8_reaches_the_pack_clamp_and_matches_pallas():
    """With P2 = 128 * w^2 the 8-direction sum S exceeds K4's 2^24 / PK - 1
    inside the image (the all-invalid lanes of the left band), so the clamp
    decides there; port and JAX must clamp alike. The port's finalize writes
    S over v3, which shows where it exceeds."""
    H, W, D, bs = 24, 100, 16, 5
    gl, gr = _pair(H, W, seed=3)
    j, t = _accurate(D, bs)
    p1, p2 = float(t.p1()), float(t.p2())
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    cost, v = sgm_cuda.cost_fwd_down(torch.tensor(gl), torch.tensor(gr), D, 0, bs,
                                     t.pre_filter_cap, p1, p2, HP, WP, DP)
    args = (t.uniqueness_ratio, t.disp12_max_diff, True, W)
    d_t, v_t = sgm_cuda.aggregate_and_finalize(cost, p1, p2, D, *args, v1=v, with_diag=True)
    assert float(v[:H, :W, :D].max()) > PACK_CLAMP

    cost_j, v1_j = sgm_pallas.cost_fwd_down(jnp.asarray(gl), jnp.asarray(gr), D, 0, bs,
                                            j.pre_filter_cap, float(j.p1()), float(j.p2()),
                                            HP, WP, DP, True, True)
    np.testing.assert_array_equal(cost.numpy().astype(np.int64),
                                  np.asarray(cost_j).astype(np.int64))
    d_j, v_j = sgm_pallas.aggregate_and_finalize(
        cost_j, float(j.p1()), float(j.p2()), D, *args, True, v1=v1_j, with_diag=True)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(d_t.numpy()[v_t.numpy()], np.asarray(d_j)[np.asarray(v_j)])


@pytest.mark.parametrize("vertical", ["down", "up"])
def test_diag_accumulate_matches_the_diagonal_scans(vertical):
    """K5's plain version adds exactly the two diagonal paths of the JAX
    package's XLA oracle (sgm._scan_dir with col_shift +1 and -1) on a
    padded cost volume."""
    gl, gr = _pair(64, 128)
    HP, WP, DP = sgm_cuda.padded_shape(64, 128, 16)
    cost, v1 = sgm_cuda.cost_fwd_down(torch.tensor(gl), torch.tensor(gr), 16, 0, 3, 63,
                                      72.0, 864.0, HP, WP, DP)
    out = sgm_cuda.diag_accumulate(cost, v1.clone(), 72.0, 864.0, vertical)
    c = jnp.asarray(cost.numpy().astype(np.float32))
    rev = vertical == "up"
    ref = (v1.numpy() + np.asarray(jsgm._scan_dir(c, 0, rev, 144.0, 1728.0, col_shift=1))
           + np.asarray(jsgm._scan_dir(c, 0, rev, 144.0, 1728.0, col_shift=-1)))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("final_dir", ["up", "down"])
def test_aggregate_without_v1_matches_pallas(final_dir):
    """aggregate_and_finalize(v1=None) runs the standalone forward (and, for
    "up", downward) scans of K14, as sgm_pallas does."""
    gl, gr = _pair(64, 128)
    HP, WP, DP = sgm_cuda.padded_shape(64, 128, 16)
    cost_j, _ = sgm_pallas.cost_fwd_down(jnp.asarray(gl), jnp.asarray(gr), 16, 0, 3, 63,
                                         72.0, 864.0, HP, WP, DP, True, True)
    args = (72.0, 864.0, 16, 10, 1, True, 128)
    d_j, v_j = sgm_pallas.aggregate_and_finalize(cost_j, *args, True, final_dir=final_dir)
    cost = torch.tensor(np.asarray(cost_j).astype(np.int16))
    before = (sgm_cuda.fwd_scan.launches, sgm_cuda.down_accumulate.launches)
    d_t, v_t = sgm_cuda.aggregate_and_finalize(cost, *args, final_dir=final_dir)
    # CPU tensors take the plain versions: no launch is counted
    assert (sgm_cuda.fwd_scan.launches, sgm_cuda.down_accumulate.launches) == before
    v_j = np.asarray(v_j)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_j.mean() > 0.5
    assert np.abs(d_t.numpy() - np.asarray(d_j))[v_j].max() < 1e-4


def test_standalone_scans_equal_the_fused_k2_scans():
    """fwd_scan (+ down_accumulate) reproduce the v1 cost_fwd_down returns."""
    gl, gr = _pair(24, 100)
    HP, WP, DP = sgm_cuda.padded_shape(24, 100, 32)
    for with_down in (False, True):
        cost, v1 = sgm_cuda.cost_fwd_down(torch.tensor(gl), torch.tensor(gr), 32, 0, 5, 63,
                                          200.0, 2400.0, HP, WP, DP, with_down)
        v = sgm_cuda.fwd_scan(cost, 200.0, 2400.0)
        if with_down:
            v = sgm_cuda.down_accumulate(cost, v, 200.0, 2400.0)
        assert torch.equal(v, v1)


def test_eight_directions_refuse_what_they_do_not_take():
    gl, gr = _pair(16, 128)
    with pytest.raises(ValueError):
        sgm_cuda.sgm_disparity_cuda(torch.tensor(gl), torch.tensor(gr), num_disparities=16,
                                    num_directions=5)
    cost = torch.zeros((64, 128, 128), dtype=torch.int16)
    v = torch.zeros((64, 128, 128))
    with pytest.raises(ValueError):
        sgm_cuda.diag_accumulate(cost, v, 72.0, 864.0, "left")
    with pytest.raises(ValueError):
        sgm_cuda.diag_accumulate(cost, v[:, :, :64], 72.0, 864.0)
    with pytest.raises(ValueError):
        sgm_cuda.aggregate_and_finalize(cost, 72.0, 864.0, 16, v1=v, final_dir="down",
                                        with_diag=True)
