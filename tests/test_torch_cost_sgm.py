"""Port parity: SGM cost volume, path scans and finalize (recon3d_tpu_torch)
against the JAX package on the CPU.

The JAX side runs the Pallas kernels in interpret mode, as
tests/test_sgm_pallas.py does; the port runs each kernel wrapper's plain
PyTorch version (CPU tensors). Each side takes its matcher settings from
its own config, the port's carried across by recon3d_tpu_torch.convert. Inputs are FakeStereoCamera pairs (8-bit gray
levels), so all SGM arithmetic is integer-valued f32 and the bars are:
  cost (int16 / u16), v1, v3: exact;
  disparity: valid masks equal, |delta| < 1e-4 on valid pixels
  (the JAX package's own Pallas-vs-XLA bar, test_sgm_pallas.py:38-43).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import FakeStereoCamera
from recon3d_tpu.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu.depth import cost as jcost
from recon3d_tpu.depth import sgm as jsgm
from recon3d_tpu.depth import sgm_pallas
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.depth import cost as tcost
from recon3d_tpu_torch.depth import sgm as tsgm
from recon3d_tpu_torch.depth import sgm_cuda

# (H, W, D, block_size, uniqueness_ratio, disp12_max_diff): the shapes of
# test_sgm_pallas.py, one exact-divisor, one needing H and W padding
SHAPES = [(64, 128, 16, 3, 10, 1), (40, 192, 32, 5, 5, 2)]


def _pair(H, W, seed=1):
    cam = FakeStereoCamera(width=W, height=H, focal=80.0, baseline=0.05)
    gl, gr, _, _ = cam.render(seed)
    return gl.astype(np.float32), gr.astype(np.float32)


def _configs(D, bs, ur, md):
    """The JAX package's tuned matcher config and the port's, through convert."""
    jcfg = StereoMatcherConfig.tuned(num_disparities=D, block_size=bs, uniqueness_ratio=ur,
                                     disp12_max_diff=md, backend="pallas")
    tcfg = convert.convert_state(dataclasses.asdict(jcfg), dataclasses.asdict(WLSConfig()),
                                 np.eye(4), device="cpu").matcher
    assert tcfg.backend == "cuda"
    return jcfg, tcfg


@pytest.fixture(scope="module", params=SHAPES, ids=["64x128xD16", "40x192xD32"])
def case(request):
    """One shape's inputs and the JAX cost_fwd_down outputs (interpret)."""
    H, W, D, bs, ur, md = request.param
    gl, gr = _pair(H, W)
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    jcfg, tcfg = _configs(D, bs, ur, md)
    cost, v1 = sgm_pallas.cost_fwd_down(jnp.asarray(gl), jnp.asarray(gr), D, 0, bs,
                                        jcfg.pre_filter_cap, float(jcfg.p1()), float(jcfg.p2()),
                                        HP, WP, DP, True, True)
    # the port's settings, as the port's own config gives them
    return dict(j=jcfg, H=H, W=W, D=tcfg.num_disparities, bs=tcfg.block_size,
                ur=tcfg.uniqueness_ratio, md=tcfg.disp12_max_diff, cap=tcfg.pre_filter_cap,
                gl=gl, gr=gr, p1=float(tcfg.p1()), p2=float(tcfg.p2()),
                pad=(HP, WP, DP), cost=np.asarray(cost), v1=np.asarray(v1))


def _port_cost_v1(c):
    return sgm_cuda.cost_fwd_down(torch.tensor(c["gl"]), torch.tensor(c["gr"]), c["D"], 0,
                                  c["bs"], c["cap"], c["p1"], c["p2"], *c["pad"], True)


def test_padded_shape_follows_pallas_conventions():
    assert sgm_cuda.padded_shape(1080, 1920, 128) == (1088, 1920, 128)
    assert sgm_cuda.padded_shape(40, 192, 32) == (64, 256, 128)
    assert sgm_cuda.INVALID_COST == sgm_pallas.INVALID_COST


def test_prefilter_planes_match():
    gl, gr = _pair(32, 64)
    jp = sgm_pallas.prefilter_planes(jnp.asarray(gl), jnp.asarray(gr), 63)
    tp = sgm_cuda.prefilter_planes(torch.tensor(gl), torch.tensor(gr), 63)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bt_cost_volume_and_box_match():
    gl, gr = _pair(24, 64)
    lp, rp = jcost.xsobel_prefilter(jnp.asarray(gl)), jcost.xsobel_prefilter(jnp.asarray(gr))
    vol_j = jcost.bt_cost_volume(lp, rp, 16, 2)
    vol_t = tcost.bt_cost_volume(torch.tensor(np.asarray(lp)), torch.tensor(np.asarray(rp)), 16, 2)
    np.testing.assert_array_equal(np.asarray(vol_j), vol_t.numpy())
    box_j = jcost.box_aggregate(jnp.where(vol_j > 1e8, 0.0, vol_j), 5)
    box_t = tcost.box_aggregate(torch.where(vol_t > 1e8, 0.0, vol_t), 5)
    np.testing.assert_array_equal(np.asarray(box_j), box_t.numpy())


@pytest.mark.parametrize("H,W,D,bs,ur,md", SHAPES)
def test_cost_volume_u16_exact(H, W, D, bs, ur, md):
    gl, gr = _pair(H, W)
    ref = np.asarray(sgm_pallas.cost_volume_u16(jnp.asarray(gl), jnp.asarray(gr), D, 0, bs))
    out = sgm_cuda.cost_volume_u16(torch.tensor(gl), torch.tensor(gr), D, 0, bs)
    assert out.dtype == torch.int16 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy().astype(np.int32), ref.astype(np.int32))


def test_cost_fwd_down_exact(case):
    """K2: padded cost and v1 = L_fwd + L_down, bitwise."""
    cost, v1 = _port_cost_v1(case)
    assert cost.shape == case["cost"].shape and v1.dtype == torch.float32
    np.testing.assert_array_equal(cost.numpy().astype(np.int32), case["cost"].astype(np.int32))
    np.testing.assert_array_equal(v1.numpy(), case["v1"])
    H, W, D = case["H"], case["W"], case["D"]
    assert (cost.numpy()[H:] == 0).all() and (cost.numpy()[:, W:] == 0).all()
    assert (cost.numpy()[:H, :W, D:] == int(sgm_cuda.INVALID_COST)).all()


def test_bwd_accumulate_exact(case):
    """K3: v3 = v1 + L_bwd, bitwise against v1 plus the JAX package's own
    right-to-left path scan (sgm._scan_dir) on the same padded cost."""
    c = case
    cost_f = jnp.asarray(c["cost"].astype(np.float32))
    j = c["j"]
    ref = c["v1"] + np.asarray(jsgm._scan_dir(cost_f, 1, True, 2.0 * j.p1(), 2.0 * j.p2()))
    v1 = torch.tensor(c["v1"])
    v3 = sgm_cuda.bwd_accumulate(torch.tensor(c["cost"].astype(np.int16)), v1, c["p1"], c["p2"])
    assert v3.data_ptr() == v1.data_ptr()  # in place, as the kernel
    np.testing.assert_array_equal(v3.numpy(), ref)


def test_vfinalize_matches_wta_finalize(case):
    """K4: S = v3 + L_up, then the finalize against the JAX finalize kernel
    (wta_finalize, interpret mode, the same _finalize_body). v3 is read
    only; the plain upward scan onto it gives the S the JAX side finalizes."""
    c = case
    cost_f = jnp.asarray(c["cost"].astype(np.float32))
    j = c["j"]
    p1x, p2x = 2.0 * j.p1(), 2.0 * j.p2()
    v3 = c["v1"] + np.asarray(jsgm._scan_dir(cost_f, 1, True, p1x, p2x))
    S = v3 + np.asarray(jsgm._scan_dir(cost_f, 0, True, p1x, p2x))
    d_j, v_j = sgm_pallas.wta_finalize(jnp.asarray(S), j.num_disparities, j.uniqueness_ratio,
                                       j.disp12_max_diff, True, c["W"], interpret=True)
    cost_t, v3_t = torch.tensor(c["cost"].astype(np.int16)), torch.tensor(v3)
    d_t, v_t = sgm_cuda.vfinalize(cost_t, v3_t, c["p1"], c["p2"], c["D"], c["ur"], c["md"], True,
                                  c["W"], "up")
    np.testing.assert_array_equal(v3_t.numpy(), v3)  # v3 left as it was
    S_t = sgm_cuda._scan_plain(cost_t, v3_t, torch.empty_like(v3_t), 0, True, 2.0 * c["p1"],
                               2.0 * c["p2"])
    np.testing.assert_array_equal(S_t.numpy(), S)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert np.abs(d_t.numpy() - np.asarray(d_j))[np.asarray(v_j)].max() < 1e-4


@pytest.mark.parametrize("final_dir", ["up", "down"])
def test_vfinalize_is_the_finalize_of_v3_plus_the_vertical_path(case, final_dir):
    """K4's plain version equals K12's on S = v3 + L_vert, the vertical path
    scanned alone, and leaves v3 as it was."""
    c = case
    cost = torch.tensor(c["cost"].astype(np.int16))
    v3 = sgm_cuda.bwd_accumulate_plain(cost, torch.tensor(c["v1"]), c["p1"], c["p2"])
    v3_in = v3.clone()
    L = sgm_cuda._scan_plain(cost, None, torch.empty_like(v3), 0, final_dir == "up",
                             2.0 * c["p1"], 2.0 * c["p2"])
    args = (c["D"], c["ur"], c["md"], True, c["W"])
    d_k, v_k = sgm_cuda.vfinalize_plain(cost, v3, c["p1"], c["p2"], *args, final_dir)
    d_q, v_q = sgm_cuda.wta_finalize_plain(v3 + L, *args)
    assert torch.equal(v3, v3_in)
    assert torch.equal(v_k, v_q) and torch.equal(d_k, d_q) and bool(v_q.any())


def test_aggregate_and_finalize_matches_pallas(case):
    c = case
    j = c["j"]
    d_j, v_j = sgm_pallas.aggregate_and_finalize(
        jnp.asarray(c["cost"]), float(j.p1()), float(j.p2()), j.num_disparities,
        j.uniqueness_ratio, j.disp12_max_diff, True, c["W"], True, v1=jnp.asarray(c["v1"]))
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    d_t, v_t = sgm_cuda.aggregate_and_finalize(
        torch.tensor(c["cost"].astype(np.int16)), c["p1"], c["p2"], c["D"], c["ur"], c["md"],
        True, c["W"], v1=torch.tensor(c["v1"]))
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_j.any()
    assert np.abs(d_t.numpy() - d_j)[v_j].max() < 1e-4


@pytest.mark.parametrize("with_v1", [True, False], ids=["v1", "no_v1"])
def test_aggregate_and_finalize_fuse_bwd_matches_pallas(case, with_v1):
    """fuse_bwd=True (the JAX package's backward path inside the finalize
    sweep) against JAX's own fuse_bwd=True in interpret mode, with and
    without v1, and bitwise against the port's fuse_bwd=False."""
    c = case
    j = c["j"]
    d_j, v_j = sgm_pallas.aggregate_and_finalize(
        jnp.asarray(c["cost"]), float(j.p1()), float(j.p2()), j.num_disparities,
        j.uniqueness_ratio, j.disp12_max_diff, True, c["W"], True,
        v1=jnp.asarray(c["v1"]) if with_v1 else None, fuse_bwd=True)
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    cost = torch.tensor(c["cost"].astype(np.int16))
    args = (cost, c["p1"], c["p2"], c["D"], c["ur"], c["md"], True, c["W"])
    v1 = torch.tensor(c["v1"]) if with_v1 else None
    d_t, v_t = sgm_cuda.aggregate_and_finalize(*args, v1=v1, fuse_bwd=True)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_j.any()
    assert np.abs(d_t.numpy() - d_j)[v_j].max() < 1e-4
    d_n, v_n = sgm_cuda.aggregate_and_finalize(*args, v1=v1, fuse_bwd=False)
    assert torch.equal(v_t, v_n) and torch.equal(d_t, d_n)


def test_aggregate_and_finalize_leaves_v1_intact(case):
    """The public mirror leaves the caller's v1 as it was (JAX's jitted
    function donates nothing), with the same result, bit for bit, as the
    in-place entry the frame uses on its own v1."""
    c = case
    cost = torch.tensor(c["cost"].astype(np.int16))
    v1 = torch.tensor(c["v1"])
    for fuse_bwd in (False, True):
        d_t, v_t = sgm_cuda.aggregate_and_finalize(cost, c["p1"], c["p2"], c["D"], c["ur"],
                                                   c["md"], True, c["W"], v1=v1,
                                                   fuse_bwd=fuse_bwd)
        np.testing.assert_array_equal(v1.numpy(), c["v1"])
        own = torch.tensor(c["v1"])
        d_i, v_i = sgm_cuda._aggregate_and_finalize_(cost, c["p1"], c["p2"], c["D"], c["ur"],
                                                     c["md"], True, c["W"], own, "up", False)
        assert not torch.equal(own, v1)  # the in-place entry consumed its v1
        assert torch.equal(v_t, v_i) and torch.equal(d_t, d_i)


def test_aggregate_and_finalize_fuse_bwd_refuses_with_diag():
    """fuse_bwd with with_diag raises, as sgm_pallas asserts (8-direction
    mode keeps the separate backward pass)."""
    cost = torch.zeros((64, 128, 128), dtype=torch.int16)
    for v1 in (None, torch.zeros((64, 128, 128))):
        with pytest.raises(ValueError):
            sgm_cuda.aggregate_and_finalize(cost, 72.0, 864.0, 16, v1=v1, with_diag=True,
                                            fuse_bwd=True)


@pytest.mark.parametrize("H,W,D,bs,ur,md", SHAPES)
def test_sgm_disparity_cuda_matches_pallas(H, W, D, bs, ur, md):
    """The kernel path end to end (fast speckle on), against
    sgm_disparity_pallas in interpret mode."""
    gl, gr = _pair(H, W)

    def kw(cfg):
        return dict(num_disparities=cfg.num_disparities, block_size=cfg.block_size,
                    uniqueness_ratio=cfg.uniqueness_ratio,
                    disp12_max_diff=cfg.disp12_max_diff, p1=float(cfg.p1()),
                    p2=float(cfg.p2()), speckle_window_size=20)

    jcfg, tcfg = _configs(D, bs, ur, md)
    d_j, v_j = sgm_pallas.sgm_disparity_pallas(jnp.asarray(gl), jnp.asarray(gr),
                                               interpret=True, **kw(jcfg))
    d_t, v_t = sgm_cuda.sgm_disparity_cuda(torch.tensor(gl), torch.tensor(gr), **kw(tcfg))
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert np.abs(d_t.numpy() - d_j)[v_j].max() < 1e-4
    assert (d_t.numpy()[~v_j] == -1.0).all()


@pytest.mark.parametrize("num_directions", [3, 4])
def test_sgm_oracle_matches_xla(num_directions):
    """The port's plain oracle against sgm.sgm_disparity (XLA scans)."""
    gl, gr = _pair(48, 96)
    kw = dict(num_disparities=16, block_size=3, uniqueness_ratio=10, disp12_max_diff=1,
              num_directions=num_directions, speckle_window_size=20)
    d_j, v_j = jsgm.sgm_disparity(jnp.asarray(gl), jnp.asarray(gr), **kw)
    d_t, v_t = tsgm.sgm_disparity(torch.tensor(gl), torch.tensor(gr), **kw)
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert np.abs(d_t.numpy() - d_j)[v_j].max() < 1e-4


def test_kernel_path_3direction_matches_pallas():
    gl, gr = _pair(64, 128)
    kw = dict(num_disparities=16, block_size=3, num_directions=3, speckle_window_size=0)
    d_j, v_j = sgm_pallas.sgm_disparity_pallas(jnp.asarray(gl), jnp.asarray(gr),
                                               interpret=True, **kw)
    d_t, v_t = sgm_cuda.sgm_disparity_cuda(torch.tensor(gl), torch.tensor(gr), **kw)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert np.abs(d_t.numpy() - np.asarray(d_j))[np.asarray(v_j)].max() < 1e-4


def test_speckle_filters_match():
    rng = np.random.RandomState(4)
    disp = np.full((48, 80), 20.0, np.float32)
    disp[10:14, 10:14] = 90.0
    disp[30:, 40:] = 60.0 + rng.rand(18, 40).astype(np.float32) * 40.0
    valid = rng.rand(48, 80) > 0.1
    for fn_j, fn_t, kw in ((jsgm.speckle_filter_fast, tsgm.speckle_filter_fast,
                            dict(max_disparity=128)),
                           (jsgm.speckle_filter, tsgm.speckle_filter, {})):
        ref = np.asarray(fn_j(jnp.asarray(disp), jnp.asarray(valid), 32.0, 50, **kw))
        out = fn_t(torch.tensor(disp), torch.tensor(valid), 32.0, 50, **kw)
        np.testing.assert_array_equal(out.numpy(), ref)
    assert not ref[10:14, 10:14].any()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Only CUDA (kernel) and CPU (plain version) tensors, and only padded
    int16 / f32 volumes, are accepted."""
    v1 = torch.zeros((64, 128, 128))
    for cost in (torch.zeros((64, 128, 128)), torch.zeros((60, 128, 128), dtype=torch.int16),
                 torch.zeros((64, 128, 64), dtype=torch.int16)):
        with pytest.raises(ValueError):
            sgm_cuda.bwd_accumulate(cost, v1[:cost.shape[0], :, :cost.shape[2]], 72.0, 864.0)
        with pytest.raises(ValueError):
            sgm_cuda.vfinalize(cost, v1[:cost.shape[0], :, :cost.shape[2]], 72.0, 864.0, 16)
    cost = torch.zeros((64, 128, 128), dtype=torch.int16, device="meta")
    v1 = torch.zeros((64, 128, 128), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        sgm_cuda.bwd_accumulate(cost, v1, 72.0, 864.0)
    with pytest.raises(ValueError):
        sgm_cuda.bwd_accumulate(torch.zeros((64, 128, 128), dtype=torch.int16), v1, 72.0, 864.0)
