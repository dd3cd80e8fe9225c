"""The reference agrees with the port's plain CPU path at a small size:
stage by stage, and through whole runs of every cell, which come out
correct."""
import time

import numpy as np
import pytest
import torch

from portbench import fusion_cells as fc
from portbench import stereo_cells as sc
from portbench.harness import run_cell
from portbench.reference import stereo as ref
from portbench.registry import Registry
from portbench.rig import rig_matrices
from portbench.scenes import StereoScenes
from portbench.tests.small_cells import small, small_fusion, small_stereo

CELLS = ["stereo1080.stream", "stereo1080.replay4", "rgbd640.integrate", "rgbd640.backlog4"]
F32_PX = Registry().cell("stereo1080.stream")["wls_f32_px"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stereo():
    cfg = small_stereo(Registry().config("stereo_jetson_1080p"))
    W, H = cfg["image"]["width"], cfg["image"]["height"]
    s = StereoScenes(2, W, H, cfg["rig"]["f_rect_px"], cfg["rig"]["baseline_m"], 11, "cpu")
    return cfg, s.raw_bgr(rig_matrices(cfg)), s.rectified_gray()


def test_rectification_agrees_with_the_two_pass_warp(stereo):
    from recon3d_tpu_torch.calib import stereo as cst
    from recon3d_tpu_torch.ops import warp

    cfg, (left, _), _ = stereo
    W, H = cfg["image"]["width"], cfg["image"]["height"]
    r = rig_matrices(cfg)
    mx, my = cst.rectify_maps(r["K1"], r["dist1"], r["R1"], r["P1"], (W, H), "cpu")
    plan = warp.build_remap_plan(mx.numpy(), my.numpy(), "cpu")
    prog = warp.remap_two_pass(left[0].to(torch.float32) @ torch.tensor([0.299, 0.587, 0.114]),
                               plan)
    rect = ref.Rectifier(r["K1"], r["dist1"], r["R1"], r["P1"], W, H, "cpu")
    want = rect(ref.to_gray(left[0]))
    assert torch.equal(plan.valid | rect.ambiguous, rect.valid | rect.ambiguous)
    assert float((prog.double() - want).abs()[~rect.ambiguous].max()) < 0.01


def test_sgm_agrees_exactly_with_the_kernel_paths_plain_version(stereo):
    from recon3d_tpu_torch.depth.matcher import compute_disparity
    from recon3d_tpu_torch.depth.sgm_cuda import sgm_disparity_cuda

    cfg, _, (gl, gr) = stereo
    mcfg, wcfg = sc.program_configs(cfg)
    check = sc.StereoCheck(cfg, "cpu", rectify=False, f32_px=F32_PX)
    left, right = gl.to(torch.float32), gr.to(torch.float32)
    d_ref, v_ref = ref.sgm(left, right, check.m)
    for b in range(2):
        kw = dict(num_disparities=mcfg.num_disparities, block_size=mcfg.block_size,
                  p1=float(mcfg.p1()), p2=float(mcfg.p2()), uniqueness_ratio=10,
                  disp12_max_diff=1, speckle_window_size=50, speckle_range=32.0,
                  pre_filter_cap=63)
        d, v = sgm_disparity_cuda(left[b], right[b], **kw)
        assert torch.equal(v, v_ref[b]) and torch.equal(d, d_ref[b])
        u, _ = compute_disparity(left[b], right[b], mcfg, wcfg, True)
        u_ref = ref.wls(d[None], v[None], left[b:b + 1], check.w)[0]
        # the reference in float32 follows the configuration's stated
        # arithmetic, and so the program's solve, bit for bit
        u32 = ref.wls(d[None], v[None], left[b:b + 1], check.w, torch.float32)[0]
        assert torch.equal(u32, u)
        determined = (u32.double() - u_ref).abs() <= F32_PX
        assert float((~determined).double().mean()) < 0.05
        assert float((u.double() - u_ref).abs()[determined].max()) <= F32_PX
    assert 0.5 < float(v_ref.float().mean()) < 1.0


def test_tsdf_agrees_with_integrate():
    from recon3d_tpu_torch.fusion import tsdf

    cfg = small_fusion(Registry().config("rgbd_d415_tsdf256"))
    pool = fc.FramePool(cfg, 3, 21, "cpu")
    vol = fc.program_volume(cfg, "cpu")
    for k in range(3):
        vol = tsdf.integrate(vol, torch.from_numpy(pool.depth[k]), fc.program_intrinsics(cfg),
                             torch.from_numpy(pool.ext[k]), color=torch.from_numpy(pool.color[k]),
                             depth_trunc=3.0, weight_max=64.0)
    want = fc.reference_state(cfg, pool, 3, "cpu")
    nums = fc.numbers((vol.tsdf, vol.weight, vol.color), want)
    assert nums["weight_diff"] < 1e-3 and nums["tsdf_gap"] < 1e-5 and nums["color_gap"] < 1e-5
    assert float((want.weight > 0).double().mean()) > 0.01
    assert np.isclose(float(want.weight.max()), 3.0)


@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_of_each_cell_is_correct(name):
    reg = Registry()
    cell, cfg = small(reg, name)
    res = run_cell(reg, name, 2 ** 31 + 4242, 6.0, False, "cpu", time.perf_counter(),
                   cell=cell, cfg=cfg)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("name", ["rgbd640.integrate", "rgbd640.backlog4"])
def test_a_window_that_closes_on_a_scans_last_frame_is_judged(name, extra):
    """The volume at the close holds a whole scan when the window ends on
    the scan's last frame, and one frame (or step) of the next after it."""
    reg = Registry()
    cell, cfg = small(reg, name)
    drv = reg.driver(cell["driver"]).Driver(cfg, cell, 77, "cpu")
    drv.warmup()
    t = cell["traffic"]
    for _ in range(t["scan_frames"] // t.get("batch", 1) + extra):
        drv.step()
    drv.finish()
    samples, missing = drv.check()
    assert missing == 0 and len(samples) == 2
    for s in samples:
        assert all(s[k] <= cell["limits"][k] for k in cell["limits"]), s
