"""On-card checks of the port's kernels against their plain versions at
shapes chip_smoke.py does not drive: an unaligned warp, D = 256, wide and
tall volumes (diagonal lines entering through the side columns), 3, 4 and 8
directions, a nonzero min_disparity, and DepthPipeline on the card against
itself on the CPU. A CUDA kernel has no CPU mode, so these tests are marked
`cuda` and skip without a card. On a machine with one (no JAX needed):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_kernels.py

All SGM arithmetic is integer-valued f32 and the warp reproduces one
rounding per operation, so kernel and plain version agree bitwise; the
disparity bar is the SGM one, valid equal and |delta| < 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from recon3d_tpu_torch.camera.fake import FakeStereoCamera
from recon3d_tpu_torch.config import StereoMatcherConfig
from recon3d_tpu_torch.depth import DepthPipeline, sgm_cuda
from recon3d_tpu_torch.ops import warp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _pair(H, W, seed=1):
    gl, gr, _, _ = FakeStereoCamera(width=W, height=H, focal=0.6 * W,
                                    baseline=0.05).render(seed)
    return gl.astype(np.float32), gr.astype(np.float32)


@pytest.mark.parametrize("H,W,shift", [(61, 133, 0.0), (64, 256, 20.0), (200, 96, -7.5)])
def test_k1_matches_plain_on_any_shape(dev, H, W, shift):
    mx, my = chip_smoke.synthetic_maps(H, W)
    plan = warp.build_remap_plan(mx + np.float32(shift), my, device=dev)
    img = torch.rand((H, W), generator=torch.Generator().manual_seed(H), dtype=torch.float32)
    img = (img * 255).to(dev)
    before = warp.resample_pass.launches
    out = warp.remap_two_pass_cuda(img, plan)
    torch.cuda.synchronize()
    assert warp.resample_pass.launches == before + 2
    assert torch.equal(out, warp.remap_two_pass(img, plan))


@pytest.mark.parametrize("H,W,D", [(64, 384, 16), (192, 128, 160), (40, 130, 32)])
def test_k2_k5_k14_match_plain(dev, H, W, D):
    """K2 on a warped (non-integer) pair, K5 both ways and K14 both scans,
    on volumes whose diagonal lines enter through the first row and both
    side columns, with DP = 128 and 256."""
    gl, gr = _pair(H, W)
    mx, my = chip_smoke.synthetic_maps(H, W)
    plan = warp.build_remap_plan(mx, my, device=dev)
    gl = warp.remap_two_pass_cuda(torch.tensor(gl, device=dev), plan)
    gr = warp.remap_two_pass_cuda(torch.tensor(gr, device=dev), plan)
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    p1, p2 = 200.0, 3200.0
    planes = sgm_cuda.prefilter_planes(gl, gr, 63)
    cost, v1 = sgm_cuda.cost_fwd_down(gl, gr, D, 0, 5, 63, p1, p2, HP, WP, DP, True,
                                      planes=planes)
    cost_q, v1_q = sgm_cuda.cost_fwd_down_plain(planes, HP, WP, DP, D, 0, 5, p1, p2)
    assert torch.equal(cost, cost_q) and torch.equal(v1, v1_q)
    for vertical in ("down", "up"):
        out = sgm_cuda.diag_accumulate(cost, v1.clone(), p1, p2, vertical)
        ref = sgm_cuda.diag_accumulate_plain(cost, v1.clone(), p1, p2, vertical)
        assert torch.equal(out, ref), vertical
    fwd = sgm_cuda.fwd_scan(cost, p1, p2)
    assert torch.equal(fwd, sgm_cuda.fwd_scan_plain(cost, p1, p2))
    down = sgm_cuda.down_accumulate(cost, fwd.clone(), p1, p2)
    assert torch.equal(down, sgm_cuda.down_accumulate_plain(cost, fwd.clone(), p1, p2))
    assert torch.equal(down, v1)


@pytest.mark.parametrize("num_directions,min_disparity", [(3, 0), (4, 4), (8, 0), (8, 6)])
def test_sgm_kernel_path_matches_cpu(dev, num_directions, min_disparity):
    gl, gr = _pair(96, 256, seed=2)
    kw = dict(num_disparities=48, min_disparity=min_disparity, block_size=5, p2=3200.0,
              num_directions=num_directions)
    d_k, v_k = sgm_cuda.sgm_disparity_cuda(torch.tensor(gl, device=dev),
                                           torch.tensor(gr, device=dev), **kw)
    d_q, v_q = sgm_cuda.sgm_disparity_cuda(torch.tensor(gl), torch.tensor(gr), **kw)
    assert torch.equal(v_k.cpu(), v_q) and v_q.float().mean() > 0.5
    assert float((d_k.cpu() - d_q).abs()[v_q].max()) < 1e-4


def test_depth_pipeline_on_card_matches_cpu(dev):
    """DepthPipeline.process on the card against the same pipeline on the
    CPU (plain versions), before WLS (its float32 solve is ill-conditioned
    on textured guides, and exp() rounds otherwise on the two devices)."""
    H, W = 144, 256  # the bench rig scaled by 2 / 15
    params = chip_smoke.pipeline_rig()
    s = W / chip_smoke.W
    for K in (params.mtx1, params.mtx2):
        K[:2] *= s
    for P in (params.P1, params.P2):
        P[:2] *= s
    cfg = StereoMatcherConfig.tuned(num_disparities=32)
    on_card = DepthPipeline(params, (W, H), cfg, with_wls=False, device=dev)
    on_cpu = DepthPipeline(params, (W, H), cfg, with_wls=False, device="cpu")
    assert on_card.plans is not None
    # the card's plans (its float32 maps may differ from the CPU's in the last bit)
    on_cpu.plans = tuple(dataclasses.replace(p, **{k: getattr(p, k).cpu() for k in (
        "vy", "hx", "valid", "v_coarse", "h_coarse")}) for p in on_card.plans)
    left, right = _pair(H, W, seed=3)
    d_k, z_k, vis_k = on_card.process(left, right)
    d_q, z_q, vis_q = on_cpu.process(left, right)
    valid = d_q > 0
    assert torch.equal(d_k.cpu() > 0, valid) and valid.float().mean() > 0.3
    assert float((d_k.cpu() - d_q).abs()[valid].max()) < 1e-4
    assert z_k.shape == (H, W) and vis_k.shape == (H, W, 3)
