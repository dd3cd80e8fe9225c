"""K2's stage order against its plain version, and the arguments K2 refuses.

K2 (csrc/sgm_cost.cu) computes the cost and the downward path in one walk
down the columns, then adds the forward path onto v1 with one scan. These
CPU tests hold that order to `cost_fwd_down_plain` (the cost, then v1 =
L_fwd, then v1 += L_down) bitwise on a warped pair, whose gray levels are
not integers: L_fwd + L_down and L_down + L_fwd round alike because IEEE
addition commutes. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from recon3d_tpu_torch.camera.fake import FakeStereoCamera
from recon3d_tpu_torch.depth import sgm_cuda
from recon3d_tpu_torch.ops import warp

H, W = 24, 48
P1, P2 = 200.0, 3200.0


def _warped_pair():
    gl, gr, _, _ = FakeStereoCamera(width=W, height=H, focal=0.6 * W,
                                    baseline=0.05).render(1)
    plan = warp.build_remap_plan(*chip_smoke.synthetic_maps(H, W), device="cpu")
    return (warp.remap_two_pass(torch.tensor(gl.astype(np.float32)), plan),
            warp.remap_two_pass(torch.tensor(gr.astype(np.float32)), plan))


@pytest.mark.parametrize("with_down", [True, False])
@pytest.mark.parametrize("D,bs,md", [(16, 5, 0), (32, 3, 4), (16, 1, 0), (16, 11, 2)])
def test_walk_then_forward_scan_gives_the_plain_bits(with_down, D, bs, md):
    gl, gr = _warped_pair()
    assert not torch.equal(gl, gl.round())
    planes = sgm_cuda.prefilter_planes(gl, gr, 63)
    hp, wp, dp = sgm_cuda.padded_shape(H, W, D)
    p1x, p2x = 2.0 * P1, 2.0 * P2
    cost = sgm_cuda._cost_plain(planes, hp, wp, dp, D, md, bs)
    v1 = torch.empty((hp, wp, dp), dtype=torch.float32)
    if with_down:  # the walk: L_down into v1; the scan: v1 = L_fwd + v1
        sgm_cuda._scan_plain(cost, None, v1, 0, False, p1x, p2x)
        sgm_cuda._scan_plain(cost, v1, v1, 1, False, p1x, p2x)
    else:  # no downward path: the scan writes L_fwd
        sgm_cuda._scan_plain(cost, None, v1, 1, False, p1x, p2x)
    cost_q, v1_q = sgm_cuda.cost_fwd_down_plain(planes, hp, wp, dp, D, md, bs, P1, P2,
                                                with_down)
    assert torch.equal(cost, cost_q) and torch.equal(v1, v1_q)
    cost_w, v1_w = sgm_cuda.cost_fwd_down(gl, gr, D, md, bs, 63, P1, P2, hp, wp, dp, with_down)
    assert torch.equal(cost_w, cost_q) and torch.equal(v1_w, v1_q)


@pytest.mark.parametrize("D,bs,md", [(16, 0, 0), (16, 2, 0), (16, 4, 0), (16, 13, 0),
                                     (16, 5, -1), (0, 5, 0), (129, 5, 0)])
def test_cost_fwd_down_refuses_what_the_walk_does_not_take(D, bs, md):
    """An odd block_size in [1, 11], min_disparity >= 0 and 1 <= D <= DP:
    refused on either device, before the kernel or its plain version runs."""
    gl = torch.zeros((8, 16))
    with pytest.raises(ValueError):
        sgm_cuda.cost_fwd_down(gl, gl, D, md, bs, 63, P1, P2, 64, 128, 128)
