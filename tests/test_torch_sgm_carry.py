"""Port parity: the row-sharded path's kernels K10 (vscan_carry), K11
(diag_carry) and K12 (wta_finalize), recon3d_tpu_torch against the JAX
package on the CPU.

The JAX side runs the Pallas kernels in interpret mode; the port runs each
wrapper's plain PyTorch version (CPU tensors). The volumes are one shard's:
the cost and v1 of a FakeStereoCamera pair (8-bit gray levels, so every
value is an integer-valued f32 below 2^24), with the carry planes taken
from a real scan of another frame. The last rows of the 64-row shard hold
real cost, so with h_real = 56 they are the dead rows a last shard holds
below its real image. Bars: exact, on every row (out and carry_out).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import FakeStereoCamera
from recon3d_tpu.depth import sgm_pallas as sp
from recon3d_tpu_torch.depth import sgm_cuda

H, W, D, BLOCK = 64, 120, 128, 5
P1, P2 = 200.0, 2400.0


def _volumes(seed):
    """cost (int16) and v1 = L_fwd of a rendered pair, padded (64, 128, 128)."""
    gl, gr, _, _ = FakeStereoCamera(width=W, height=H, focal=80.0, baseline=0.05).render(seed)
    planes = sgm_cuda.prefilter_planes(torch.tensor(gl, dtype=torch.float32),
                                       torch.tensor(gr, dtype=torch.float32), 63)
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    return sgm_cuda.cost_fwd_down_plain(planes, HP, WP, DP, D, 0, BLOCK, P1, P2, False)


@pytest.fixture(scope="module")
def shard():
    """This shard's volumes and the carries a neighbouring shard (another
    frame's volumes) relays after its last row: integer-valued f32."""
    cost, v1 = _volumes(1)
    cost_b, v1_b = _volumes(2)
    zero = torch.zeros(cost.shape[1:])
    _, carry = sgm_cuda.vscan_carry_plain(cost_b, v1_b.clone(), zero, P1, P2, False, H)
    _, carry2 = sgm_cuda.diag_carry_plain(cost_b, v1_b.clone(), torch.stack([zero, zero]), P1,
                                          P2, False, H)
    assert float(carry.max()) > 0 and float(carry2.max()) > 0
    return cost, v1, carry, carry2


def _jax(a):
    return jnp.asarray(a.numpy().astype(np.uint16) if a.dtype == torch.int16 else a.numpy())


@pytest.mark.parametrize("h_real", [H, H - 8], ids=["h_real=HP", "h_real<HP"])
@pytest.mark.parametrize("reverse", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("kernel", ["vscan_carry", "diag_carry"])
def test_carry_scan_matches_pallas(shard, kernel, reverse, h_real):
    cost, v1, carry, carry2 = shard
    carry_in = carry if kernel == "vscan_carry" else carry2
    out_j, cout_j = getattr(sp, kernel)(_jax(cost), _jax(v1), _jax(carry_in), P1, P2, reverse,
                                        h_real, interpret=True)
    out_t, cout_t = getattr(sgm_cuda, kernel)(cost, v1.clone(), carry_in, P1, P2, reverse,
                                              h_real)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(cout_t.numpy(), np.asarray(cout_j))
    assert not torch.equal(out_t, v1)


def test_wta_finalize_matches_pallas(shard):
    """K12 on an S aggregated from the four straight paths, w_real < WP."""
    cost, v1, carry, _ = shard
    S = sgm_cuda.bwd_accumulate_plain(cost, v1.clone(), P1, P2)
    S, _ = sgm_cuda.vscan_carry_plain(cost, S, carry, P1, P2, False, H)
    S, _ = sgm_cuda.vscan_carry_plain(cost, S, carry, P1, P2, True, H)
    d_j, v_j = sp.wta_finalize(_jax(S), D, 10, 1, True, w_real=W, interpret=True)
    S_in = S.clone()
    d_t, v_t = sgm_cuda.wta_finalize(S, D, 10, 1, True, w_real=W)
    assert torch.equal(S, S_in)  # S is read only
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert 0.5 < float(v_t[:, :W].float().mean())
