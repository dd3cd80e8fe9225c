"""Port parity for depth/cost.py:census_cost_volume and the census branch
of depth/sgm.py:sgm_disparity against the JAX package on the CPU, on
FakeStereoCamera renders. Bars: the cost volume exact (Hamming distances of
24-bit census words: integer-valued float32, out-of-range cells 1e9); the
census SGM at the SGM bars (tests/test_sgm_pallas.py:38-43): valid masks
equal, |delta disparity| < 1e-4 on valid pixels away from the left border
(x >= D + 2). The census branch scales the penalties to the census range
(P1 6, P2 64 at the defaults) as the JAX package does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import FakeStereoCamera
from recon3d_tpu.depth import cost as jcost
from recon3d_tpu.depth import sgm as jsgm
from recon3d_tpu_torch.depth import cost, sgm


@pytest.fixture(scope="module")
def pair():
    left, right, disp, _ = FakeStereoCamera(width=160, height=64, focal=100.0,
                                            baseline=0.06).render(0)
    return left, right, disp


@pytest.mark.parametrize("D,min_disparity,window", [(32, 0, 5), (16, 4, 5), (24, 0, 3)])
def test_census_cost_volume_exact(pair, D, min_disparity, window):
    left, right, _ = pair
    ref = np.asarray(jcost.census_cost_volume(jnp.asarray(left), jnp.asarray(right), D,
                                              min_disparity, window))
    out = cost.census_cost_volume(torch.as_tensor(left), torch.as_tensor(right), D,
                                  min_disparity, window)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_census_cost_volume_on_noise_exact():
    rng = np.random.RandomState(0)
    left = rng.randint(0, 256, (40, 96)).astype(np.float32)
    right = np.roll(left, -5, axis=1) + rng.randint(-2, 3, left.shape)
    ref = np.asarray(jcost.census_cost_volume(jnp.asarray(left), jnp.asarray(right), 16))
    out = cost.census_cost_volume(torch.as_tensor(left), torch.as_tensor(right), 16)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("num_directions,block_size", [(4, 5), (8, 3)])
def test_sgm_disparity_census_matches(pair, num_directions, block_size):
    left, right, disp_true = pair
    D = 32
    kw = dict(num_disparities=D, block_size=block_size, num_directions=num_directions,
              cost_kind="census")
    d_ref, v_ref = (np.asarray(a) for a in jsgm.sgm_disparity(jnp.asarray(left),
                                                              jnp.asarray(right), **kw))
    d, v = sgm.sgm_disparity(torch.as_tensor(left), torch.as_tensor(right), **kw)
    np.testing.assert_array_equal(v.numpy(), v_ref)
    reg = np.zeros_like(v_ref)
    reg[:, D + 2:] = True
    both = v_ref & reg
    assert both.mean() > 0.5
    assert np.abs(d.numpy() - d_ref)[both].max() < 1e-4
    # a working matcher on this scene
    scored = v_ref & (disp_true > 1.0) & reg
    assert np.sqrt(np.mean((d.numpy() - disp_true)[scored] ** 2)) < 2.0


def test_sgm_disparity_unknown_cost_kind_raises(pair):
    left, right, _ = pair
    with pytest.raises(ValueError, match="unknown cost kind"):
        sgm.sgm_disparity(torch.as_tensor(left), torch.as_tensor(right), num_disparities=16,
                          cost_kind="sad")
