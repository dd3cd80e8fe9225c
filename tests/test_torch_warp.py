"""Port parity: the two-pass rectification warp (recon3d_tpu_torch/ops/warp.py,
kernel K1's plain version) and the gather remap of ops/image.py against the
JAX package on the CPU.

The plan is host numpy in both packages and must be equal. The warp is held
to the JAX package's own bar, atol 1e-5 (tests/test_warp.py:99), against
both remap_two_pass (XLA) and remap_two_pass_pallas (interpret mode); at
gray levels up to 255 that leaves no room for a differing last bit, so the
port reproduces the fused multiply-add XLA forms for the interpolation.
The maps are the bench's synthetic rectification (numpy copy in
chip_smoke.py), whose border samples leave the source, and the same map
shifted 20 px, which leaves it along the whole right edge.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from recon3d_tpu.ops import image as jimage
from recon3d_tpu.ops import warp as jwarp
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.ops import image, warp

PLAN_ARRAYS = ("vy", "hx", "valid", "v_coarse", "h_coarse")
PLAN_INTS = ("v_resid_bound", "h_resid_bound", "v_coarse_bits", "h_coarse_bits")


def _maps(H, W, kind):
    mx, my = chip_smoke.synthetic_maps(H, W)
    if kind == "out_of_source":
        mx = mx + np.float32(20.0)  # the right edge samples beyond the source
    return mx, my


def _image(H, W, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(H // 4, W // 4).astype(np.float32) * 255
    return cv2.resize(img, (W, H), interpolation=cv2.INTER_CUBIC) + rng.rand(H, W).astype(
        np.float32)


def _plan_fields(plan):
    return {k: np.asarray(getattr(plan, k)) for k in PLAN_ARRAYS + PLAN_INTS}


def _assert_plans_equal(tp, jp):
    for k in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(tp, k).cpu().numpy(), np.asarray(getattr(jp, k)),
                                      err_msg=k)
    for k in PLAN_INTS:
        assert getattr(tp, k) == getattr(jp, k), k


def test_bench_map_copies_match_bench():
    """chip_smoke.py's numpy copies of bench.py's map helpers, and its
    replicate-border remap against cv2.remap (which the card's machine lacks)."""
    H, W = 48, 80
    for a, b in zip(chip_smoke.synthetic_maps(H, W), bench._synthetic_maps(H, W)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(chip_smoke.inverse_maps(H, W), bench._inverse_maps(H, W)):
        np.testing.assert_array_equal(a, b)
    imx, imy = bench._inverse_maps(H, W)
    img = _image(H, W)
    ref = cv2.remap(img, imx, imy, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)
    np.testing.assert_allclose(chip_smoke.remap_replicate(img, imx, imy), ref, atol=1e-4)
    far = (np.random.RandomState(1).rand(2, H, W) * np.array([W + 20, H + 20])[:, None, None]
           - 10).astype(np.float32)  # samples beyond every edge
    ref = cv2.remap(img, far[0], far[1], cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)
    np.testing.assert_allclose(chip_smoke.remap_replicate(img, far[0], far[1]), ref, atol=1e-4)


@pytest.mark.parametrize("H,W", [(64, 256), (60, 130)])
@pytest.mark.parametrize("kind", ["bench", "out_of_source"])
def test_build_remap_plan_matches(H, W, kind):
    mx, my = _maps(H, W, kind)
    jp = jwarp.build_remap_plan(mx, my)
    _assert_plans_equal(warp.build_remap_plan(mx, my, device="cpu"), jp)
    _assert_plans_equal(convert.remap_plan(_plan_fields(jp), device="cpu"), jp)


@pytest.mark.parametrize("kind", ["bench", "out_of_source"])
def test_plain_warp_matches_xla_and_pallas(kind):
    H, W = 64, 256  # tile-aligned, so the Pallas twin runs its kernels
    mx, my = _maps(H, W, kind)
    img = _image(H, W)
    jp = jwarp.build_remap_plan(mx, my)
    ref_xla = np.asarray(jwarp.remap_two_pass(jnp.asarray(img), jp))
    ref_pallas = np.asarray(jwarp.remap_two_pass_pallas(jnp.asarray(img), jp, interpret=True))
    tp = warp.build_remap_plan(mx, my, device="cpu")
    out = warp.remap_two_pass(torch.tensor(img), tp).numpy()
    np.testing.assert_allclose(out, ref_xla, atol=1e-5)
    np.testing.assert_allclose(out, ref_pallas, atol=1e-5)
    # the kernel wrapper takes the plain version for CPU tensors, uncounted
    before = warp.remap_two_pass_cuda.launches, warp.resample_pass.launches
    np.testing.assert_array_equal(warp.remap_two_pass_cuda(torch.tensor(img), tp).numpy(), out)
    assert (warp.remap_two_pass_cuda.launches, warp.resample_pass.launches) == before
    invalid = ~np.asarray(jp.valid)
    assert invalid.any() and (out[invalid] == 0.0).all()


@pytest.mark.parametrize("shift", [20.5, -20.5])
def test_plain_warp_matches_pallas_where_taps_wrap(shift):
    """remap_two_pass (and the kernel path's CPU route) against
    remap_two_pass_pallas in interpret mode, bitwise, on a plan shifted
    half a pixel past 20: the horizontal taps at one edge fall outside the
    row and wrap round it (the rolls' mod n), where plan.valid masks them."""
    H, W = 64, 256
    mx, my = _maps(H, W, "bench")
    mx = mx + np.float32(shift)
    img = _image(H, W, seed=4)
    jp = jwarp.build_remap_plan(mx, my)
    tp = warp.build_remap_plan(mx, my, device="cpu")
    taps = (np.arange(W)[None, :] + tp.h_coarse.numpy()[:, None]
            + np.floor(mx - np.arange(W)[None, :] - tp.h_coarse.numpy()[:, None]))
    assert ((taps < 0) | (taps + 1 >= W)).any()
    ref = np.asarray(jwarp.remap_two_pass_pallas(jnp.asarray(img), jp, interpret=True))
    out = warp.remap_two_pass(torch.tensor(img), tp).numpy()
    np.testing.assert_array_equal(out, ref)
    before = warp.remap_two_pass_cuda.launches
    np.testing.assert_array_equal(warp.remap_two_pass_cuda(torch.tensor(img), tp).numpy(), ref)
    assert warp.remap_two_pass_cuda.launches == before
    assert (out[~tp.valid.numpy()] == 0.0).all()


def test_plain_warp_matches_xla_on_unaligned_shape():
    H, W = 60, 130  # the Pallas twin would fall back; the port has no alignment rule
    mx, my = _maps(H, W, "out_of_source")
    img = _image(H, W, seed=2)
    jp = jwarp.build_remap_plan(mx, my)
    ref = np.asarray(jwarp.remap_two_pass(jnp.asarray(img), jp))
    out = warp.remap_two_pass_cuda(torch.tensor(img), convert.remap_plan(_plan_fields(jp),
                                                                         device="cpu"))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_non_monotonic_map_rejected_and_batch_equals_per_image():
    H, W = 32, 128
    mx, my = _maps(H, W, "bench")
    bad = mx.copy()
    bad[:, 10] = bad[:, 30]
    with pytest.raises(ValueError, match="strictly increasing"):
        warp.build_remap_plan(bad, my, device="cpu")
    plan = warp.build_remap_plan(mx, my, device="cpu")
    a, b = torch.tensor(_image(H, W, 1)), torch.tensor(_image(H, W, 2))
    batched = warp.remap_two_pass_batch(torch.stack([a, b]), plan)
    assert torch.equal(batched[0], warp.remap_two_pass(a, plan))
    assert torch.equal(batched[1], warp.remap_two_pass(b, plan))
    with pytest.raises(ValueError):
        warp.remap_two_pass_cuda(a[:, :64], plan)
    with pytest.raises(ValueError):
        warp.resample_pass(a, plan.hx, plan.h_coarse, 3, 4, 1, plan.valid.float())
    with pytest.raises(ValueError):
        warp.resample_pass(a, plan.vy, plan.h_coarse, 3, 4, 0)


def test_fma_rounds_once():
    """ops/image.fma against the correctly rounded a * b + c, from the exact
    rational value."""
    from fractions import Fraction

    rng = np.random.RandomState(5)
    a = (rng.rand(4000) * 2 - 0.5).astype(np.float32)
    b = (rng.rand(4000) * 300).astype(np.float32)
    c = (rng.rand(4000) * 300 - 150).astype(np.float32)
    # (1 + 2^-12)^2 - 1 = 2^-11 + 2^-24: an unfused product rounds the 2^-24 away
    # + or - 2^-80: the float64 sum lands on a float32 midpoint it is not on
    a[:3], b[:3], c[:3] = 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -12, (-1.0, 2.0 ** -80, -2.0 ** -80)
    out = image.fma(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    for i in range(0, 4000, 37):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # nearest float32 to the exact value
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - exact),
                                         int(np.float32(f).view(np.int32)) & 1))
        assert out[i] == best, i
    assert out[0] == np.float32(2.0 ** -11 + 2.0 ** -24)
    assert out[1] == np.float32(1.0 + 2.0 ** -11 + 2.0 ** -23)
    assert out[2] == np.float32(1.0 + 2.0 ** -11)


@pytest.mark.parametrize("channels", [1, 3])
def test_gather_remap_matches(channels):
    """ops/image.remap / bilinear_sample (depth_step's gather route), against
    the JAX functions jitted as depth_step runs them: XLA contracts the
    bilinear sum into fused multiply-adds only inside a compiled program."""
    H, W = 40, 56
    rng = np.random.RandomState(6)
    shape = (H, W) if channels == 1 else (H, W, 3)
    img = (rng.rand(*shape) * 255).astype(np.float32)
    mx = (rng.rand(H, W) * (W + 6) - 3).astype(np.float32)
    my = (rng.rand(H, W) * (H + 6) - 3).astype(np.float32)
    ref = np.asarray(jax.jit(jimage.remap)(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    out = image.remap(torch.tensor(img), torch.tensor(mx), torch.tensor(my)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    ref = np.asarray(jax.jit(jimage.bilinear_sample, static_argnames="border_value")(
        jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my), border_value=7.0))
    out = image.bilinear_sample(torch.tensor(img), torch.tensor(mx), torch.tensor(my), 7.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
