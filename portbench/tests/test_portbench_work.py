"""The least-work counts follow from the shapes alone."""
import pytest

from portbench import work


def test_sgm_work_scales_with_the_shapes():
    w = work.sgm_work(1080, 1920, 128, 4, 5)
    assert w["ops"] == (9 + 4 + 7 * 4 + 3 + 3) * 1080 * 1920 * 128
    assert w["bytes"] == 1080 * 1920 * 13
    assert work.sgm_work(540, 960, 128, 4, 5)["ops"] * 4 == w["ops"]
    assert work.sgm_work(1080, 1920, 256, 4, 5)["ops"] == 2 * w["ops"]
    assert work.sgm_work(1080, 1920, 128, 8, 5)["ops"] > w["ops"]
    assert work.sgm_work(1080, 1920, 128, 4, 9)["ops"] == w["ops"]  # running box sums
    ms, bound = work.least_ms(w["bytes"], w["ops"], w["ops_per_s"])
    assert bound == "operations" and ms == pytest.approx(w["ops"] / work.F32_INSTR_PER_S * 1e3)


def test_integrate_work_is_the_volume_once_and_the_frames():
    w = work.integrate_work(256, 480, 640, True, 1)
    assert w["bytes"] == 2 * 20 * 256 ** 3 + 480 * 640 * 7 and w["ops"] == 0
    assert work.integrate_work(256, 480, 640, False, 1)["bytes"] == 2 * 8 * 256 ** 3 + 480 * 640 * 4
    four = work.per_frame(work.integrate_work(256, 480, 640, True, 4), 4)
    assert four["bytes"] == pytest.approx((2 * 20 * 256 ** 3) / 4 + 480 * 640 * 7)
    ms, bound = work.least_ms(w["bytes"], w["ops"], w["ops_per_s"])
    assert bound == "bytes" and ms == pytest.approx(w["bytes"] / 3.35e12 * 1e3)


def test_peaks():
    assert work.HBM_BYTES_PER_S == 3.35e12 and work.F32_FLOP_PER_S == 67e12
    assert work.F32_INSTR_PER_S == pytest.approx(33.45e12, rel=1e-3)
