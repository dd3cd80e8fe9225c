"""The traffic generator is deterministic per seed, and every seed gives
frames of the same sizes."""
import numpy as np
import torch

from portbench.registry import Registry
from portbench.rig import rig_matrices
from portbench.scenes import RGBDOrbit, StereoScenes
from portbench.tests.small_cells import small_fusion, small_stereo

BIG = 2 ** 31 + 987_654_321  # the driver's seeds pass 32 signed bits


def _stereo(seed):
    cfg = small_stereo(Registry().config("stereo_jetson_1080p"))
    W, H = cfg["image"]["width"], cfg["image"]["height"]
    s = StereoScenes(2, W, H, cfg["rig"]["f_rect_px"], cfg["rig"]["baseline_m"], seed, "cpu")
    return s.raw_bgr(rig_matrices(cfg)) + s.rectified_gray(), (H, W)


def test_stereo_frames_repeat_per_seed():
    (a, size), (b, _), (c, _) = _stereo(BIG), _stereo(BIG), _stereo(BIG + 1)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert x.shape == z.shape and not torch.equal(x, z)
        assert x.dtype == torch.uint8 and tuple(x.shape[1:3]) == size


def test_stereo_depths_lie_in_the_working_range():
    cfg = small_stereo(Registry().config("stereo_jetson_1080p"))
    W, H = cfg["image"]["width"], cfg["image"]["height"]
    s = StereoScenes(4, W, H, cfg["rig"]["f_rect_px"], cfg["rig"]["baseline_m"], 7, "cpu")
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                          torch.arange(W, dtype=torch.float64), indexing="ij")
    z = s.depth_left(x.expand(4, -1, -1), y.expand(4, -1, -1))
    assert float(z.min()) >= 0.39 and float(z.max()) <= 3.0


def _orbit(seed):
    cfg = small_fusion(Registry().config("rgbd_d415_tsdf256"))
    return RGBDOrbit(3, cfg["camera"], [0.0, 0.0, 0.5], seed, "cpu").render()


def test_rgbd_frames_repeat_per_seed():
    a, b, c = _orbit(BIG), _orbit(BIG), _orbit(BIG + 1)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and x.shape == z.shape and not torch.equal(x, z)
    z16 = a[0]
    assert int(z16.max()) <= 3000 and float((z16 > 0).float().mean()) > 0.5
    assert np.allclose(a[2][:, 3, :].numpy(), [0, 0, 0, 1])
