"""Dense image ops on the depth path (twin of recon3d_tpu/ops/image.py:
`rgb_to_gray`, `normalize_minmax`, `colormap_jet`)."""
from __future__ import annotations

import torch


def rgb_to_gray(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """ITU-R BT.601 luma, matching cv2.cvtColor COLOR_RGB2GRAY/COLOR_BGR2GRAY."""
    dtype = img.dtype if img.is_floating_point() else torch.float32
    w = torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=img.device)
    if order == "bgr":
        w = w.flip(0)
    return img.to(dtype) @ w


def normalize_minmax(img: torch.Tensor, lo: float = 0.0, hi: float = 255.0) -> torch.Tensor:
    """cv2.normalize(NORM_MINMAX)."""
    mn, mx = img.min(), img.max()
    return (img - mn) * ((hi - lo) / torch.clamp(mx - mn, min=1e-12)) + lo


def colormap_jet(norm01: torch.Tensor) -> torch.Tensor:
    """cv2.COLORMAP_JET over values in [0, 1] -> float RGB in [0, 1]."""
    v = torch.clamp(norm01, 0.0, 1.0)
    four = 4.0 * v
    r = torch.clamp(torch.minimum(four - 1.5, -four + 4.5), 0.0, 1.0)
    g = torch.clamp(torch.minimum(four - 0.5, -four + 3.5), 0.0, 1.0)
    b = torch.clamp(torch.minimum(four + 0.5, -four + 2.5), 0.0, 1.0)
    return torch.stack([r, g, b], -1)
