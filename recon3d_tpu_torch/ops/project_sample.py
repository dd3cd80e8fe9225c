"""Projective image sampling for TSDF integration (twin of
recon3d_tpu/ops/project_sample.py: `sample_images_at`).

fusion/tsdf.py:_frame_contrib samples the stacked depth + color image at
every voxel's projected pixel, `images[c, vc, uc]` over an (R, R, R) index
volume. On the TPU that gather serialized, so the JAX package selects the
pixels with a windowed one-hot matmul that reads 0 outside a 64 x 128
window. On the card it is a plain gather (K9, ops/project_sample_cuda.py),
which reads every pixel as the XLA gather does: no window, no shape
condition.
"""
from __future__ import annotations

import torch

from recon3d_tpu_torch import kernels


def sample_images_plain(vc: torch.Tensor, uc: torch.Tensor,
                        images: torch.Tensor) -> torch.Tensor:
    """The plain version: images[:, vc, uc], (C, *vc.shape)."""
    return images[:, vc.long(), uc.long()]


def sample_images_at(vc: torch.Tensor, uc: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """images (C, H, W) float32 sampled at per-voxel pixel indices.

    vc, uc: int32 index volumes of one shape, already clipped to the image
    (the caller's in-bounds mask handles out-of-frustum voxels). Returns
    (C, *vc.shape) float32 with images[c, vc, uc] per voxel: K9 for CUDA
    tensors, the plain gather for CPU tensors.
    """
    if vc.dtype != torch.int32 or uc.dtype != torch.int32 or vc.shape != uc.shape:
        raise ValueError("vc and uc must be int32 index volumes of one shape")
    if images.dtype != torch.float32 or images.ndim != 3:
        raise ValueError("images must be (C, H, W) float32")
    if not kernels.use_kernel(vc, uc, images):
        return sample_images_plain(vc, uc, images)
    from recon3d_tpu_torch.ops.project_sample_cuda import sample_images_cuda

    return sample_images_cuda(vc, uc, images)
