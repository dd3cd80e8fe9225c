"""K9, the projective sampler of TSDF integration, on the card (replaces
recon3d_tpu/ops/project_sample.py:sample_images_at, pallas_call at
project_sample.py:131; source csrc/project_sample.cu).

One thread a voxel reads its (vc, uc) once and copies the C channel values
at that pixel into C rows of the (C, n) output: a gather, so bitwise the
plain version's `images[:, vc, uc]`. `.launches` counts the launches.
"""
from __future__ import annotations

import torch

from recon3d_tpu_torch import kernels


def sample_images_cuda(vc: torch.Tensor, uc: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """K9: (C, *vc.shape) float32, images[c, vc, uc] per voxel; CUDA tensors only."""
    if vc.dtype != torch.int32 or uc.dtype != torch.int32 or vc.shape != uc.shape or \
            images.dtype != torch.float32 or images.ndim != 3:
        raise ValueError("K9 takes int32 vc, uc of one shape and (C, H, W) float32 images")
    if not kernels.use_kernel(vc, uc, images):
        raise ValueError(f"K9 runs on CUDA tensors, got {vc.device}")
    vc, uc, images = vc.contiguous(), uc.contiguous(), images.contiguous()
    C, H, W = images.shape
    out = torch.empty((C, *vc.shape), dtype=torch.float32, device=vc.device)
    if vc.numel() == 0:
        return out
    kernels.launch("r3d_project_sample", vc.device, kernels.ptr(vc), kernels.ptr(uc),
                   kernels.ptr(images), kernels.ptr(out), vc.numel(), C, H, W)
    sample_images_cuda.launches += 1
    return out


sample_images_cuda.launches = 0
