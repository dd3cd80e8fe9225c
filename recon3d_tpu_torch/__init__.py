"""recon3d_tpu_torch: the PyTorch + CUDA port of recon3d_tpu for NVIDIA Hopper.

The JAX package `recon3d_tpu` stays the reference; this package mirrors its
tree (``recon3d_tpu_torch/depth/sgm.py`` twins ``recon3d_tpu/depth/sgm.py``)
with the same public names, taking ``torch.Tensor``.

Every kernel the JAX package wrote in Pallas is a hand-written CUDA C++
kernel under ``csrc/``, built on first use by one ``nvcc`` call into a
plain C shared library (``kernels/__init__.py``). Each kernel wrapper
launches its kernel for a CUDA tensor and runs its plain PyTorch version
for a CPU tensor; any other device raises.

Ported so far: the stereo depth path, raw pair -> two-pass rectification
warp -> SGM (3, 4 or 8 directions) -> WLS refine -> depth -> colored point
cloud, and `depth.DepthPipeline` over a calibrated rig.
"""
