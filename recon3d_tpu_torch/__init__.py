"""recon3d_tpu_torch: the PyTorch + CUDA port of recon3d_tpu for NVIDIA Hopper.

The JAX package `recon3d_tpu` stays the reference; this package mirrors its
tree (``recon3d_tpu_torch/depth/sgm.py`` twins ``recon3d_tpu/depth/sgm.py``)
with the same public names, taking ``torch.Tensor``.

Every kernel the JAX package wrote in Pallas is a hand-written CUDA C++
kernel under ``csrc/``, built on first use by one ``nvcc`` call into a
plain C shared library (``kernels/__init__.py``). Each kernel wrapper
launches its kernel for a CUDA tensor and runs its plain PyTorch version
for a CPU tensor; any other device raises.

Ported so far:
- depth: raw pair -> two-pass rectification warp -> SGM (3, 4 or 8
  directions) -> WLS refine -> depth -> colored point cloud, row-sharded
  and frame-batched over 1-D meshes, and `depth.DepthPipeline` over a
  calibrated rig;
- point clouds: RGB-D frame -> colored cloud -> voxel downsample and
  outlier removal (`pointcloud_processing`) -> grid PCA normals and
  orientation (`normal_estimation`);
- fusion and meshing: TSDF integrate -> marching tetrahedra -> mesh ops ->
  PLY, and spectral Poisson reconstruction with density coloring
  (`mesh_reconstruction`, `mesh_saving`);
- registration (ICP / GICP, FPFH, RANSAC / FGR, RGB-D odometry, pose graph)
  and batched pair registration (`parallel.batch`);
- calibration (`calib/`) and PNG frame IO;
- the scanners: `pipeline.streaming.StreamingFusion` (odometry + TSDF a
  frame), `pipeline.scanner.StreamingScanner` (capture -> align ->
  accumulate, then process -> normals -> Poisson -> save) and
  `pipeline.offline.Scanner3D` (capture / save -> batched RANSAC-FPFH ->
  pose graph -> TSDF -> mesh -> PLY), over the synthetic, stereo and PNG
  replay cameras of `camera/`.

Importing the package builds no kernel and needs no card. On the CPU,
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py`` holds each
part to the JAX package; on a machine with one H100, ``python3
chip_smoke.py`` from the repository root builds the kernels and drives
every path, the scanners included, holding each kernel to its plain
version.
"""

__version__ = "0.1.0"

from recon3d_tpu_torch.utils.types import PointCloud, RGBDImage, TriangleMesh  # noqa: F401
from recon3d_tpu_torch.depth.matcher import (  # noqa: F401
    StereoMatcher,
    compute_disparity,
    disparity_to_depth,
    reproject_image_to_3d,
)
from recon3d_tpu_torch.depth.pipeline import DepthPipeline, depth_step  # noqa: F401
from recon3d_tpu_torch.depth.filters import (  # noqa: F401
    DepthFilterBank,
    decimation_filter,
    hole_filling_filter,
    spatial_filter,
    temporal_filter,
)
