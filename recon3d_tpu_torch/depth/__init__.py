from recon3d_tpu_torch.depth.matcher import (  # noqa: F401
    StereoMatcher,
    compute_disparity,
    disparity_to_depth,
    reproject_image_to_3d,
)
from recon3d_tpu_torch.depth.pipeline import DepthPipeline, depth_step  # noqa: F401
