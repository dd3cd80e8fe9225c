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
