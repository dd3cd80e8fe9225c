from recon3d_tpu_torch.pointcloud.backproject import (  # noqa: F401
    backproject_depth,
    backproject_disparity,
    pointcloud_from_rgbd,
)
