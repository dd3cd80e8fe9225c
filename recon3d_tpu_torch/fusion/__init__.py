from recon3d_tpu_torch.fusion.tsdf import TSDFVolume, integrate, make_volume  # noqa: F401
