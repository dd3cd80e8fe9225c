from recon3d_tpu_torch.camera.base import Camera, ThreadedCamera  # noqa: F401
from recon3d_tpu_torch.camera.fake import FakeRGBDCamera, FakeStereoCamera, SyntheticRGBDCamera  # noqa: F401
