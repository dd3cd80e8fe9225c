"""wls.kernel_ms of the batched stereo cells, which report depth_fps.batch: the
same reader (metrics/wls.kernel_ms.py)."""
from pathlib import Path

from portbench.registry import load

read = load(Path(__file__).with_name("wls.kernel_ms.py")).read
