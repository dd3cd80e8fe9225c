"""device.idle_share.depth of the batched stereo cells, which report depth_fps.batch: the
same reader (metrics/device.idle_share.depth.py)."""
from pathlib import Path

from portbench.registry import load

read = load(Path(__file__).with_name("device.idle_share.depth.py")).read
