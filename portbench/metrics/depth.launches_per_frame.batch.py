"""depth.launches_per_frame of the batched stereo cells, which report depth_fps.batch: the
same reader (metrics/depth.launches_per_frame.py)."""
from pathlib import Path

from portbench.registry import load

read = load(Path(__file__).with_name("depth.launches_per_frame.py")).read
