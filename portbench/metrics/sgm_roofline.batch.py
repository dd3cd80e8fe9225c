"""sgm_roofline of the batched stereo cells, which report depth_fps.batch: the
same reader (metrics/sgm_roofline.py)."""
from pathlib import Path

from portbench.registry import load

read = load(Path(__file__).with_name("sgm_roofline.py")).read
