"""depth.glue_ms of the batched stereo cells, which report depth_fps.batch: the
same reader (metrics/depth.glue_ms.py)."""
from pathlib import Path

from portbench.registry import load

read = load(Path(__file__).with_name("depth.glue_ms.py")).read
