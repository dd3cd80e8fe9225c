"""entry: host ms a frame inside the program's root spans (those with no program
parent: depth.process, pointcloud.backproject; batch.depth in the batched cell),
from recon3d_tpu_torch.utils.profiling.span_totals() of the traced steps: the
program's enqueue time, an upper bound under the profiler."""

from recon3d_tpu_torch.utils import profiling


def read(view):
    totals = getattr(profiling, "span_totals", None)
    roots = [s["host_ms"] for s in totals().values() if s["parent"] is None] if totals else []
    return sum(roots) / view.frames if roots else None
