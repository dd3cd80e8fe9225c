"""integrate: stream ms a frame of the program's root spans (tsdf.integrate,
fusion.integrate_exact) less those of `tsdf.project` and `tsdf.sample` inside
them: the truncation, the running averages and, in the sharded fusion, the
two passes' folds and their composition. From
recon3d_tpu_torch.utils.profiling.span_totals() of the traced steps."""

from recon3d_tpu_torch.utils import profiling


def read(view):
    totals = getattr(profiling, "span_totals", None)
    spans = totals() if totals else {}
    roots = [s["stream_ms"] for s in spans.values() if s["parent"] is None]
    parts = [spans.get(n, {}).get("stream_ms") for n in ("tsdf.project", "tsdf.sample")]
    if not roots or None in roots or None in parts:
        return None
    return (sum(roots) - sum(parts)) / view.frames
