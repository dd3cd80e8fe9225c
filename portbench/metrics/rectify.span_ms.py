"""rectification: stream ms a frame of the program's span `depth.rectify` (the
gray conversion and both remaps, K1), from
recon3d_tpu_torch.utils.profiling.span_totals() of the traced steps: from its
start event to its end event on the stream, idle inside it included."""

from recon3d_tpu_torch.utils import profiling


def read(view):
    totals = getattr(profiling, "span_totals", None)
    span = totals().get("depth.rectify") if totals else None
    if span is None or span["stream_ms"] is None:
        return None
    return span["stream_ms"] / view.frames
