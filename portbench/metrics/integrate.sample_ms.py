"""integrate: stream ms a frame of the program's span `tsdf.sample` (the image
stack and K9's gather; twice a frame in the sharded fusion), from
recon3d_tpu_torch.utils.profiling.span_totals() of the traced steps: from its
start event to its end event on the stream, idle inside it included."""

from recon3d_tpu_torch.utils import profiling


def read(view):
    totals = getattr(profiling, "span_totals", None)
    span = totals().get("tsdf.sample") if totals else None
    if span is None or span["stream_ms"] is None:
        return None
    return span["stream_ms"] / view.frames
