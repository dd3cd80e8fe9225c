"""SGM: stream ms a frame of the program's span `sgm.aggregate` (the prefilter,
K2's walk and forward scan, K3, K4 and its LR check), from
recon3d_tpu_torch.utils.profiling.span_totals() of the traced steps: from its
start event to its end event on the stream, idle inside it included."""

from recon3d_tpu_torch.utils import profiling


def read(view):
    totals = getattr(profiling, "span_totals", None)
    span = totals().get("sgm.aggregate") if totals else None
    if span is None or span["stream_ms"] is None:
        return None
    return span["stream_ms"] / view.frames
