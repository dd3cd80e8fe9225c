"""torch glue (depth): device ms a frame of every kernel that is not one of the
port's own (csrc/*.cu, every layer's names in kernels/): gray conversion,
prefilter, speckle, casts, depth, cloud. Copies and fills are not kernels
and show only in depth.launches_per_frame and the breakdown."""

from portbench.trace import layer_kernels


def read(view):
    ms = view.other_kernel_ms(layer_kernels())
    return ms if ms > 0 else None
