"""rectification: device ms of K1 a frame (the two-pass warp; the layer's
names in kernels/), by kernel name."""

from portbench.trace import layer_kernels


def read(view):
    ms = view.kernel_ms(layer_kernels("rectification"))
    return ms if ms > 0 else None
