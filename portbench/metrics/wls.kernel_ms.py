"""WLS: device ms a frame of K6, the tridiagonal solves (the layer's names
in kernels/), by kernel name."""

from portbench.trace import layer_kernels


def read(view):
    ms = view.kernel_ms(layer_kernels("WLS"))
    return ms if ms > 0 else None
