"""SGM: device ms a frame of the SGM kernels (K2 walk and scans, K3, K4 and its
LR check, K5; the layer's names in kernels/), by kernel name."""

from portbench.trace import layer_kernels


def read(view):
    ms = view.kernel_ms(layer_kernels("SGM"))
    return ms if ms > 0 else None
