"""SGM: the least time of the SGM stage's work of a frame (portbench/work.py:
sgm_work, counted from H, W, D, the paths and the block; the operations
bind) over the device ms of the SGM kernels (the layer's names in
kernels/), in %."""

from portbench.trace import layer_kernels
from portbench.work import least_ms


def read(view):
    ms = view.kernel_ms(layer_kernels("SGM"))
    if ms <= 0 or "sgm" not in view.work:
        return None
    w = view.work["sgm"]
    return 100.0 * least_ms(w["bytes"], w["ops"], w["ops_per_s"])[0] / ms
