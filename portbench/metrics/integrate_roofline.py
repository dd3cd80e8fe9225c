"""integrate: the least time of a frame's fusion (portbench/work.py:
integrate_work: the volume's tsdf, weight and colour read and written once a
step, each frame read once; the bytes bind) over all its device ms, in %."""

from portbench.work import least_ms


def read(view):
    ms = view.device_ms()
    if ms <= 0 or "integrate" not in view.work:
        return None
    w = view.work["integrate"]
    return 100.0 * least_ms(w["bytes"], w["ops"], w["ops_per_s"])[0] / ms
