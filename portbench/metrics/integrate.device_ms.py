"""integrate: all device ms (kernels, copies and fills) of a frame's fusion."""


def read(view):
    ms = view.device_ms()
    return ms if ms > 0 else None
