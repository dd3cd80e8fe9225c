"""device: share of the traced window with no kernel, copy or fill on the card,
in % (fusion cells)."""


def read(view):
    return 100.0 * view.idle_share() if view.ops else None
