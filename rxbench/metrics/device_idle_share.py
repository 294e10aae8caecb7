"""1 - (the union of the device items' intervals) / (the traced window)."""


def read(view):
    return 1.0 - view.busy_s() / view.window_s if view.window_s > 0 else None
