"""Device kernels, copies and sets per step of the traced window."""


def read(view):
    return len(view.device) / view.steps if view.steps else None
