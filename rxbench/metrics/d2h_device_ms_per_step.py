"""Device ms per step of the copies from device to host."""


def read(view):
    if not view.steps:
        return None
    return 1e3 * view.seconds(lambda n: n.startswith("Memcpy DtoH")) / view.steps
