"""K1 ``sync_align`` (``corr_argmax_kernel`` + ``window_kernel``): its share
of the bytes roofline per call, on the batch path."""

from rxbench.metrics import kernel_bytes, roofline


def read(view):
    s = view.shapes.get("k1")
    if s is None:
        return None
    return roofline.share(view, ("corr_argmax_kernel", "window_kernel"),
                          "sync_align", kernel_bytes.k1_sync_align(**s))
