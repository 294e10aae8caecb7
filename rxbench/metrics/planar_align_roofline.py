"""K3 ``planar_align`` (``planar_align_kernel``): its share of the bytes
roofline per call, on the stream path."""

from rxbench.metrics import kernel_bytes, roofline


def read(view):
    s = view.shapes.get("k3")
    if s is None:
        return None
    return roofline.share(view, ("planar_align_kernel",), "planar_align",
                          kernel_bytes.k3_planar_align(**s))
