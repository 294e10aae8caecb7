"""K2 ``eq_demod_pack`` (``eq_demod_pack_kernel``): its share of the bytes
roofline per call."""

from rxbench.metrics import kernel_bytes, roofline


def read(view):
    s = view.shapes.get("k2")
    if s is None:
        return None
    return roofline.share(view, ("eq_demod_pack_kernel",), "eq_demod_pack",
                          kernel_bytes.k2_eq_demod_pack(**s))
