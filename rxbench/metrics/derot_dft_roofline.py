"""``derot_dft`` (``derot_dft_kernel``): its share of the bytes roofline
per call, on the matrix-derot front half."""

from rxbench.metrics import kernel_bytes, roofline


def read(view):
    s = view.shapes.get("derot")
    if s is None:
        return None
    return roofline.share(view, ("derot_dft_kernel",), "derot_dft",
                          kernel_bytes.derot_dft(**s))
