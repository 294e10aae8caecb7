"""Device ms per step of every kernel that is neither a hand kernel of the
port's ``csrc/`` nor a copy or a set: the front half's torch ops, the DFT
GEMM, the global sync and the Hamming decode."""

from rxbench import trace

HAND_KERNELS = ("corr_argmax_kernel", "window_kernel", "planar_align_kernel",
                "chunk_kernel", "row_key_kernel", "eq_demod_pack_kernel",
                "rowmajor_copy_kernel")


def read(view):
    if not view.steps:
        return None
    t = view.seconds(lambda n: not trace.is_copy(n)
                     and not any(k in n for k in HAND_KERNELS))
    return 1e3 * t / view.steps
