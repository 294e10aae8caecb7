"""ofdm_tpu_torch: the OFDM transceiver of ``ofdm_tpu`` in PyTorch, with CUDA
kernels written for the NVIDIA H100 (sm_90a).

It imports torch and numpy, never jax: it runs where the JAX package is
absent, and ``ofdm_tpu`` stays the reference it is tested against.  Module
layout and names mirror ``ofdm_tpu``.  Functions take tensors and work on
their device; ``encode``, ``decode`` and the stream decoders also take
bytes or numpy arrays,
which they put on CUDA unless the caller passes ``device=`` (``"cpu"`` to
run on the CPU).  Randomness comes from explicit ``torch.Generator``s.

On CUDA the decode path refuses to run while TF32 is allowed for cuBLAS
matmuls or cuDNN convolutions (the latter allow it by default): call
``ofdm_tpu_torch.ops.fft.set_full_fp32()`` first.  The kernels build with ``nvcc`` at first use into
``build/ofdm_tpu_torch/``.
"""

from .config import DEFAULT_CONFIG, FrameConfig
from .obs.analysis import Analysis
from .phy.channel import channel
from .phy.modulation import Modulation
from .phy.rx import (DecodeError, decode, decode_aligned, decode_chunked_matrix,
                     decode_frame, decode_frame_planar, decode_planar_matrix,
                     sync_offset)
from .phy.streaming import decode_burst, decode_continuous, decode_regular
from .phy.tx import (encode, encode_hamming, encode_payload, frame_len,
                     n_data_blocks)

__all__ = [
    "Analysis",
    "DEFAULT_CONFIG",
    "DecodeError",
    "FrameConfig",
    "Modulation",
    "channel",
    "decode",
    "decode_aligned",
    "decode_burst",
    "decode_chunked_matrix",
    "decode_continuous",
    "decode_frame",
    "decode_frame_planar",
    "decode_planar_matrix",
    "decode_regular",
    "encode",
    "encode_hamming",
    "encode_payload",
    "frame_len",
    "n_data_blocks",
    "sync_offset",
]
