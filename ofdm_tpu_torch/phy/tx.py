"""Transmit chain: bytes -> OFDM sample stream (port of ofdm_tpu/phy/tx.py).

Wire format, identical to the reference encoder (src/transmitter.rs:11-58):

    [locking(80) | preamble x4 (80 each) | training+CP x5 (80 each) |
     data blocks x N (64-pt IFFT + 16 CP)]  all peak-normalized,

with the 16-byte little-endian u128 header ahead of the payload in the
modulated stream.  Frames are batched over leading axes and built on the
device of the payload tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import constants
from ..config import DEFAULT_CONFIG, FrameConfig
from ..core import device as device_mod
from ..fec import hamming
from ..ops.fft import device_table, dft_matmul, idft_matmul_rows_cp
from ..packets.header import Header
from .modulation import (BITS_PER_SYMBOL, Modulation, _pad_last,
                         modulate_bytes_packed)


@lru_cache(maxsize=None)
def _sync_prefix(cfg: FrameConfig) -> np.ndarray:
    """The constant frame prefix: locking + preambles + prefixed training."""
    lock = constants.locking_for(cfg)
    pre = constants.preamble(cfg.sym_len, cfg.preamble_seed)
    train = constants.training_signals(cfg.n_fft, cfg.training_seed)
    t_time = np.fft.ifft(train)
    t_prefixed = np.concatenate([t_time[-cfg.cp_len:], t_time])
    parts = ([lock] * cfg.n_locking + [pre] * cfg.n_preamble
             + [t_prefixed] * cfg.n_training)
    return np.concatenate(parts)


def n_data_blocks(payload_len: int, modulation: Modulation, guard_bands: bool,
                  cfg: FrameConfig = DEFAULT_CONFIG) -> int:
    """Number of data OFDM symbols for a payload of ``payload_len`` bytes
    (header included automatically, zero-padded final block)."""
    n_bits = (payload_len + cfg.header_len_bytes) * 8
    n_syms = -(-n_bits // BITS_PER_SYMBOL[modulation])
    return -(-n_syms // cfg.carriers_per_block(guard_bands))


def frame_len(payload_len: int, modulation: Modulation, guard_bands: bool,
              cfg: FrameConfig = DEFAULT_CONFIG) -> int:
    """Total samples in the transmitted frame."""
    return cfg.sync_len + n_data_blocks(payload_len, modulation, guard_bands,
                                        cfg) * cfg.sym_len


def _group_symbols(syms: torch.Tensor, carriers: int) -> torch.Tensor:
    """complex[..., n_syms] -> complex[..., nb, carriers], zero-padded tail
    (the reference's ``unwrap_or(0)``, src/transmitter.rs:149)."""
    nb = -(-syms.shape[-1] // carriers)
    syms = _pad_last(syms, nb * carriers - syms.shape[-1])
    return syms.reshape(*syms.shape[:-1], nb, carriers)


def symbols_to_blocks(syms: torch.Tensor, guard_bands: bool,
                      cfg: FrameConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """complex[..., n_syms] -> complex[..., n_blocks, n_fft] with the
    guard/pilot layout (src/transmitter.rs:144-165)."""
    grouped = _group_symbols(syms, cfg.carriers_per_block(guard_bands))
    if not guard_bands:
        return grouped
    blocks = grouped.new_zeros((*grouped.shape[:-1], cfg.n_fft))
    blocks[..., torch.as_tensor(cfg.data_indices, device=syms.device)] = grouped
    blocks[..., list(cfg.pilot_indices)] = cfg.pilot_value
    return blocks


def blocks_to_samples(blocks: torch.Tensor,
                      cfg: FrameConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """IFFT + cyclic prefix + flatten: [..., nb, n_fft] -> [..., nb*sym_len]."""
    t = dft_matmul(blocks, inverse=True)
    prefixed = torch.cat([t[..., -cfg.cp_len:], t], dim=-1)
    return prefixed.reshape(*prefixed.shape[:-2], -1)


def peak_normalize(stream: torch.Tensor) -> torch.Tensor:
    """Divide each frame row by its max positive real/imag component
    (src/transmitter.rs:183-194 takes max(re, im) without abs)."""
    m = torch.maximum(stream.real.amax(-1), stream.imag.amax(-1))
    return stream / m[..., None]


@lru_cache(maxsize=None)
def _pilot_time_cp(cfg: FrameConfig) -> np.ndarray:
    """Time waveform of the constant pilot tones, with its cyclic prefix."""
    spec = np.zeros(cfg.n_fft, dtype=np.complex128)
    spec[list(cfg.pilot_indices)] = cfg.pilot_value
    p = np.fft.ifft(spec)
    return np.concatenate([p[-cfg.cp_len:], p])


def encode_payload(payload: torch.Tensor, *, guard_bands: bool = False,
                   modulation: Modulation = Modulation.BPSK,
                   cfg: FrameConfig = DEFAULT_CONFIG,
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Batched encoder: uint8[..., L] (header already prepended) ->
    complex[..., frame_len] on the payload's device.

    complex64 with guard bands evaluates each symbol's IFFT from the 48
    populated data bins with the cyclic prefix folded into the matrix, plus
    the constant pilot waveform, instead of scattering into 64 bins and
    transforming all of them.  The two are equal up to summation order;
    complex128 keeps scatter + IFFT, whose output the golden wire-format
    fixtures freeze.
    """
    syms = modulate_bytes_packed(payload, modulation, dtype=dtype)
    if guard_bands and dtype == torch.complex64:
        grouped = _group_symbols(syms, cfg.carriers_per_block(True))
        t = idft_matmul_rows_cp(grouped, tuple(cfg.data_indices), cfg.n_fft,
                                cfg.cp_len)
        t = t + device_table(_pilot_time_cp, (cfg,), dtype, syms.device)
        data_samples = t.reshape(*t.shape[:-2], -1)
    else:
        data_samples = blocks_to_samples(
            symbols_to_blocks(syms, guard_bands, cfg), cfg)
    # Peak-normalize by the max positive real/imag component
    # (src/transmitter.rs:183-194, without abs).  The prefix is constant, so
    # its peak is a host scalar and the reduction runs over the data only.
    prefix_np = _sync_prefix(cfg).astype(
        np.complex64 if dtype == torch.complex64 else np.complex128)
    pm = max(float(prefix_np.real.max()), float(prefix_np.imag.max()))
    m = torch.maximum(data_samples.real.amax(-1), data_samples.imag.amax(-1))
    m = torch.clamp(m, min=pm)[..., None]
    prefix = device_table(_sync_prefix, (cfg,), dtype, syms.device)
    prefix = prefix.expand(*data_samples.shape[:-1], prefix.shape[0])
    out = torch.cat([prefix, data_samples], dim=-1)
    return torch.complex(out.real / m, out.imag / m)


def _bytes_on(data, device) -> torch.Tensor:
    """uint8 tensor of bytes, a bytearray, an array or a tensor, placed as
    ``core.device`` says."""
    if isinstance(data, torch.Tensor):
        return device_mod.place(data, device).to(torch.uint8)
    if isinstance(data, (bytes, bytearray)):
        host = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    else:
        host = torch.as_tensor(np.array(data, dtype=np.uint8))   # a writable copy
    return host.to(device_mod.resolve(device))


def encode(data, guard_bands: bool = False,
           modulation: Modulation = Modulation.BPSK,
           cfg: FrameConfig = DEFAULT_CONFIG,
           dtype: torch.dtype = torch.complex64,
           device=None) -> torch.Tensor:
    """Reference-parity entry point (src/transmitter.rs:11-58).

    ``data``: bytes | uint8 array [L] or [B, L] | uint8 tensor.  Returns
    complex[(B,) T] with the length header prepended, on ``device``: a
    tensor's own device when None, else CUDA for bytes and arrays (raises
    where CUDA is absent; pass ``device="cpu"`` to run on the CPU).
    """
    arr = _bytes_on(data, device)
    header = torch.frombuffer(bytearray(Header(arr.shape[-1]).to_bytes()),
                              dtype=torch.uint8).to(arr.device)
    header = header.expand(*arr.shape[:-1], header.shape[0])
    payload = torch.cat([header, arr], dim=-1)
    return encode_payload(payload, guard_bands=guard_bands,
                          modulation=modulation, cfg=cfg, dtype=dtype)


def encode_hamming(data, *, guard_bands: bool = False,
                   modulation: Modulation = Modulation.BPSK,
                   cfg: FrameConfig = DEFAULT_CONFIG,
                   dtype: torch.dtype = torch.complex64,
                   device=None) -> torch.Tensor:
    """FEC + modem encoder: uint8[..., n] USER bytes -> frames whose payload
    is the Hamming(7,4)-coded stream (the transmit side of the Hamming
    tail of ``phy.streaming``).  Wire-identical to
    ``encode(fec.hamming.encode(data), ...)``, which it is; ``data`` and
    ``device`` as for ``encode``.
    """
    return encode(hamming.encode(_bytes_on(data, device)),
                  guard_bands=guard_bands, modulation=modulation, cfg=cfg,
                  dtype=dtype)
