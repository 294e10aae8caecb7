"""The receive tail in one pass: the ``eq_demod_pack`` kernel and its plain version.

Kernel 2 of the port (``csrc/eq_demod_pack.cu``), replacing the TPU kernel
``ofdm_tpu/kernels/demod_pallas.py::eq_demod_pack`` and extended with the
per-chunk CFO phase of the matrix-derot decode (``rot_dc``,
ofdm_tpu/phy/rx.py:188-192), which the TPU kernel could not take, and with
an optional block table that reads each output block from another input
block (the chunked route's slot order, rx.py:742-828).  Per OFDM
block: rotate by the chunk's CFO phase, equalize by the channel estimate,
remove the mean pilot phase, take hard decisions and pack the bits LSB-first
into bytes.  Without it, eager torch would spend a separate pass over the
spectrum on each of those stages.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..config import FrameConfig
from ..phy.modulation import BITS_PER_SYMBOL, Modulation, demodulate_symbols_packed
from . import _build


def _check(yr, yi, h, f_delta, n_data, n_pilots, modulation, blocks):
    if yr.dtype != torch.float32 or yi.dtype != torch.float32 or yr.dim() != 3:
        raise ValueError("yr and yi must be float32 [B, NB, nbins]")
    if yr.shape != yi.shape or yr.stride() != yi.stride() or yr.device != yi.device:
        raise ValueError("yr and yi must share shape, strides and device")
    b, nb, nbins = yr.shape
    if yr.stride(2) != 1 or yr.stride(0) != nb * yr.stride(1) \
            or yr.stride(1) < nbins:
        raise ValueError("yr/yi need contiguous bins and evenly strided "
                         f"blocks, got strides {yr.stride()}")
    if h.dtype != torch.complex64 or tuple(h.shape) != (b, nbins) \
            or not h.is_contiguous():
        raise ValueError("h must be contiguous complex64 [B, nbins]")
    if f_delta.dtype != torch.float32 or tuple(f_delta.shape) != (b,) \
            or not f_delta.is_contiguous():
        raise ValueError("f_delta must be contiguous float32 [B]")
    if h.device != yr.device or f_delta.device != yr.device:
        raise ValueError("all inputs must lie on one device")
    if n_data <= 0 or n_pilots < 0 or n_data + n_pilots > nbins:
        raise ValueError(f"n_data={n_data} + n_pilots={n_pilots} must fit "
                         f"in nbins={nbins}")
    if n_data * BITS_PER_SYMBOL[modulation] % 8:
        raise ValueError("eq_demod_pack needs whole bytes per block")
    if blocks is not None and (blocks.dtype != torch.int32 or blocks.dim() != 1
                               or not blocks.is_contiguous()
                               or blocks.device != yr.device):
        raise ValueError("blocks must be a contiguous int32 [NB] tensor on "
                         "the planes' device")


def equalized_symbols(yr: torch.Tensor, yi: torch.Tensor, h: torch.Tensor,
                      f_delta: torch.Tensor, *, n_data: int, n_pilots: int,
                      cfg: FrameConfig) -> torch.Tensor:
    """The equalized data symbols, complex64 [B, NB * n_data], that the tail
    decides on: rot_dc multiply, y / h, mean pilot angle removed, as the JAX
    package writes it.  The plain version's front, and what the decode
    diagnostics show as the constellation."""
    nb = yr.shape[1]
    chunk = torch.arange(nb, dtype=torch.float32, device=yr.device) \
        + cfg.n_sync_chunks
    angle = f_delta[:, None] * (chunk * cfg.sym_len)
    rot_dc = torch.polar(torch.ones_like(angle), -angle)
    eq = torch.complex(yr, yi) * rot_dc[:, :, None] / h[:, None, :]
    data = eq[..., :n_data]
    if n_pilots:
        phi = torch.angle(eq[..., n_data:n_data + n_pilots]).mean(-1, keepdim=True)
        data = data * torch.polar(torch.ones_like(phi), -phi)
    return data.reshape(data.shape[0], -1)


def eq_demod_pack_reference(yr: torch.Tensor, yi: torch.Tensor, h: torch.Tensor,
                            f_delta: torch.Tensor, *, n_data: int,
                            n_pilots: int, modulation: Modulation,
                            cfg: FrameConfig,
                            blocks: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``eq_demod_pack``: the elementwise tail of the
    matrix-derot decode (``equalized_symbols``, then
    ``demodulate_symbols_packed``), after an ``index_select`` of the blocks
    when a table is given."""
    _check(yr, yi, h, f_delta, n_data, n_pilots, modulation, blocks)
    if blocks is not None:
        yr = yr.index_select(1, blocks.long())
        yi = yi.index_select(1, blocks.long())
    return demodulate_symbols_packed(
        equalized_symbols(yr, yi, h, f_delta, n_data=n_data,
                          n_pilots=n_pilots, cfg=cfg), modulation)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("eq_demod_pack")
    lib.ofdm_eq_demod_pack.restype = ctypes.c_int
    lib.ofdm_eq_demod_pack.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    return lib


def eq_demod_pack(yr: torch.Tensor, yi: torch.Tensor, h: torch.Tensor,
                  f_delta: torch.Tensor, *, n_data: int, n_pilots: int,
                  modulation: Modulation, cfg: FrameConfig,
                  blocks: torch.Tensor | None = None) -> torch.Tensor:
    """CFO phase + equalize + pilot phase + demod + pack, one pass.

    yr, yi: f32 [B, NB, nbins] DFT output at the selected bins (data bins,
    then pilot bins): contiguous bins, evenly strided blocks (the two halves
    of one [B, NB, 2*nbins] product qualify).  h: complex64 [B, nbins], the
    channel estimate at the same bins.  f_delta: f32 [B], the CFO estimate;
    data block c is rotated by exp(-j f_delta (c + n_sync_chunks) sym_len).
    blocks: None, or int32 [NB_out]: output block c reads input block
    ``blocks[c]`` (the kernel trusts the table to index inside the planes;
    the plain version's ``index_select`` checks it).  Returns uint8
    [B, NB_out * n_data * bps / 8], NB_out = NB without a table.

    A CPU tensor runs ``eq_demod_pack_reference``; a CUDA tensor launches the
    kernel (counted in ``eq_demod_pack.launches``); any other device raises.
    """
    _check(yr, yi, h, f_delta, n_data, n_pilots, modulation, blocks)
    if yr.device.type == "cpu":
        return eq_demod_pack_reference(yr, yi, h, f_delta, n_data=n_data,
                                       n_pilots=n_pilots,
                                       modulation=modulation, cfg=cfg,
                                       blocks=blocks)
    if yr.device.type != "cuda":
        raise ValueError(f"eq_demod_pack runs on cpu or cuda, not {yr.device}")
    b, nb, nbins = yr.shape
    if blocks is not None:
        nb = blocks.shape[0]
    bps = BITS_PER_SYMBOL[modulation]
    out = torch.empty((b, nb * n_data * bps // 8), dtype=torch.uint8,
                      device=yr.device)
    lib = _lib()
    err = lib.ofdm_eq_demod_pack(
        yr.data_ptr(), yi.data_ptr(), yr.stride(0), yr.stride(1), b, nb, nbins,
        n_data, n_pilots, bps, h.data_ptr(), f_delta.data_ptr(),
        cfg.n_sync_chunks, cfg.sym_len,
        None if blocks is None else blocks.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(yr.device).cuda_stream)
    _build.check(lib, err, "eq_demod_pack")
    eq_demod_pack.launches += 1
    return out


eq_demod_pack.launches = 0
