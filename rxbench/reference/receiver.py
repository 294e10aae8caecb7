"""A plain receiver of the wire format, the judge of the benchmark's cells.

Written from the reference algorithms (jkelleyrtp/ofdm src/receiver.rs:8-96
and SURVEY.md's receiver row), batched over rows, in plain PyTorch:

1. frame sync: the cross-correlation of each row with the locking block,
   |c[L]|^2 at every lag L, the first lag of the largest power, minus one
   (src/receiver.rs:20-25), the window clipped into the row.  A stream of
   frames at a fixed spacing is synced once, on its first spacing + 80
   samples, by the normalized matched filter |c[L]|^2 / E[L] (E the
   window's energy, summed in float64), and each frame then starts a
   spacing after the one before it;
2. the CFO: |angle(sum(chunk 4 * conj(chunk 3)))| / 80, from the last two
   preambles; the window is derotated by exp(-j f n);
3. the channel: the DFT of each of the five training blocks (cyclic prefix
   stripped) over the training bins, averaged;
4. per data block: the DFT, divided by the channel, the mean pilot angle
   removed, the nearest point of the Gray-coded square constellation
   (decisions round half to even), the bits packed least significant first;
5. Hamming(7,4): the syndrome of each codeword flips the one data bit it
   names.

It imports nothing of the program.  ``dtype`` sets the precision of every
step: float64 to judge; float32 is the control's, computed with whatever
matmul precision the process allows (TF32 where it is switched on), or with
its matmul operands rounded by ``operands``.  Every DFT is a real matmul on
packed [re | im] planes, so the matmul precision reaches it as it reaches
the program's DFT GEMM.  The correlation goes through ``torch.fft``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..wire import frame


def _complex(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def correlate(x: torch.Tensor, tpl: np.ndarray) -> torch.Tensor:
    """c[..., L] = sum_j x[..., L + j] conj(tpl[j]) for L in [0, T), the
    samples past T read as zero."""
    t, k = x.shape[-1], len(tpl)
    n = 1 << (t + k - 1).bit_length()
    w = torch.as_tensor(tpl, dtype=x.dtype, device=x.device)
    c = torch.fft.ifft(torch.fft.fft(x, n) * torch.fft.fft(w, n).conj())
    return c[..., :t]


def row_offsets(rows: torch.Tensor, need: int,
                search_window: int | None = None) -> torch.Tensor:
    """Each row's window start: argmax over lags of |c|^2, minus one,
    clipped to [0, T - need]; lags below search_window + 80 only, when
    given."""
    t = rows.shape[-1]
    c = correlate(rows, frame.locking())
    power = c.real ** 2 + c.imag ** 2
    if search_window is not None:
        power = power[..., :min(t, search_window + frame.SYM_LEN)]
    return torch.clamp(torch.argmax(power, dim=-1) - 1, 0, t - need)


def stream_first(stream: torch.Tensor, spacing: int) -> int:
    """The first frame's start in a stream of frames at ``spacing``: the
    normalized matched filter over lags below ``spacing``, minus one, at
    least 0."""
    k = frame.SYM_LEN
    head = stream[:spacing + k]
    head = torch.cat([head, head.new_zeros(spacing + k - head.shape[0])])
    c = correlate(head, frame.locking())[:spacing]
    en = (head.real.double() ** 2 + head.imag.double() ** 2)
    cs = torch.cat([en.new_zeros(1), torch.cumsum(en, 0)])
    energy = (cs[k:k + spacing] - cs[:spacing]).to(c.real.dtype)
    rho = (c.real ** 2 + c.imag ** 2) / (energy + 1e-30)
    return max(int(torch.argmax(rho)) - 1, 0)


def windows(x: torch.Tensor, starts: torch.Tensor, need: int) -> torch.Tensor:
    """x[..., s : s + need] for each start (rows of ``x``, or one stream
    for every start), zeros past the end."""
    t = x.shape[-1]
    idx = starts[:, None] + torch.arange(need, device=x.device)
    src = x if x.dim() == 2 else x[None].expand(len(starts), -1)
    got = src.gather(1, idx.clamp(max=t - 1))
    return torch.where(idx < t, got, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def _dft(x: torch.Tensor, bins, operands=None) -> torch.Tensor:
    """DFT over the last axis (64 samples) at ``bins``, as one real matmul
    on packed [re | im] planes; ``operands``, where given, maps both
    operands first (a rounding to a lower precision)."""
    n = np.arange(frame.N_FFT)
    w = np.exp(-2j * np.pi * np.outer(n, np.asarray(bins)) / frame.N_FFT)
    packed = np.block([[w.real, w.imag], [-w.imag, w.real]])
    m = torch.as_tensor(packed, dtype=x.real.dtype, device=x.device)
    a = torch.cat([x.real, x.imag], dim=-1)
    if operands is not None:
        a, m = operands(a), operands(m)
    out = a @ m
    k = len(bins)
    return torch.complex(out[..., :k], out[..., k:])


def _decide(eq: torch.Tensor, modulation: str) -> torch.Tensor:
    """Hard decisions: complex [..., n] -> uint8 bits [..., n bps]."""
    bps = frame.BITS_PER_SYMBOL[modulation]
    re, im = eq.real, eq.imag
    if bps == 1:
        bits = (re > 0)[..., None]
    elif bps == 2:
        first = re >= 0
        bits = torch.stack([first, torch.where(first, im >= 0, im > 0)], -1)
    else:
        half = bps // 2
        levels = 1 << half
        gray = torch.tensor([r ^ (r >> 1) for r in range(levels)],
                            device=eq.device)
        shifts = torch.arange(half, device=eq.device)

        def axis(v):
            rank = torch.clamp(torch.round((v + (levels - 1)) / 2.0), 0,
                               levels - 1).long()
            return (gray[rank][..., None] >> shifts) & 1

        bits = torch.cat([axis(re), axis(im)], dim=-1)
    return bits.reshape(*eq.shape[:-1], -1).to(torch.uint8)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bits [..., m] -> bytes [..., m // 8], least significant first."""
    n = bits.shape[-1] // 8
    g = bits[..., :8 * n].reshape(*bits.shape[:-1], n, 8).to(torch.int32)
    return (g << torch.arange(8, device=bits.device)).sum(-1).to(torch.uint8)


def decode_windows(win: torch.Tensor, *, n_blocks: int, modulation: str,
                   guard_bands: bool, operands=None) -> torch.Tensor:
    """Aligned windows [R, (10 + n_blocks) 80] starting at the locking block
    -> the decoded bytes [R, n_blocks * carriers * bps // 8]."""
    r = win.shape[0]
    sym, cp = frame.SYM_LEN, frame.CP_LEN
    chunks = win.reshape(r, -1, sym)
    last = frame.N_LOCKING + frame.N_PREAMBLE - 1
    left, right = chunks[:, last - 1], chunks[:, last]
    f = torch.angle((right * left.conj()).sum(-1)).abs() / sym
    n = torch.arange(win.shape[-1], dtype=f.dtype, device=win.device)
    derot = win * torch.polar(torch.ones_like(f)[:, None], -f[:, None] * n)
    chunks = derot.reshape(r, -1, sym)[..., cp:]
    t0 = frame.N_LOCKING + frame.N_PREAMBLE
    train = torch.as_tensor(frame.training(), dtype=win.dtype,
                            device=win.device)
    h = (_dft(chunks[:, t0:t0 + frame.N_TRAINING], range(frame.N_FFT),
              operands) / train).mean(1)
    data = frame.data_bins(guard_bands)
    bins = list(data) + (list(frame.PILOT_BINS) if guard_bands else [])
    y = _dft(chunks[:, frame.N_SYNC_CHUNKS:frame.N_SYNC_CHUNKS + n_blocks],
             bins, operands)
    eq = y / h[:, None, bins]
    nd = len(data)
    sy = eq[..., :nd]
    if guard_bands:
        phi = torch.angle(eq[..., nd:]).mean(-1, keepdim=True)
        sy = sy * torch.polar(torch.ones_like(phi), -phi)
    return _pack(_decide(sy.reshape(r, -1), modulation))


def decode_rows(rows: torch.Tensor, *, n_blocks: int, modulation: str,
                guard_bands: bool = True, dtype: torch.dtype = torch.float64,
                block_rows: int = 256, search_window: int | None = None,
                operands=None) -> torch.Tensor:
    """One frame a row, each synced on its own: complex [R, T] -> uint8
    [R, n_bytes] on the rows' device, ``block_rows`` rows at a time."""
    need = (frame.N_SYNC_CHUNKS + n_blocks) * frame.SYM_LEN
    out = []
    for i in range(0, rows.shape[0], block_rows):
        x = rows[i:i + block_rows].to(_complex(dtype))
        if x.shape[-1] < need:
            x = torch.cat([x, x.new_zeros((x.shape[0], need - x.shape[-1]))],
                          dim=-1)
        start = row_offsets(x, need, search_window)
        out.append(decode_windows(windows(x, start, need), n_blocks=n_blocks,
                                  modulation=modulation,
                                  guard_bands=guard_bands, operands=operands))
    return torch.cat(out)


def decode_stream(stream: torch.Tensor, *, n_frames: int, spacing: int,
                  n_blocks: int, modulation: str, guard_bands: bool = True,
                  dtype: torch.dtype = torch.float64, block_rows: int = 256,
                  operands=None) -> torch.Tensor:
    """Frames at a fixed spacing in one stream, synced once: complex [T] ->
    uint8 [n_frames, n_bytes]."""
    s = stream.to(_complex(dtype))
    first = stream_first(s, spacing)
    need = (frame.N_SYNC_CHUNKS + n_blocks) * frame.SYM_LEN
    out = []
    for i in range(0, n_frames, block_rows):
        k = torch.arange(i, min(n_frames, i + block_rows), device=s.device)
        out.append(decode_windows(windows(s, first + k * spacing, need),
                                  n_blocks=n_blocks, modulation=modulation,
                                  guard_bands=guard_bands, operands=operands))
    return torch.cat(out)


def hamming_decode(coded: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """uint8 [..., m] Hamming(7,4) code stream -> uint8 [..., n_bytes]: each
    7-bit codeword d0 d1 d2 d3 p0 p1 p2 (least significant first) has its
    data bit j flipped where the syndrome equals column j of H = [P^T | I3],
    P's rows 110, 101, 011, 111."""
    bits = (coded[..., None] >> torch.arange(8, device=coded.device)) & 1
    bits = bits.reshape(*coded.shape[:-1], -1)[..., :14 * n_bytes]
    c = bits.reshape(*coded.shape[:-1], 2 * n_bytes, 7).to(torch.int32)
    d = c[..., :4]
    s = ((d[..., 0] ^ d[..., 1] ^ d[..., 3] ^ c[..., 4])
         | (d[..., 0] ^ d[..., 2] ^ d[..., 3] ^ c[..., 5]) << 1
         | (d[..., 1] ^ d[..., 2] ^ d[..., 3] ^ c[..., 6]) << 2)
    column = torch.tensor([-1, -1, -1, 0, -1, 1, 2, 3], device=coded.device)
    flip = (column[s][..., None] == torch.arange(4, device=coded.device))
    d = d ^ flip.to(torch.int32)
    nib = (d << torch.arange(4, device=coded.device)).sum(-1)
    nib = nib.reshape(*nib.shape[:-1], n_bytes, 2)
    return (nib[..., 0] | nib[..., 1] << 4).to(torch.uint8)
