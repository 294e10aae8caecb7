"""Multi-frame stream decoding (port of ofdm_tpu/phy/streaming.py).

A capture buffer holds many frames.  Three entry points decode them all:

- ``decode_regular``: frames at a fixed spacing (a transmit loop).  One
  global sync on the first ``spacing + sym_len`` samples finds the first
  frame; the ``planar_align`` kernel (K3) then cuts every frame out of the
  stream in one launch, reading the one stream for all rows (row stride
  0) at offsets ``first + i * spacing`` that stay on the device, with
  zeros past the end of the stream.  The rows go to the matrix-derot tail
  (``resync=False``) or to the batched decoder's per-row resync
  (``resync=True``).  With ``fec="hamming"`` the Hamming decode runs on the
  device too, so the call waits for the device once: when it fetches the
  corrected bytes.
- ``decode_burst``: frames at arbitrary gaps.  Every acquisition window is
  scanned at once (normalized matched filter), the host gates the
  detections (one wait), and K3 cuts every detected frame out for one
  batched decode.
- ``decode_continuous``: the host-driven scan: one window at a time, a
  gate per window, a decode per frame.

FEC: Hamming(7,4) on the device, or RS(255,223) on the host
(``fec/reed_solomon.py``).  Deliberate differences from the JAX package are
in ofdm_tpu_torch/PARITY.md: no pre-tiled stream, rows read zeros past the
end of a short stream, unknown selectors and ``spacing`` below the frame
length raise, and no jit cache or power-of-two row bucket.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, FrameConfig
from ..core import device as device_mod
from ..fec import hamming
from ..fec import reed_solomon as rs
from ..kernels.align import planar_align
from ..obs import profiler
from ..ops.fft import require_full_fp32
from ..ops.xcorr import (locking_sync_quality, sliding_correlation,
                         sliding_correlation_matmul, window_energy)
from ..packets.header import HEADER_LEN
from .modulation import Modulation, _pad_last
from .rx import (_decode_planes, decode_aligned, decode_frame,
                 decode_frame_planar, decode_planar_matrix, locking_template)
from .tx import n_data_blocks

FECS = (None, "hamming", "rs")
PLANAR_HANDOFFS = ("planar", "complex", "split")


def _check_fec(fec) -> None:
    if fec not in FECS:
        raise ValueError(f"unknown fec {fec!r}; expected one of {FECS}")


def _defec(payload: np.ndarray, fec: str | None, n_bytes: int):
    if fec is None:
        return payload[:n_bytes], True
    if fec == "hamming":
        return hamming.decode(torch.as_tensor(payload), n_bytes).numpy(), True
    if fec == "rs":
        out, ok = rs.decode_stream(payload)
        return out[:n_bytes], ok
    raise ValueError(f"unknown fec {fec!r}")


def coded_len(n_bytes: int, fec: str | None) -> int:
    """Payload bytes on the wire for ``n_bytes`` of user data under ``fec``."""
    if fec is None:
        return n_bytes
    if fec == "hamming":
        return hamming.encoded_len(n_bytes)
    if fec == "rs":
        return (n_bytes // rs.K + 1) * rs.N
    raise ValueError(f"unknown fec {fec!r}")


def _defec_rows(raw: np.ndarray, fec: str | None, n_bytes: int):
    """Host FEC over frame rows: [R, payload_len] -> ([R, n_bytes], ok[R]).
    RS rows decode in one batched native call (rs.decode_payload_rows);
    Hamming rows in one batched call, which gives the JAX package's
    per-row bytes."""
    if fec is None:
        return raw[:, :n_bytes].copy(), np.ones(raw.shape[0], bool)
    if fec == "rs":
        return rs.decode_payload_rows(raw, n_bytes)
    if fec == "hamming":
        return (hamming.decode(torch.as_tensor(raw), n_bytes).numpy(),
                np.ones(raw.shape[0], bool))
    raise ValueError(f"unknown fec {fec!r}")


def _norm_sync_argmax(head: torch.Tensor, template, spacing: int) -> torch.Tensor:
    """Normalized-matched-filter sync over ``head`` (the scan prefix):
    rho[L] ∝ |c[L]|^2 / E_window[L], argmax over lags < spacing, minus 1.

    The raw |c|^2 argmax (the reference's statistic, src/receiver.rs:20-25)
    can be beaten by a random data segment: QPSK payloads exist whose body
    out-correlates the true locking block by ~10%, and then every frame of
    the buffer decodes garbage.  Dividing by the window energy is bounded
    by Cauchy-Schwarz: rho ~= 1 at the true locking block, strictly below
    for any non-proportional segment.  The E_template factor is constant
    and dropped; E_window comes from ``ops.xcorr.window_energy``'s float64
    running sum (fault F8).  The argmax stops below ``spacing``: with identical
    repeated frames the next frame's locking block correlates exactly as
    high, and rounding could otherwise hand the tie to the later peak."""
    k = int(np.shape(template)[-1])
    c = sliding_correlation_matmul(head, template)
    power = c.real ** 2 + c.imag ** 2
    rho = power[..., :spacing] / (window_energy(head, k, spacing) + 1e-30)
    return torch.argmax(rho, dim=-1) - 1


def _first_sync(s: torch.Tensor, *, spacing: int,
                cfg: FrameConfig) -> torch.Tensor:
    """The first frame's sync offset (argmax - 1, a 0-d int64 tensor on the
    stream's device) from the complex stream's first spacing + sym_len
    samples, zero-padded where the stream is shorter."""
    head = s[:spacing + cfg.sym_len]
    head = _pad_last(head, spacing + cfg.sym_len - head.shape[-1])
    return _norm_sync_argmax(head, locking_template(cfg), spacing)


def _first_sync_planar(sp: torch.Tensor, *, spacing: int,
                       cfg: FrameConfig) -> torch.Tensor:
    """``_first_sync`` for a planar stream f32 [2, T]: only the scan prefix
    is assembled as complex (spacing + sym_len samples)."""
    head = torch.complex(sp[0, :spacing + cfg.sym_len],
                         sp[1, :spacing + cfg.sym_len])
    head = _pad_last(head, spacing + cfg.sym_len - head.shape[-1])
    return _norm_sync_argmax(head, locking_template(cfg), spacing)


def _rows(stream: torch.Tensor, first: torch.Tensor, *, n_frames: int,
          spacing: int, flen: int, planar: bool) -> torch.Tensor:
    """K3 on the shared stream: row i = stream[first + i*spacing :][:flen],
    zeros past the end; f32 planes [n, 2, flen] or complex64 [n, flen]."""
    with profiler.span("stream.align", stream):
        offsets = first + torch.arange(n_frames, device=stream.device) * spacing
        return planar_align(stream, offsets, flen, planar=planar)


def _extract_and_decode(stream: torch.Tensor, first: torch.Tensor, *,
                        n_frames: int, spacing: int, nb: int, flen: int,
                        guard_bands: bool, modulation: Modulation,
                        cfg: FrameConfig) -> torch.Tensor:
    """Per-row resync: K3 rows (as planes, from a complex or a planar
    stream) into the batched decoder with a one-symbol search window (K1,
    then K2).  Each row is exactly one frame long, so the decoder clips
    every row's offset to 0, as the JAX package's does (fault F7 in
    ROADMAP.md: the resync cannot follow drift; it is ported as it is)."""
    rows = _rows(stream, first, n_frames=n_frames, spacing=spacing, flen=flen,
                 planar=True)
    return decode_frame_planar(rows, n_blocks=nb, guard_bands=guard_bands,
                               modulation=modulation, cfg=cfg,
                               search_window=cfg.sym_len)


def _extract_and_decode_presync(stream: torch.Tensor, first: torch.Tensor, *,
                                n_frames: int, spacing: int, nb: int,
                                flen: int, guard_bands: bool,
                                modulation: Modulation, cfg: FrameConfig,
                                handoff: str = "planar") -> torch.Tensor:
    """Trust the global sync and the spacing: K3 rows straight into the
    matrix-derot tail (K2), no per-row sync.

    ``handoff`` picks the intermediate between K3 and the tail:
    - "planar": K3 writes f32 planes [n, 2, flen] (from a planar stream or
      deinterleaving a complex one in its copy) for ``decode_planar_matrix``;
    - "complex": K3 writes complex64 rows for ``decode_aligned``;
    - "split": K3's planes go to the matrix core as two plane views.
    A complex stream takes "planar" (the JAX package's complex presync
    hands complex rows to the same matrix tail).
    """
    n_chunks = cfg.n_sync_chunks + nb
    kw = dict(guard_bands=guard_bands, modulation=modulation, cfg=cfg,
              cfo_estimator="coherent")
    rows = _rows(stream, first, n_frames=n_frames, spacing=spacing, flen=flen,
                 planar=handoff != "complex")
    if handoff == "complex":
        return decode_aligned(rows, n_chunks=n_chunks, derot_impl="matrix",
                              **kw)[0]
    if handoff == "split":
        return _decode_planes(rows, n_chunks=n_chunks, derot="matrix", **kw)[0]
    return decode_planar_matrix(rows, n_chunks=n_chunks, **kw)[0]


def _stream(samples, device):
    """(stream, planar): complex64 [T] or f32 [2, T] on its device (TF32
    must be off there, ``ops.fft.require_full_fp32``)."""
    x = device_mod.as_tensor(samples, device)
    require_full_fp32(x.device)
    if x.dim() == 3 and x.shape[0] == 2 and x.shape[-1] == 128 \
            and not x.is_complex():
        raise ValueError(
            "the pre-tiled planar stream [2, tiles, 128] is a TPU layout and "
            "is not taken here; pass the planes as f32 [2, T]")
    if x.dim() == 1 and x.is_complex():
        return x.to(torch.complex64), False
    if x.dim() == 2 and x.shape[0] == 2 and not x.is_complex():
        return x.to(torch.float32), True
    raise ValueError(f"a stream is complex [T] or real planes [2, T], got "
                     f"{x.dtype} {tuple(x.shape)}")


def decode_regular(samples, *, n_frames: int, spacing: int, payload_len: int,
                   guard_bands: bool = True,
                   modulation: Modulation = Modulation.QPSK,
                   fec: str | None = None, data_len: int | None = None,
                   resync: bool = True, planar_handoff: str = "planar",
                   cfg: FrameConfig = DEFAULT_CONFIG, device=None):
    """Decode ``n_frames`` frames at a fixed ``spacing`` from one stream.

    samples: complex [T], or a planar f32 [2, T] stream (any strides, e.g.
    ``torch.view_as_real(x).t()``), on ``device``: a tensor's own device
    when None, else CUDA for an array (raises where CUDA is absent; pass
    ``device="cpu"`` to run on the CPU).  The first frame may start
    anywhere within the first ``spacing`` samples (a global sync resolves
    it).  No complex copy of a planar stream, and no padded or expanded
    copy of any stream, is made: K3 cuts the frames out of it directly,
    reading zeros past its end.  Returns numpy (payloads [n_frames, data_len
    or payload_len], ok flags [n_frames]).

    ``resync=True`` (default) runs the batched decoder's sync on every
    frame within a one-symbol window; ``resync=False`` trusts the global
    sync and the spacing and runs the matrix-derot tail on the rows.
    ``planar_handoff`` ("planar" | "complex" | "split") picks the presync
    intermediate on a planar stream (``_extract_and_decode_presync``).
    ``fec``: None, "hamming" (decoded on the device) or "rs" (on the host).
    The call waits for the device once, when it fetches the bytes.
    An unknown ``fec`` or ``planar_handoff``, a ``spacing`` below the frame
    length, or the TPU's pre-tiled [2, tiles, 128] stream raises ValueError.
    """
    with profiler.span("stream.decode_regular", samples):
        stream, planar = _stream(samples, device)
        nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
        flen = cfg.sync_len + nb * cfg.sym_len
        if spacing < flen:
            raise ValueError(f"spacing {spacing} < frame length {flen}")
        _check_fec(fec)
        if planar_handoff not in PLANAR_HANDOFFS:
            raise ValueError(f"unknown planar_handoff {planar_handoff!r}; "
                             f"expected one of {PLANAR_HANDOFFS}")
        n_bytes = data_len if data_len is not None else payload_len

        # One sync for the first frame; its offset stays on the device, so
        # the whole buffer decodes before the host waits for anything.
        sync = _first_sync_planar if planar else _first_sync
        with profiler.span("stream.sync", stream):
            first = sync(stream, spacing=spacing, cfg=cfg).clamp(min=0)
        kw = dict(n_frames=n_frames, spacing=spacing, nb=nb, flen=flen,
                  guard_bands=guard_bands, modulation=modulation, cfg=cfg)
        if resync:
            out = _extract_and_decode(stream, first, **kw)
        else:
            out = _extract_and_decode_presync(
                stream, first, handoff=planar_handoff if planar else "planar",
                **kw)
        payload = out[:, HEADER_LEN:HEADER_LEN + payload_len]
        if fec == "hamming":
            # the Hamming decode runs on the device: only the corrected user
            # bytes leave it
            with profiler.span("stream.hamming", payload):
                payload = hamming.decode(payload, n_bytes)
        with profiler.span("stream.fetch", payload):
            raw = payload.cpu().numpy()
        if fec == "hamming":
            return raw, np.ones(n_frames, bool)
        return _defec_rows(raw, fec, n_bytes)


def _scan_windows(s: torch.Tensor, *, n_win: int, stride: int,
                  cfg: FrameConfig, first_window: int = 0):
    """Frame detection over the whole stream at once.

    Window i (of ``first_window`` .. ``first_window + n_win - 1``: a share
    of the windows, in ``parallel.pipeline.decode_burst_sharded``) scans
    candidate frame starts (lags) [i*stride, (i+1)*stride);
    the argmax is masked to that range so a stronger locking block just
    outside it (the next frame's) cannot steal the detection.  Returns
    (lags [n_win] relative to each window, argmax of the power minus 1;
    rho [n_win], the normalized matched filter's maximum: ~snr/(1+snr) at a
    true locking block and ~ln(stride)/k on signal-free or data-only lags,
    whatever frame bodies share the window).  Windows read zeros past the
    end of the stream.
    """
    template = locking_template(cfg).astype(np.complex64)
    k = template.shape[-1]
    wlen = stride + k - 1
    t = s.shape[-1]
    idx = ((torch.arange(n_win, device=s.device)[:, None] + first_window)
           * stride + torch.arange(wlen, device=s.device)[None, :])
    w = torch.where(idx < t, s[idx.clamp(max=t - 1)], 0)
    c = sliding_correlation(w, template)
    # output index i = lag i-(k-1); keep exactly the in-range lags [0, stride)
    power = (c.real ** 2 + c.imag ** 2)[..., k - 1:k - 1 + stride]
    e_t = float(np.sum(np.abs(template) ** 2))
    rho = power / (e_t * window_energy(w, k, stride) + 1e-30)
    return torch.argmax(power, dim=-1) - 1, rho.amax(dim=-1)


def _decode_at_positions(s: torch.Tensor, pos: torch.Tensor, *, nb: int,
                         flen: int, guard_bands: bool, modulation: Modulation,
                         cfg: FrameConfig) -> torch.Tensor:
    """Batched aligned decode of the frames at exact start positions: K3
    cuts them out of the stream (zeros past its end), then the matrix
    tail (K2)."""
    rows = planar_align(s, pos, flen, planar=True)
    return decode_planar_matrix(rows, n_chunks=cfg.n_sync_chunks + nb,
                                guard_bands=guard_bands, modulation=modulation,
                                cfg=cfg, cfo_estimator="coherent")[0]


def _gate_detections(offs: np.ndarray, pars: np.ndarray, *, t: int,
                     stride: int, flen: int, detection_rho: float,
                     max_frames: int | None, cfg: FrameConfig) -> list[int]:
    """Host-side detection gate + non-max suppression of decode_burst."""
    n_win = offs.shape[-1]
    # off == -1 is the reference's clean-alignment quirk (lag 0): clamp to
    # the window start, like decode() clamps offset -1 to 0
    cand = [(float(pars[i]), int(i * stride + max(int(offs[i]), 0)))
            for i in range(n_win)
            if pars[i] >= detection_rho
            and i * stride + max(int(offs[i]), 0) + flen <= t + cfg.sym_len]
    # non-max suppression by rho: a partial locking-block match at a window
    # tail (the ramp correlates with its own shifted tail) scores above the
    # gate but below the true peak in the next window — strongest-first
    # acceptance keeps the true one, earliest-first would shadow it
    detections: list[int] = []
    for rho, p in sorted(cand, key=lambda c: -c[0]):
        if all(abs(p - q) >= flen for q in detections):
            detections.append(p)
    detections.sort()
    if max_frames is not None:
        detections = detections[:max_frames]
    return detections


def _complex_stream(samples, device) -> torch.Tensor:
    stream, planar = _stream(samples, device)
    if planar:
        raise ValueError("burst and continuous decoding take a complex stream")
    return stream


def decode_burst(samples, *, payload_len: int, guard_bands: bool = True,
                 modulation: Modulation = Modulation.QPSK,
                 fec: str | None = None, data_len: int | None = None,
                 acquisition: int = 4096, max_frames: int | None = None,
                 detection_rho: float = 0.3,
                 cfg: FrameConfig = DEFAULT_CONFIG, device=None) -> list[tuple]:
    """Decode every frame in a complex stream with arbitrary gaps.

    All acquisition windows are scanned at once; the host applies the
    normalized-matched-filter gate (``detection_rho``: a true locking block
    scores ~snr/(1+snr), so 0.3 detects down to ~-4 dB SNR; data-only
    windows score ~ln(stride)/80 ~= 0.1) and a greedy non-overlap filter;
    then K3 cuts every detected frame out of the stream and one batched
    aligned decode runs.  The host waits for the device at the gate and at
    the output fetch.  ``samples`` and ``device`` as for
    ``decode_regular``.

    Returns [(position, payload, ok), ...] sorted by position.
    """
    s = _complex_stream(samples, device)
    _check_fec(fec)
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    n_out = data_len if data_len is not None else payload_len
    t = s.shape[-1]
    if t < flen:
        return []
    # stride <= flen guarantees at most one frame start per window range
    # (frame starts are >= flen apart), so no detection is ever shadowed
    stride = min(acquisition, flen)
    n_win = max(1, -(-(t - flen + 1) // stride))

    offs, pars = _scan_windows(s, n_win=n_win, stride=stride, cfg=cfg)
    gate = torch.stack([offs.double(), pars.double()]).cpu().numpy()
    detections = _gate_detections(gate[0].astype(np.int64), gate[1], t=t,
                                  stride=stride, flen=flen,
                                  detection_rho=detection_rho,
                                  max_frames=max_frames, cfg=cfg)
    if not detections:
        return []
    pos = torch.tensor(detections, dtype=torch.int32).to(s.device)
    out = _decode_at_positions(s, pos, nb=nb, flen=flen,
                               guard_bands=guard_bands, modulation=modulation,
                               cfg=cfg)
    raw = out[:, HEADER_LEN:HEADER_LEN + payload_len].cpu().numpy()
    payloads, oks = _defec_rows(raw, fec, n_out)
    return [(p, payloads[i], bool(oks[i]))
            for i, p in enumerate(detections)]


def _chunk(s: torch.Tensor, p: int, n: int) -> torch.Tensor:
    """s[p : p + n], zero-padded where the stream ends first."""
    c = s[p:p + n]
    return _pad_last(c, n - c.shape[-1])


def _scan_at(s: torch.Tensor, p: int, *, acquisition: int,
             cfg: FrameConfig):
    """(offset, rho) of the locking block in the window at ``p``."""
    return locking_sync_quality(_chunk(s, p, acquisition + cfg.sym_len),
                                locking_template(cfg).astype(np.complex64))


def _dec_at(s: torch.Tensor, p: int, *, window: int, nb: int,
            guard_bands: bool, modulation: Modulation, acquisition: int,
            cfg: FrameConfig) -> torch.Tensor:
    """Decode the frame in the window at ``p`` (K1 within the acquisition,
    then K2)."""
    return decode_frame(_chunk(s, p, window), n_blocks=nb,
                        guard_bands=guard_bands, modulation=modulation,
                        cfg=cfg, search_window=acquisition)


def decode_continuous(samples, *, payload_len: int, guard_bands: bool = True,
                      modulation: Modulation = Modulation.QPSK,
                      fec: str | None = None, data_len: int | None = None,
                      acquisition: int = 4096, max_frames: int | None = None,
                      detection_rho: float = 0.3,
                      cfg: FrameConfig = DEFAULT_CONFIG,
                      device=None) -> Iterator[tuple]:
    """Scan a complex stream for frames of a known size; yield (position,
    payload, ok).

    Host-driven: after each decoded frame the scan resumes past it.  Frames
    may sit at arbitrary gaps; each acquisition looks at a fixed-size
    window.  Decode failures advance the window rather than aborting (the
    reference's skip-and-continue policy, examples/jetson_rx.rs:87-90).
    ``detection_rho`` is the normalized-matched-filter gate of
    ``decode_burst``.  The host waits for the device once per window (the
    gate) and once per decoded frame (its bytes).  ``samples`` and
    ``device`` as for ``decode_regular``.
    """
    s = _complex_stream(samples, device)
    _check_fec(fec)
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    window = flen + acquisition
    n_out = data_len if data_len is not None else payload_len

    pos = 0
    found = 0
    t = s.shape[-1]

    while pos + flen <= t and (max_frames is None or found < max_frames):
        off, rho = _scan_at(s, min(pos, t), acquisition=acquisition, cfg=cfg)
        off, rho = torch.stack([off.double(), rho.double()]).tolist()
        off = int(off)
        # detection gate: noise-only windows score rho ~ ln(W)/K << 0.3; a
        # real locking block scores ~snr/(1+snr) (Cauchy-Schwarz-bounded)
        if off < 0 or off >= acquisition or rho < detection_rho:
            pos += acquisition  # nothing here; slide the window
            continue
        out = _dec_at(s, min(pos, t), window=window, nb=nb,
                      guard_bands=guard_bands, modulation=modulation,
                      acquisition=acquisition, cfg=cfg)
        payload = out[HEADER_LEN:HEADER_LEN + payload_len].cpu().numpy()
        p, ok = _defec(payload, fec, n_out)
        yield pos + off, p, ok
        found += 1
        pos += off + flen
