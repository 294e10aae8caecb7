"""Distributed transceiver pipelines over a ("data", "time") mesh (port of
ofdm_tpu/parallel/pipeline.py).

Each rank is one process with one device and runs these functions on its
own block (``parallel/mesh.py``):

- ``sharded_sync_offset``: sequence-parallel frame sync.  The time axis is
  sharded; each shard runs K1's correlation pass (``sync_keys``) after a
  ring halo of 79 samples, and one all_reduce(MAX) of packed keys gives the
  reference's offset (src/receiver.rs:20-25), first occurrence on ties.
- ``decode_frame_sharded`` / ``decode_frame_planar_sharded``: rows over the
  data axis, each rank decoding its rows with the single-device kernels and
  no communication.
- ``decode_regular_sharded`` / ``decode_burst_sharded``: stream decoding
  with the frames over the data axis; only the decoded bytes (and the burst
  scan's detection rows) are gathered.
- ``make_pipeline_step``: tx -> time-sharded channel -> time-sharded decode
  -> bit errors, summed over the mesh by one all_reduce.

The functions take the global array, as the JAX ones do, and work on this
rank's block of it; the data-sharded decoders return this rank's rows, the
stream decoders every frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, FrameConfig
from ..fec import hamming
from ..kernels.align import key_lag, planar_align
from ..obs.analysis import bit_errors
from ..packets.header import HEADER_LEN, Header
from ..phy import rx as rx_mod
from ..phy import streaming as st
from ..phy.modulation import Modulation, _pad_last
from ..phy.tx import encode_payload, n_data_blocks
from .halo import all_gather, all_reduce, global_key_max
from .mesh import (DATA_AXIS, TIME_AXIS, axis_index, axis_size, data_sharding,
                   mesh_device, shard, time_sharding)
from .timeshard import (_haloed, channel_timesharded_fn, shard_sync_keys,
                        timesharded_decode_fn)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def sharded_sync_offset(samples, mesh,
                        cfg: FrameConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """The global complex [B, T] (T dividing over the time ranks) -> int32
    offsets (argmax - 1) of this rank's rows [B_loc].  Covers lags >= 0;
    a lag-0 peak gives -1, as the reference's arithmetic does."""
    local = shard(_tensor(samples), time_sharding(mesh))
    local = local.to(torch.complex64).contiguous()
    t_loc = local.shape[-1]
    ext = _haloed(local, mesh, cfg.sym_len - 1)
    keys = shard_sync_keys(ext, rx_mod.locking_template(cfg), t_loc,
                           axis_index(mesh, TIME_AXIS) * t_loc)
    return (key_lag(global_key_max(keys, mesh)) - 1).to(torch.int32)


def decode_frame_sharded(samples, mesh, *, n_blocks: int,
                         guard_bands: bool = False,
                         modulation: Modulation = Modulation.BPSK,
                         cfg: FrameConfig = DEFAULT_CONFIG,
                         align_impl: str = "auto") -> torch.Tensor:
    """Data-parallel batched decode: the global complex [B, T] -> uint8
    [B_loc, n_bytes], this rank's rows (``phy.rx.decode_frame`` on them: K1
    + K2, or K4 + K2 with ``align_impl="chunked"``)."""
    rows = shard(_tensor(samples), data_sharding(mesh))
    return rx_mod.decode_frame(rows, n_blocks=n_blocks,
                               guard_bands=guard_bands, modulation=modulation,
                               cfg=cfg, align_impl=align_impl)


def decode_frame_planar_sharded(planes, mesh, *, n_blocks: int,
                                guard_bands: bool = False,
                                modulation: Modulation = Modulation.BPSK,
                                cfg: FrameConfig = DEFAULT_CONFIG,
                                align_impl: str = "auto") -> torch.Tensor:
    """Data-parallel PLANAR batched decode: the global f32 [B, 2, T] (any
    strides) -> uint8 [B_loc, n_bytes], this rank's rows through
    ``phy.rx.decode_frame_planar``: K1 + K2, K4 + K2 with
    ``align_impl="chunked"``, and K5 first where this rank's rows are a
    strided view.  (JAX's ``interpret=`` is a Pallas knob and is not
    ported.)"""
    rows = shard(_tensor(planes), data_sharding(mesh))
    return rx_mod.decode_frame_planar(rows, n_blocks=n_blocks,
                                      guard_bands=guard_bands,
                                      modulation=modulation, cfg=cfg,
                                      align_impl=align_impl)


def _share(n: int, mesh) -> tuple[int, int]:
    """(items per data rank, this rank's first item) of n items padded to a
    multiple of the data axis."""
    per = -(-n // axis_size(mesh, DATA_AXIS))
    return per, axis_index(mesh, DATA_AXIS) * per


def decode_regular_sharded(samples, mesh, *, n_frames: int, spacing: int,
                           payload_len: int, guard_bands: bool = True,
                           modulation: Modulation = Modulation.QPSK,
                           fec: str | None = None, data_len: int | None = None,
                           cfg: FrameConfig = DEFAULT_CONFIG):
    """``phy.streaming.decode_regular`` (resync) with the frames over the
    data axis.  Every rank holds the stream (complex [T] or planar [2, T]).

    One global sync finds the first frame and stays on the device; K3 cuts
    this rank's rows out of the stream (the rows padded to a multiple of the
    data axis); ``decode_frame_planar`` with a one-symbol search window runs
    K1 + K2 on them; Hamming runs on the device while the rows are still
    sharded.  Then ONE all_gather over ``data`` of the user bytes, and the
    one wait of the call, the fetch.  Returns, on every rank, numpy
    (payloads [n_frames, data_len or payload_len], ok flags [n_frames])."""
    dev = mesh_device(mesh)
    stream, planar = st._stream(samples, dev)
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    if spacing < flen:
        raise ValueError(f"spacing {spacing} < frame length {flen}")
    st._check_fec(fec)
    n_bytes = data_len if data_len is not None else payload_len
    per, first_row = _share(n_frames, mesh)

    sync = st._first_sync_planar if planar else st._first_sync
    first = sync(stream, spacing=spacing, cfg=cfg).clamp(min=0)
    offsets = first + (torch.arange(per, device=dev) + first_row) * spacing
    rows = planar_align(stream, offsets, flen, planar=True)
    out = rx_mod.decode_frame_planar(rows, n_blocks=nb,
                                     guard_bands=guard_bands,
                                     modulation=modulation, cfg=cfg,
                                     search_window=cfg.sym_len)
    payload = out[:, HEADER_LEN:HEADER_LEN + payload_len]
    if fec == "hamming":
        dec = all_gather(hamming.decode(payload, n_bytes), mesh, DATA_AXIS)
        return dec[:n_frames].cpu().numpy(), np.ones(n_frames, bool)
    raw = all_gather(payload.contiguous(), mesh, DATA_AXIS)[:n_frames]
    return st._defec_rows(raw.cpu().numpy(), fec, n_bytes)


def decode_burst_sharded(samples, mesh, *, payload_len: int,
                         guard_bands: bool = True,
                         modulation: Modulation = Modulation.QPSK,
                         fec: str | None = None, data_len: int | None = None,
                         acquisition: int = 4096,
                         max_frames: int | None = None,
                         detection_rho: float = 0.3,
                         cfg: FrameConfig = DEFAULT_CONFIG) -> list[tuple]:
    """``phy.streaming.decode_burst`` with both batched steps over the data
    axis: each rank scans its share of the acquisition windows, one
    all_gather collects the (lag, rho) rows, the host gate runs alike on
    every rank, each rank decodes its share of the detected frames (K3 +
    K2) and one all_gather collects their bytes.

    Returns [(position, payload, ok), ...] sorted by position, on every
    rank: the single-device path's detections and bytes."""
    dev = mesh_device(mesh)
    s = st._complex_stream(samples, dev)
    st._check_fec(fec)
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    n_out = data_len if data_len is not None else payload_len
    t = s.shape[-1]
    if t < flen:
        return []
    stride = min(acquisition, flen)
    n_win = max(1, -(-(t - flen + 1) // stride))
    per, first_win = _share(n_win, mesh)
    offs, pars = st._scan_windows(s, n_win=per, stride=stride, cfg=cfg,
                                  first_window=first_win)
    # the padded windows are dropped: the gate sees the single-device scan
    gate = all_gather(torch.stack([offs.double(), pars.double()], dim=1),
                      mesh, DATA_AXIS)[:n_win].cpu().numpy()
    detections = st._gate_detections(
        gate[:, 0].astype(np.int64), gate[:, 1], t=t, stride=stride,
        flen=flen, detection_rho=detection_rho, max_frames=max_frames,
        cfg=cfg)
    if not detections:
        return []
    per, first_det = _share(len(detections), mesh)
    padded = detections + [detections[-1]] * (
        per * axis_size(mesh, DATA_AXIS) - len(detections))
    pos = torch.tensor(padded[first_det:first_det + per],
                       dtype=torch.int32).to(dev)
    out = st._decode_at_positions(s, pos, nb=nb, flen=flen,
                                  guard_bands=guard_bands,
                                  modulation=modulation, cfg=cfg)
    raw = all_gather(out[:, HEADER_LEN:HEADER_LEN + payload_len].contiguous(),
                     mesh, DATA_AXIS)[:len(detections)].cpu().numpy()
    payloads, oks = st._defec_rows(raw, fec, n_out)
    return [(p, payloads[i], bool(oks[i])) for i, p in enumerate(detections)]


def make_pipeline_step(mesh, *, payload_len: int, guard_bands: bool = True,
                       modulation: Modulation = Modulation.QAM64,
                       snr: float = 45.0, timing_error: bool = True,
                       cfg: FrameConfig = DEFAULT_CONFIG):
    """Build the full-pipeline step over the mesh.

    Returns step(data_local, generator) -> (decoded_local, total_bit_errors):
    data_local, this rank's rows of payloads uint8 [B_loc, payload_len]
    (every rank of a time line holds the same rows); generator, a CPU
    ``torch.Generator`` seeded alike on every rank, from which the step
    draws the channel's seed.  The step encodes (``encode_payload``, the
    header prepended), pads the time axis to a multiple of time ranks x
    sym_len with at least a frame and a symbol of zeros (room for the
    convolution's smear and the offset clamp), runs the time-sharded channel
    and decode on this rank's time shard, counts bit errors, and sums them
    over the whole mesh with one all_reduce (each row counted once, by the
    rank at time index 0).  decoded_local is uint8 [B_loc, n_bytes];
    total_bit_errors an int32 [1] tensor on the mesh's device."""
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    frame = (cfg.n_sync_chunks + nb) * cfg.sym_len
    n_time = axis_size(mesh, TIME_AXIS)
    my_t = axis_index(mesh, TIME_AXIS)
    dev = mesh_device(mesh)
    header = torch.as_tensor(np.frombuffer(Header(payload_len).to_bytes(),
                                           np.uint8).copy(), device=dev)
    decode_ts = timesharded_decode_fn(mesh, n_blocks=nb,
                                      guard_bands=guard_bands,
                                      modulation=modulation, cfg=cfg)
    channel_ts = channel_timesharded_fn(mesh, snr=snr,
                                        timing_error=timing_error, cfg=cfg)
    h0 = cfg.header_len_bytes

    def step(data_local: torch.Tensor, generator: torch.Generator):
        data = data_local.to(dev)
        payload = torch.cat([header.expand(data.shape[0], -1), data], dim=-1)
        tx = encode_payload(payload, guard_bands=guard_bands,
                            modulation=modulation, cfg=cfg)
        need = frame + cfg.sym_len
        tx = _pad_last(tx, -(tx.shape[-1] + need) % (n_time * cfg.sym_len)
                       + need)
        t_loc = tx.shape[-1] // n_time
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        rx = channel_ts(tx[:, my_t * t_loc:(my_t + 1) * t_loc], seed)
        decoded = decode_ts(rx)
        errs = bit_errors(decoded[:, h0:h0 + payload_len], data).sum()
        mine = errs if my_t == 0 else torch.zeros_like(errs)
        return decoded, all_reduce(mine.reshape(1), mesh, axis=None)

    return step
