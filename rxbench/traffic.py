"""The one traffic generator: every cell's inputs, made on the device from
``--seed`` and the parameters of its configuration and traffic files.

- Frame rows (``rows``): each of ``inputs`` batches holds ``rows`` frames of
  random payload bytes, one a row, through the channel, zero-padded to the
  configuration's ``row_samples``.
- Streams (``frames``): each of ``inputs`` streams holds ``frames`` frames of
  random user bytes, Hamming-coded where the configuration says so, back
  to back, through the channel as one signal (each frame with its own noise
  level), zero-padded by one symbol.

Every row or frame draws its SNR uniformly from ``snr_db`` = [low, high]
(the channel's nominal dB); input i has the channel's timing error where
``timing_error[i]`` is true.  Input i of seed s comes from generators
seeded with (s, i): the same seed gives the same inputs on the same kind of
device, and every seed the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from .wire import channel, frame, tx


def generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key``."""
    words = [int(k) % (1 << 63) for k in key]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


def _snr(g: torch.Generator, n: int, snr_db, device) -> torch.Tensor:
    lo, hi = snr_db
    return lo + (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64,
                                       device=device)


def payload_len(cfg: dict) -> int:
    """Bytes a frame carries after its header (the code stream under FEC)."""
    if cfg.get("fec") == "hamming":
        return -(-cfg["user_bytes"] * 14 // 8)
    return cfg["payload_bytes"]


def frame_len(cfg: dict) -> int:
    return frame.SYNC_LEN + frame.SYM_LEN * frame.n_data_blocks(
        payload_len(cfg), cfg["modulation"], cfg["guard_bands"])


def _frames(cfg: dict, n: int, g: torch.Generator, device) -> torch.Tensor:
    user = cfg["user_bytes"] if cfg.get("fec") else cfg["payload_bytes"]
    data = torch.randint(0, 256, (n, user), generator=g, dtype=torch.uint8,
                         device=device)
    if cfg.get("fec") == "hamming":
        data = tx.hamming_encode(data)
    return tx.encode(data, cfg["modulation"], cfg["guard_bands"])


def frame_rows(cfg: dict, traffic: dict, seed: int, i: int,
               device: torch.device) -> torch.Tensor:
    """Input i: complex64 [rows, row_samples]."""
    g = generator(device, seed, i)
    rows = traffic["rows"]
    sent = _frames(cfg, rows, g, device)
    te = torch.full((rows,), bool(traffic["timing_error"][i]), device=device)
    rx = channel.channel(sent, _snr(g, rows, traffic["snr_db"], device),
                         timing_error=te, generator=g)
    return torch.nn.functional.pad(rx, (0, cfg["row_samples"] - rx.shape[-1]))


def stream(cfg: dict, traffic: dict, seed: int, i: int,
           device: torch.device) -> torch.Tensor:
    """Input i: complex64 [frames * frame_len + SYM_LEN]."""
    g = generator(device, seed, i)
    n = traffic["frames"]
    sent = _frames(cfg, n, g, device).reshape(1, -1)
    te = torch.full((1,), bool(traffic["timing_error"][i]), device=device)
    rx = channel.channel(sent, _snr(g, n, traffic["snr_db"], device)[None],
                         timing_error=te, generator=g,
                         segment=frame_len(cfg))[0]
    need = n * frame_len(cfg) + frame.SYM_LEN
    return torch.nn.functional.pad(rx, (0, need - rx.shape[0]))
