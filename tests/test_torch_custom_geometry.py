"""The four FrameConfig geometries of tests/test_custom_geometry.py through
the port's ``decode`` and ``decode_frame``, byte for byte against the data
and against ofdm_tpu on the same received samples (made by the JAX
package's encoder and channel, as complex64).

Two of them have locking templates longer than 128 taps (160 and 320):
those take the unfused route, the conv correlation and then the
``planar_align`` copy, where the fused ``sync_align`` cannot go.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
import ofdm_tpu_torch as ott
from ofdm_tpu import constants as jconstants
from ofdm_tpu.config import FrameConfig
from ofdm_tpu_torch import constants, convert

torch.set_num_threads(1)

DATA = bytes(range(200))
GEOMETRIES = [
    (dict(n_fft=32, cp_len=8, locking_seed=7), True),
    (dict(n_fft=128, cp_len=32, n_training=3, n_preamble=2, locking_seed=7), False),
    (dict(n_fft=256, cp_len=64, locking_seed=7), False),
    (dict(n_fft=64, cp_len=16, locking_seed=7), True),   # PRN lock, default dims
]
IDS = ["fft32-cfo", "fft128-taps160", "fft256-taps320", "fft64-cfo"]


@lru_cache(maxsize=None)
def _case(i: int):
    """(JAX cfg, port cfg, rx complex64 [T]) for geometry i: QPSK, SNR 30,
    the channel's CFO where tests/test_custom_geometry.py injects it."""
    kwargs, cfo = GEOMETRIES[i]
    cfg = FrameConfig(**kwargs)
    tx = ot.encode(DATA, modulation=ot.Modulation.QPSK, cfg=cfg,
                   dtype=jnp.complex64)
    rx = ot.channel(tx, snr=30.0, timing_error=cfo, key=jax.random.key(1))
    return cfg, convert.frame_config_from_reference(cfg), \
        np.asarray(rx).astype(np.complex64)


@pytest.mark.parametrize("i", range(len(GEOMETRIES)), ids=IDS)
def test_geometry_round_trips(i):
    """convert.py carries a custom FrameConfig across whole: its fields, the
    derived geometry and the locking template."""
    cfg, pcfg, _ = _case(i)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    for name in ("sym_len", "sync_len", "n_sync_chunks"):
        assert getattr(pcfg, name) == getattr(cfg, name), name
    np.testing.assert_array_equal(constants.locking_for(pcfg),
                                  jconstants.locking_for(cfg))


@pytest.mark.parametrize("i", range(len(GEOMETRIES)), ids=IDS)
def test_decode_custom_geometry(i):
    cfg, pcfg, rx = _case(i)
    want = np.asarray(ot.decode(jnp.asarray(rx), modulation=ot.Modulation.QPSK,
                                cfg=cfg))
    got = ott.decode(torch.as_tensor(rx), modulation=ott.Modulation.QPSK,
                     cfg=pcfg)
    assert bytes(got.tobytes()) == DATA
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(len(GEOMETRIES)), ids=IDS)
def test_decode_frame_custom_geometry(i):
    cfg, pcfg, rx = _case(i)
    nb = ot.n_data_blocks(len(DATA), ot.Modulation.QPSK, False, cfg)
    rows = np.stack([rx, np.roll(rx, 3)])     # a second row, 3 samples later
    want = np.asarray(ot.decode_frame(jnp.asarray(rows), n_blocks=nb, cfg=cfg,
                                      modulation=ot.Modulation.QPSK))
    got = ott.decode_frame(torch.as_tensor(rows), n_blocks=nb, cfg=pcfg,
                           modulation=ott.Modulation.QPSK).numpy()
    assert bytes(got[0, 16:216].tobytes()) == DATA
    assert bytes(got[1, 16:216].tobytes()) == DATA
    np.testing.assert_array_equal(got, want)
