"""The port's copies of the numpy-only modules against ofdm_tpu's: the frame
configuration, the seeded constant tables, the Toeplitz and DFT matrices and
the header codec must be bitwise equal."""

import dataclasses

import numpy as np
import pytest
import torch

import ofdm_tpu as ot
from ofdm_tpu import constants as jconst
from ofdm_tpu.core import rustrng as jrng
from ofdm_tpu.ops import fft as jfft
from ofdm_tpu.ops import xcorr as jxcorr
from ofdm_tpu.packets.header import Header as JHeader
from ofdm_tpu_torch import convert
from ofdm_tpu_torch.core import rustrng
from ofdm_tpu_torch.packets.header import Header

torch.set_num_threads(1)

CONFIGS = [ot.DEFAULT_CONFIG,
           ot.FrameConfig(locking_seed=7)]     # a complex locking template


def _jax_toeplitz(tpl: np.ndarray, real: bool) -> np.ndarray:
    tpl = tpl.astype(np.complex64)
    key = (tpl.tobytes(), len(tpl))
    jxcorr._TEMPLATE_STORE[key] = tpl
    if real:
        return jxcorr._toeplitz_template_real(key, len(tpl), "float32")
    return jxcorr._toeplitz_template(key, len(tpl), "float32")


@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "locking_seed"])
def test_tables_match_reference_bitwise(cfg):
    t = convert.tables(convert.frame_config_from_reference(cfg))
    lock = jconst.locking_for(cfg)
    np.testing.assert_array_equal(t["locking"], lock)
    np.testing.assert_array_equal(
        t["preamble"], jconst.preamble(cfg.sym_len, cfg.preamble_seed))
    np.testing.assert_array_equal(
        t["training"], jconst.training_signals(cfg.n_fft, cfg.training_seed))
    np.testing.assert_array_equal(t["channel_taps"], jconst.CHANNEL_TAPS)
    np.testing.assert_array_equal(t["toeplitz_real"], _jax_toeplitz(lock, True))
    np.testing.assert_array_equal(t["toeplitz_complex"],
                                  _jax_toeplitz(lock, False))
    np.testing.assert_array_equal(t["dft"], jfft._dft_matrix(cfg.n_fft, False))
    np.testing.assert_array_equal(t["idft"], jfft._dft_matrix(cfg.n_fft, True))
    sel = tuple(cfg.data_indices) + tuple(cfg.pilot_indices)
    wr, wi = jfft._dft_select_planes(cfg.n_fft, sel, "float32")
    np.testing.assert_array_equal(t["dft_select_re_gb1"], wr)
    np.testing.assert_array_equal(t["dft_select_im_gb1"], wi)
    wr, wi = jfft._dft_select_planes(cfg.n_fft, tuple(range(cfg.n_fft)),
                                     "float32")
    np.testing.assert_array_equal(t["dft_select_re_gb0"], wr)
    np.testing.assert_array_equal(t["dft_select_im_gb0"], wi)


@pytest.mark.parametrize("cfg", CONFIGS + [ot.FrameConfig(n_fft=128, cp_len=32)],
                         ids=["default", "locking_seed", "n_fft128"])
def test_frame_config_round_trip(cfg):
    port = convert.frame_config_from_reference(cfg)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert (port.sym_len, port.sync_len, port.n_sync_chunks) == \
        (cfg.sym_len, cfg.sync_len, cfg.n_sync_chunks)
    for gb in (False, True):
        assert port.carriers_per_block(gb) == cfg.carriers_per_block(gb)
    for mask in ("guard_mask", "pilot_mask", "data_mask", "data_indices"):
        np.testing.assert_array_equal(getattr(port, mask), getattr(cfg, mask))


def test_modulation_round_trip():
    for m in ot.Modulation:
        assert convert.modulation_from_reference(m).value == m.value


@pytest.mark.parametrize("length", [0, 1, 300, 8192, 2 ** 64 + 5, 2 ** 128 - 1])
def test_header_bytes_equal(length):
    raw = Header(length).to_bytes()
    assert raw == JHeader(length).to_bytes() and len(raw) == 16
    assert Header.from_bytes(raw) == Header(length)
    with pytest.raises(ValueError):
        Header.from_bytes(raw[:15])


@pytest.mark.parametrize("seed", [0, 50, 100, 12345])
def test_rustrng_sequence_equal(seed):
    np.testing.assert_array_equal(rustrng.complex_uniform_sequence(seed, 33),
                                  jrng.complex_uniform_sequence(seed, 33))
