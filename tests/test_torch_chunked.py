"""The chunked route: ``sync_align_chunked`` (kernel 4) and the slot-ordered
tail ``decode_chunked_matrix``, against ofdm_tpu (mirrors
tests/test_chunked_kernel.py).

The kernel's plain version is held bitwise against the Pallas kernel in
interpret mode on every lane of every slot: lanes 0:sym_len of a real
chunk's slot, and what both write elsewhere, the stream after the chunk or
zeros past the row's end (kernels/chain.py).  End to end the bytes equal
ot.decode_frame's on the same received samples.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
import ofdm_tpu_torch as ott
from ofdm_tpu import constants as jconstants
from ofdm_tpu.config import DEFAULT_CONFIG as JCFG
from ofdm_tpu.config import FrameConfig
from ofdm_tpu.kernels.chain_pallas import sync_align_chunked as jax_chunked
from ofdm_tpu.phy.rx import decode_chunked_matrix as jax_chunked_tail
from ofdm_tpu_torch import convert
from ofdm_tpu_torch.kernels.chain import (class_geometry, sync_align_chunked,
                                          sync_align_chunked_reference)

torch.set_num_threads(1)

OFFSETS = [0, 1, 79, 80, 127, 128, 129, 255]
# sym 96: gcd(96, 128) = 32 gives 4 lane-phase classes (test_chunked_kernel.py)
SYM96 = FrameConfig(n_fft=80, cp_len=16, locking_seed=7,
                    pilot_indices=(3, 20, 50, 70))
GEOMETRIES = {"sym80": JCFG, "sym96": SYM96}


def _cfgs(name):
    cfg = GEOMETRIES[name]
    return cfg, convert.frame_config_from_reference(cfg)


@lru_cache(maxsize=None)
def _offset_case(name: str):
    """One frame (QPSK, 90 B, no guard bands) at each offset of OFFSETS in
    light noise; T = need + 400, not a multiple of 128.  Returns (cfg, rows,
    n_chunks, template, the Pallas kernel's planes in interpret mode)."""
    cfg, _ = _cfgs(name)
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, 90, dtype=np.uint8)
    tx = np.asarray(ot.encode(payload, guard_bands=False,
                              modulation=ot.Modulation.QPSK, cfg=cfg,
                              dtype=jnp.complex64))
    nb = ot.n_data_blocks(90, ot.Modulation.QPSK, False, cfg)
    n_chunks = cfg.n_sync_chunks + nb
    t = n_chunks * cfg.sym_len + 400
    assert t % 128
    s = 0.003 * (rng.standard_normal((len(OFFSETS), t))
                 + 1j * rng.standard_normal((len(OFFSETS), t)))
    for i, off in enumerate(OFFSETS):
        s[i, off:off + tx.shape[-1]] += tx
    s = s.astype(np.complex64)
    tpl = np.asarray(jconstants.locking_for(cfg)).astype(np.complex64)
    (wr, wi), slots, m_per = jax_chunked(jnp.asarray(s), tpl, n_chunks=n_chunks,
                                         cfg=cfg, interpret=True)
    return cfg, s, n_chunks, tpl, (np.asarray(wr), np.asarray(wi), slots, m_per)


@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("planar_in", [False, True])
def test_chunked_reference_matches_pallas(name, planar_in):
    cfg, s, n_chunks, tpl, (wr, wi, slots, m_per) = _offset_case(name)
    x = torch.as_tensor(s)
    if planar_in:
        x = torch.stack([x.real, x.imag], dim=1).contiguous()
    (gr, gi), g_slots, g_m_per = sync_align_chunked_reference(
        x, tpl, n_chunks=n_chunks, cfg=_cfgs(name)[1])
    assert (g_slots, g_m_per) == (slots, m_per)
    assert class_geometry(cfg.sym_len, n_chunks) == (slots // m_per, m_per)
    np.testing.assert_array_equal(gr.numpy(), wr)
    np.testing.assert_array_equal(gi.numpy(), wi)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_chunked_slot_contents(name):
    """Every lane of every slot: stream[off + sym * chunk(slot) + lane], 0
    past T (off = the frame start - 1, the reference's argmax - 1)."""
    cfg, s, n_chunks, tpl, _ = _offset_case(name)
    (gr, gi), slots, m_per = sync_align_chunked(
        torch.as_tensor(s), tpl, n_chunks=n_chunks, cfg=_cfgs(name)[1])
    n_cls = slots // m_per
    chunk = (np.arange(slots) % m_per) * n_cls + np.arange(slots) // m_per
    t = s.shape[1]
    for row, off in enumerate(OFFSETS):
        start = max(off - 1, 0)          # the frame at `off` peaks at lag off
        idx = start + cfg.sym_len * chunk[:, None] + np.arange(128)
        padded = np.concatenate([s[row], np.zeros(idx.max() + 1 - t, s.dtype)])
        np.testing.assert_array_equal(gr[row].numpy(), padded[idx].real)
        np.testing.assert_array_equal(gi[row].numpy(), padded[idx].imag)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_chunked_tail_matches_jax(name):
    """decode_chunked_matrix on the Pallas kernel's own planes."""
    cfg, _, n_chunks, _, (wr, wi, _, m_per) = _offset_case(name)
    kw = dict(n_chunks=n_chunks, m_per=m_per, guard_bands=False)
    want = np.asarray(jax_chunked_tail((jnp.asarray(wr), jnp.asarray(wi)),
                                       modulation=ot.Modulation.QPSK, cfg=cfg,
                                       **kw))
    got = ott.decode_chunked_matrix((torch.tensor(wr), torch.tensor(wi)),
                                    modulation=ott.Modulation.QPSK,
                                    cfg=_cfgs(name)[1], **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 16:106],
                                  np.tile(got[0, 16:106], (len(OFFSETS), 1)))


def _frame_batch(n_rows, payload, mod, gb, snr, key, seed):
    data = np.random.default_rng(seed).integers(0, 256, (n_rows, payload),
                                                dtype=np.uint8)
    tx = ot.encode(data, guard_bands=gb, modulation=mod, dtype=jnp.complex64)
    rx = np.asarray(ot.channel(tx, snr=snr, timing_error=True,
                               key=jax.random.key(key))).astype(np.complex64)
    nb = ot.n_data_blocks(payload, mod, gb)
    need = (JCFG.n_sync_chunks + nb) * JCFG.sym_len
    rx = np.pad(rx, ((0, 0), (0, max(0, need + 40 - rx.shape[-1]))))
    return data, rx, nb


@pytest.mark.parametrize("mod,snr", [
    (ot.Modulation.BPSK, 30.0), (ot.Modulation.QPSK, 30.0),
    (ot.Modulation.QAM16, 35.0), (ot.Modulation.QAM64, 45.0),
    (ot.Modulation.QAM256, 55.0)], ids=lambda v: getattr(v, "value", str(v)))
def test_chunked_decode_frame_matches_jax(mod, snr):
    data, rx, nb = _frame_batch(4, 240, mod, True, snr, key=3, seed=5)
    pmod = convert.modulation_from_reference(mod)
    want = np.asarray(ot.decode_frame(jnp.asarray(rx), n_blocks=nb,
                                      guard_bands=True, modulation=mod))
    got = ott.decode_frame(torch.as_tensor(rx), n_blocks=nb, guard_bands=True,
                           modulation=pmod, align_impl="chunked").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 16:256], data)


def test_chunked_no_guard_bands_matches_jax():
    data, rx, nb = _frame_batch(3, 200, ot.Modulation.QPSK, False, 30.0,
                                key=4, seed=6)
    want = np.asarray(ot.decode_frame(jnp.asarray(rx), n_blocks=nb,
                                      modulation=ot.Modulation.QPSK))
    got = ott.decode_frame(torch.as_tensor(rx), n_blocks=nb,
                           modulation=ott.Modulation.QPSK,
                           align_impl="chunked").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 16:216], data)


def test_chunked_planar_input_matches_complex():
    data, rx, nb = _frame_batch(3, 120, ot.Modulation.QAM16, True, 35.0,
                                key=5, seed=7)
    x = torch.as_tensor(rx)
    kw = dict(n_blocks=nb, guard_bands=True, modulation=ott.Modulation.QAM16,
              align_impl="chunked")
    got = ott.decode_frame(x, **kw)
    planes = torch.stack([x.real, x.imag], dim=1)
    np.testing.assert_array_equal(ott.decode_frame_planar(planes, **kw).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(got.numpy()[:, 16:136], data)
    n_chunks = JCFG.n_sync_chunks + nb
    tpl = np.asarray(jconstants.locking_for(JCFG)).astype(np.complex64)
    (ar, ai), _, _ = sync_align_chunked(x, tpl, n_chunks=n_chunks)
    (br, bi), _, _ = sync_align_chunked(planes.contiguous(), tpl,
                                        n_chunks=n_chunks)
    assert torch.equal(ar, br) and torch.equal(ai, bi)


def test_chunked_rejects_long_symbols_and_templates():
    cfg = ott.FrameConfig(n_fft=128, cp_len=32, locking_seed=7)  # sym 160
    x = torch.zeros((1, 20000), dtype=torch.complex64)
    with pytest.raises(ValueError, match="sym_len"):
        sync_align_chunked(x, np.ones(80, np.complex64), n_chunks=20, cfg=cfg)
    with pytest.raises(NotImplementedError):
        sync_align_chunked(x, np.ones(129, np.complex64), n_chunks=20)
