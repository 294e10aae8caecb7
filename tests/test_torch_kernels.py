"""The kernels of the port: their plain versions against the JAX Pallas
kernels (interpret mode), their wrappers' checks, and, on a CUDA device
only, the kernels against their plain versions.  (planar_align,
pin_rowmajor and sync_align_chunked meet the Pallas kernels in
test_torch_decode_options.py and test_torch_chunked.py.)

sync_align moves samples, so windows compare bitwise once the offsets agree;
the peaks here are well separated, as reduction order may resolve a
near-exact tie differently (ofdm_tpu_torch/PARITY.md).  eq_demod_pack compares bytes at
operating SNR, where the equalizer's y/h vs y*(1/h) and the TPU kernel's
polynomial atan2 sit orders of magnitude below the decision margin.

JAX is imported only by the tests that compare with it, so the GPU tests
here also run on a host without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import ofdm_tpu_torch as ott
from ofdm_tpu_torch import DEFAULT_CONFIG, Modulation, constants
from ofdm_tpu_torch.io.iqfile import read_iq
from ofdm_tpu_torch.kernels import align
from ofdm_tpu_torch.kernels.align import (key_lag, key_power, one_pass_cluster,
                                          one_pass_shared_bytes, pack_keys,
                                          pin_rowmajor, pin_rowmajor_reference,
                                          planar_align, planar_align_reference,
                                          sync_align, sync_align_one_pass,
                                          sync_align_reference, sync_keys,
                                          sync_keys_reference)
from ofdm_tpu_torch.kernels.chain import (sync_align_chunked,
                                          sync_align_chunked_reference)
from ofdm_tpu_torch.kernels.demod import eq_demod_pack, eq_demod_pack_reference
from ofdm_tpu_torch.kernels import counters
from ofdm_tpu_torch.kernels.derot import (derot_dft,
                                          dft_matmul_select_derot_planar,
                                          kernel_bins, kernel_twiddle)
from ofdm_tpu_torch.ops.fft import (dft_matmul_select_derot_planar_reference,
                                    set_full_fp32)
from ofdm_tpu_torch.phy.modulation import BITS_PER_SYMBOL, modulate_bytes_packed

torch.set_num_threads(1)

DELAYS = [0, 1, 63, 127, 128, 129, 150, 200]
T, NEED = 2560, 2400
# the port's locking template, bitwise equal to ofdm_tpu's (test_torch_constants)
TPL = constants.locking_for(DEFAULT_CONFIG).astype(np.complex64)
TPL_C = (TPL * np.exp(0.7j)).astype(np.complex64)


# planar_align's shared-stream mode: one stream, rows past its end
T_S, NEED_S = 3000, 700
OFFS_S = [0, 1, 999, 2300, 2301, 2999, 3000, 4500]     # the last four run past T


def shared_stream_case() -> np.ndarray:
    rng = np.random.default_rng(12)
    return (rng.standard_normal(T_S) + 1j * rng.standard_normal(T_S)).astype(
        np.complex64)


def stream_forms(s: torch.Tensor) -> dict:
    """A complex64 [T] stream as each stream form planar_align takes."""
    return {"complex": s, "planar": torch.stack([s.real, s.imag]),
            "planar strided": torch.view_as_real(s).t()}


def _pallas():
    """The JAX Pallas kernels (imported here: see the module docstring)."""
    from ofdm_tpu.kernels import align_pallas, demod_pallas
    return align_pallas, demod_pallas


def _stream(tpl, seed=5, decoy_at=None):
    rng = np.random.default_rng(seed)
    s = 0.01 * (rng.standard_normal((len(DELAYS), T))
                + 1j * rng.standard_normal((len(DELAYS), T)))
    for i, d in enumerate(DELAYS):
        s[i, d:d + len(tpl)] += tpl
    if decoy_at is not None:
        s[:, decoy_at:decoy_at + len(tpl)] += 2.0 * tpl
    return s.astype(np.complex64)


def _as_input(s: np.ndarray, planar_in: bool) -> torch.Tensor:
    x = torch.as_tensor(s)
    return torch.stack([x.real, x.imag], dim=1).contiguous() if planar_in else x


@pytest.fixture(scope="module")
def pallas_windows():
    """JAX sync_align (interpret mode) outputs, keyed by (template, planar)."""
    out = {}
    for name, tpl in (("real", TPL), ("complex", TPL_C)):
        s = _stream(tpl)
        for planar in (False, True):
            out[name, planar] = np.asarray(_pallas()[0].sync_align(
                s, tpl, NEED, interpret=True, planar=planar))
    return out


@pytest.mark.parametrize("tpl_name", ["real", "complex"])
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("planar_in", [False, True])
def test_sync_align_reference_matches_pallas(pallas_windows, tpl_name, planar,
                                             planar_in):
    tpl = TPL if tpl_name == "real" else TPL_C
    x = _as_input(_stream(tpl), planar_in)
    got, raw = sync_align_reference(x, tpl, NEED, planar=planar)
    want = pallas_windows[tpl_name, planar]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(DELAYS) - 1)


def test_sync_align_reference_search_window_matches_pallas():
    s = _stream(TPL, seed=8, decoy_at=1500)   # a louder peak past the window
    want = np.asarray(_pallas()[0].sync_align(s, TPL, NEED, interpret=True,
                                              search_window=220))
    got, raw = sync_align_reference(torch.as_tensor(s), TPL, NEED,
                                    search_window=220)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(DELAYS) - 1)
    _, raw_all = sync_align_reference(torch.as_tensor(s), TPL, NEED)
    assert (raw_all.numpy() == 1499).all()


K1_EDGES = ["1 tap", "128 taps real", "128 taps complex", "lag_bound 2,051",
            "T=700", "ties real", "ties complex"]


def _tie_stream(tpl, t, lag_bound):
    """Integer rows whose peak power ties exactly between two lags, as every
    correlation sum is exact in any order: row 0 holds the template at the
    first and the last lag of the scan, row 1 is all zeros (every lag ties),
    row 2 holds it at lag 5 and the last lag, row 3 at the last lag with a
    louder copy past the scan.  Returns (rows, first peak lag per row)."""
    k, last = len(tpl), lag_bound - 1
    s = np.zeros((4, t), np.complex64)
    for row, lag, scale in ((0, 0, 1), (0, last, 1), (2, 5, 1), (2, last, 1),
                            (3, last, 1), (3, t - k, 2)):
        s[row, lag:lag + k] += scale * tpl
    return s, [0, 0, 5, last]


def _k1_edge(name):
    """(stream [R, T], template, need, search_window, first peak lag per
    row) at an edge of the kernel's correlation pass, which gives each
    thread 8 consecutive lags and each block 1,024."""
    rng = np.random.default_rng(21)
    t, need, win, delays, tpl = T, NEED, None, DELAYS, TPL
    if name == "1 tap":
        tpl, need = np.ones(1, np.complex64), 1000
        delays = [0, 1, 7, 8, 1023, 1024, 2048, 2559]
    elif name.startswith("128 taps"):
        tpl = rng.standard_normal(128) + (
            1j * rng.standard_normal(128) if name.endswith("complex") else 0)
        tpl = (tpl / np.abs(tpl).max()).astype(np.complex64)
    elif name == "lag_bound 2,051":       # 1,971 + 80: 3 lags into block 3
        t, need, win = 3000, 1000, 1971
        delays = [0, 7, 1023, 1024, 2047, 2048, 2049, 2050]
    elif name == "T=700":                 # shorter than one block
        t, need, delays = 700, 600, [0, 1, 99, 100, 620, 300, 50, 10]
    else:
        tpl = rng.choice([-2.0, -1.0, 1.0, 2.0], 80).astype(np.complex64)
        if name.endswith("complex"):
            tpl = (tpl + 1j * rng.choice([-1.0, 1.0], 80)).astype(np.complex64)
        s, first = _tie_stream(tpl, 3000, 1971 + 80)
        return s, tpl, 1000, 1971, first
    s = 0.01 * (rng.standard_normal((len(delays), t))
                + 1j * rng.standard_normal((len(delays), t)))
    for i, d in enumerate(delays):
        s[i, d:d + len(tpl)] += tpl
    return s.astype(np.complex64), tpl, need, win, delays


@pytest.mark.parametrize("name", K1_EDGES)
def test_sync_align_reference_edges_match_pallas(name):
    s, tpl, need, win, first = _k1_edge(name)
    want = np.asarray(_pallas()[0].sync_align(s, tpl, need, interpret=True,
                                              search_window=win))
    got, raw = sync_align_reference(torch.as_tensor(s), tpl, need,
                                    search_window=win)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(first) - 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sync_align_on_cpu_runs_the_plain_version():
    x = torch.as_tensor(_stream(TPL))
    before = sync_align.launches
    got, raw = sync_align(x, TPL, NEED, planar=True)
    ref, raw_ref = sync_align_reference(x, TPL, NEED, planar=True)
    assert torch.equal(got, ref) and torch.equal(raw, raw_ref)
    assert raw.dtype == torch.int32 and sync_align.launches == before


@pytest.mark.parametrize("bad, err", [
    (lambda x: (x, np.ones(129, np.complex64), NEED), NotImplementedError),
    (lambda x: (x.real.contiguous(), TPL, NEED), ValueError),
    (lambda x: (x[:, ::2], TPL, 1000), ValueError),
    (lambda x: (x, TPL, T + 1), ValueError),
])
def test_sync_align_rejects_bad_input(bad, err):
    with pytest.raises(err):
        sync_align(*bad(torch.as_tensor(_stream(TPL))))


def _tail_case(mod, guard_bands, seed=1, batch=3, nb=20):
    """DFT-output planes with a known answer: symbols through a random
    channel with a per-block pilot phase and noise at SNR 45 (55 for QAM256,
    whose corner points the unit-power pilots' phase noise would otherwise
    push to within half a decision margin)."""
    snr = 55.0 if mod is Modulation.QAM256 else 45.0
    rng = np.random.default_rng(seed)
    cfg = DEFAULT_CONFIG
    nd = len(cfg.data_indices) if guard_bands else cfg.n_fft
    n_pilots = len(cfg.pilot_indices) if guard_bands else 0
    sent = rng.integers(0, 256, (batch, nb * nd * BITS_PER_SYMBOL[mod] // 8),
                        dtype=np.uint8)
    x = modulate_bytes_packed(torch.as_tensor(sent), mod).numpy()
    x = x.reshape(batch, nb, nd)
    x = np.concatenate([x, np.ones((batch, nb, n_pilots))], axis=-1)
    nbins = nd + n_pilots
    h = (0.5 + rng.random((batch, nbins))) * np.exp(2j * np.pi * rng.random((batch, nbins)))
    phi = np.exp(0.05j * rng.standard_normal((batch, nb, 1)))
    y = x * h[:, None, :] * phi
    amp = np.sqrt(np.mean(np.abs(y) ** 2) / 10 ** (snr / 10) / 2)
    y = y + amp * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    return y.astype(np.complex64), h.astype(np.complex64), nd, n_pilots, sent


def _pallas_tail(y, h, nd, n_pilots, mod):
    import ofdm_tpu as ot
    return np.asarray(_pallas()[1].eq_demod_pack(
        y.real.astype(np.float32), y.imag.astype(np.float32),
        (1.0 / h).astype(np.complex64), n_data=nd, n_pilots=n_pilots,
        modulation=ot.Modulation(mod.value), interpret=True))


def _port_tail(y, h, f_delta, nd, n_pilots, mod):
    packed = torch.as_tensor(np.concatenate([y.real, y.imag], axis=-1))
    nbins = y.shape[-1]
    return eq_demod_pack_reference(
        packed[..., :nbins], packed[..., nbins:], torch.as_tensor(h),
        torch.as_tensor(f_delta), n_data=nd, n_pilots=n_pilots,
        modulation=mod, cfg=DEFAULT_CONFIG).numpy()


TAIL_CASES = [(Modulation.QAM64, True), (Modulation.QPSK, True),
              (Modulation.QAM256, True), (Modulation.BPSK, False),
              (Modulation.QAM16, False)]


@pytest.mark.parametrize("mod,guard_bands", TAIL_CASES,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_eq_demod_pack_reference_matches_pallas(mod, guard_bands):
    y, h, nd, n_pilots, sent = _tail_case(mod, guard_bands)
    want = _pallas_tail(y, h, nd, n_pilots, mod)
    got = _port_tail(y, h, np.zeros(len(y), np.float32), nd, n_pilots, mod)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sent)


@pytest.mark.parametrize("mod,guard_bands", TAIL_CASES[:2] + TAIL_CASES[3:4],
                         ids=lambda v: getattr(v, "value", str(v)))
def test_eq_demod_pack_reference_cfo_phase(mod, guard_bands):
    """With f_delta != 0 the plain version undoes rot_dc itself; the Pallas
    kernel, which cannot, is fed y * rot_dc and must give the same bytes."""
    y, h, nd, n_pilots, sent = _tail_case(mod, guard_bands, seed=4)
    cfg = DEFAULT_CONFIG
    f_delta = (np.pi / 80 * np.random.default_rng(6).random(len(y))).astype(np.float32)
    chunk = (np.arange(y.shape[1], dtype=np.float32) + cfg.n_sync_chunks) * cfg.sym_len
    angle = f_delta[:, None] * chunk
    y_cfo = (y * np.exp(1j * angle)[..., None]).astype(np.complex64)
    rot_dc = np.exp(-1j * angle).astype(np.complex64)
    want = _pallas_tail((y_cfo * rot_dc[..., None]).astype(np.complex64), h, nd,
                        n_pilots, mod)
    got = _port_tail(y_cfo, h, f_delta, nd, n_pilots, mod)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sent)


def test_eq_demod_pack_rejects_bad_input():
    y, h, nd, n_pilots, _ = _tail_case(Modulation.QAM64, True)
    yr = torch.as_tensor(y.real.copy())
    yi = torch.as_tensor(y.imag.copy())
    fd = torch.zeros(len(y))
    kw = dict(n_pilots=n_pilots, modulation=Modulation.QAM64, cfg=DEFAULT_CONFIG)
    with pytest.raises(ValueError, match="whole bytes"):
        eq_demod_pack(yr, yi, torch.as_tensor(h), fd, n_data=nd - 1, **kw)
    with pytest.raises(ValueError):
        eq_demod_pack(yr.double(), yi, torch.as_tensor(h), fd, n_data=nd, **kw)
    with pytest.raises(ValueError):
        eq_demod_pack(yr, yi, torch.as_tensor(h), fd[:1], n_data=nd, **kw)
    got = eq_demod_pack(yr, yi, torch.as_tensor(h), fd, n_data=nd, **kw)
    assert got.dtype == torch.uint8 and got.shape == (len(y), y.shape[1] * 36)


def test_eq_demod_pack_block_table():
    """A block table reads output block c from input block blocks[c]: the
    same bytes as the planes gathered into that order first."""
    y, h, nd, n_pilots, sent = _tail_case(Modulation.QAM16, True, seed=2, nb=12)
    perm = np.random.default_rng(3).permutation(12)
    shuffled = np.empty_like(y)
    shuffled[:, perm] = y                  # block c now sits at perm[c]
    packed = torch.as_tensor(np.concatenate([shuffled.real, shuffled.imag], -1))
    nbins = y.shape[-1]
    kw = dict(n_data=nd, n_pilots=n_pilots, modulation=Modulation.QAM16,
              cfg=DEFAULT_CONFIG)
    fd = torch.full((len(y),), 0.002)
    blocks = torch.as_tensor(perm[:10], dtype=torch.int32)
    got = eq_demod_pack(packed[..., :nbins], packed[..., nbins:],
                        torch.as_tensor(h), fd, blocks=blocks, **kw)
    ordered = torch.as_tensor(np.concatenate([y.real, y.imag], -1))[:, :10] \
        .contiguous()
    want = eq_demod_pack_reference(ordered[..., :nbins], ordered[..., nbins:],
                                   torch.as_tensor(h), fd, **kw)
    assert torch.equal(got, want) and got.shape == (len(y), 10 * 24)
    with pytest.raises(ValueError, match="blocks"):
        eq_demod_pack(packed[..., :nbins], packed[..., nbins:],
                      torch.as_tensor(h), fd, blocks=blocks.long(), **kw)


def _block_table_case(mod, guard_bands, dev="cpu"):
    """Planes whose blocks sit in a shuffled order, the table that reads 15
    of them back in order, and the same 15 blocks laid out in order."""
    y, h, nd, n_pilots, _ = _tail_case(mod, guard_bands, seed=4)
    perm = np.random.default_rng(5).permutation(y.shape[1])
    shuffled = np.empty_like(y)
    shuffled[:, perm] = y                  # block c now sits at perm[c]
    nbins = y.shape[-1]
    packed = torch.as_tensor(np.concatenate([shuffled.real, shuffled.imag], -1)).to(dev)
    ordered = torch.as_tensor(np.concatenate([y.real, y.imag], -1))[:, :15] \
        .contiguous().to(dev)
    rest = (torch.as_tensor(h).to(dev), torch.full((len(y),), 0.002, device=dev))
    kw = dict(n_data=nd, n_pilots=n_pilots, modulation=mod, cfg=DEFAULT_CONFIG)
    blocks = torch.as_tensor(perm[:15], dtype=torch.int32).to(dev)
    return ((packed[..., :nbins], packed[..., nbins:], *rest),
            (ordered[..., :nbins], ordered[..., nbins:], *rest), blocks, kw)


@pytest.mark.parametrize("mod,guard_bands", TAIL_CASES,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_eq_demod_pack_block_table_every_modulation(mod, guard_bands):
    args, ordered, blocks, kw = _block_table_case(mod, guard_bands)
    got = eq_demod_pack(*args, blocks=blocks, **kw)
    assert torch.equal(got, eq_demod_pack_reference(*ordered, **kw))


@pytest.mark.parametrize("mod", [Modulation.QAM64, Modulation.QPSK],
                         ids=lambda m: m.value)
def test_eq_demod_pack_reference_guard_bands_without_pilots(mod):
    """n_pilots = 0 on planes that still carry the pilot bins: the plain
    version reads the data bins alone, as the Pallas kernel does on planes
    cut to them."""
    y, h, nd, _, _ = _tail_case(mod, True, seed=7)
    want = _pallas_tail(y[..., :nd], h[..., :nd], nd, 0, mod)
    got = _port_tail(y, h, np.zeros(len(y), np.float32), nd, 0, mod)
    np.testing.assert_array_equal(got, want)


def test_new_wrappers_on_cpu_run_the_plain_versions():
    x = torch.as_tensor(_stream(TPL))
    before = (planar_align.launches, pin_rowmajor.launches,
              sync_align_chunked.launches)
    offs = torch.arange(len(DELAYS), dtype=torch.int32) * 7
    assert torch.equal(planar_align(x, offs, NEED, planar=True),
                       planar_align_reference(x, offs, NEED, planar=True))
    v = torch.view_as_real(x).transpose(1, 2)
    assert torch.equal(pin_rowmajor(v), v.contiguous())
    (cr, ci), slots, m_per = sync_align_chunked(x, TPL, n_chunks=30)
    (rr, ri), _, _ = sync_align_chunked_reference(x, TPL, n_chunks=30)
    assert torch.equal(cr, rr) and torch.equal(ci, ri)
    assert (slots, m_per) == (64, 8) and cr.shape == (len(DELAYS), 64, 128)
    assert (planar_align.launches, pin_rowmajor.launches,
            sync_align_chunked.launches) == before


@pytest.mark.parametrize("bad, err", [
    (lambda x: planar_align(x[:, ::2], torch.zeros(8, dtype=torch.int32), 100),
     ValueError),
    (lambda x: planar_align(x, torch.zeros(3, dtype=torch.int32), 100), ValueError),
    (lambda x: planar_align(x, torch.zeros(8, dtype=torch.int32), T + 1),
     ValueError),
    (lambda x: pin_rowmajor(x[0]), ValueError),
    (lambda x: pin_rowmajor(x.reshape(2, 2, 2, 1, -1)), ValueError),
    (lambda x: sync_align_chunked(x, TPL, n_chunks=T // 80 + 1), ValueError),
])
def test_new_wrappers_reject_bad_input(bad, err):
    with pytest.raises(err):
        bad(torch.as_tensor(_stream(TPL)))


def _keys_case(name):
    """(stream, template, lag_bound, first peak lag per row) of a K1 edge,
    or of the headline-like stream ("real", "complex")."""
    if name in ("real", "complex"):
        tpl = TPL if name == "real" else TPL_C
        return _stream(tpl), tpl, T, DELAYS
    s, tpl, _, win, first = _k1_edge(name)
    return s, tpl, s.shape[-1] if win is None else win + len(tpl), first


# K1's one pass: which shapes take it (kernels/align.py::one_pass_cluster)

def _fits(resident, t, need, lag_bound, taps, cluster):
    """The staging arithmetic: ``resident`` CTAs of ``cluster`` a row fit an
    H100 SM's 228 KB of shared memory, 3 KB of each CTA's static."""
    smem = one_pass_shared_bytes(lag_bound, need, taps, t - need, cluster)
    return resident * (smem + 3072) <= 233_472


@pytest.mark.parametrize("shape, cluster", [
    ((2048, 19120, 19040, 19120, 80), 4),      # the batch cell: 4 of 42 KB
    ((256, 19120, 19040, 19120, 80), 4),       # the bench's headline
    ((132, 19120, 19040, 19120, 80), 4),       # 528 CTAs: the card once
    ((131, 19120, 19040, 19120, 80), None),    # fewer: the two kernels
    ((1, 19120, 19040, 19120, 80), None),      # one row: the two kernels
    ((780, 2560, 2560, 160, 80), 1),           # serving: search window 80
    ((256, 19040, 19040, 160, 80), 4),         # the stream resync
    ((2, 1_000_003, 19040, 1_000_003, 80), None),   # chip_smoke's long row
    ((2048, 110_320, 110_240, 110_320, 80), None),  # a BPSK frame's row
    ((2048, 9600, 9520, 9600, 80), 2),
    ((2048, 24_256, 24_176, 24_256, 80), 4),   # the last T with 4 at 4 a row
    ((2048, 24_257, 24_177, 24_257, 80), 8),   # then 8 a row hold 4 an SM
    ((2048, 100_352, 100_272, 100_352, 80), 8),   # the last T that fits 2
    ((2048, 100_353, 100_273, 100_353, 80), None),
    ((2048, 19120, 18000, 19120, 128), 4),     # a halo of max_off = 1,120
], ids=["cell", "headline", "132 rows", "131 rows", "one row", "serving",
        "resync", "long row", "bpsk", "T 9,600", "T 24,256", "T 24,257",
        "T 100,352", "T 100,353", "halo 1,120"])
def test_one_pass_rule(shape, cluster):
    assert one_pass_cluster(*shape) == cluster


@pytest.mark.parametrize("t", [24_256, 24_257, 100_352, 100_353])
def test_one_pass_rule_lands_where_the_staging_arithmetic_says(t):
    """At each boundary of the rule, a CTA's shared memory at the chosen
    cluster size fits its resident CTAs and at no smaller size does (nor,
    past the last, at any size)."""
    shape = (t, t - 80, t, 80)
    got = one_pass_cluster(2048, *shape)
    if got is None:
        assert not any(_fits(2, *shape, c) for c in (1, 2, 4, 8))
        return
    resident = 4 if any(_fits(4, *shape, c) for c in (1, 2, 4, 8)) else 2
    assert _fits(resident, *shape, got)
    assert not any(_fits(resident, *shape, c) for c in (1, 2, 4, 8) if c < got)


def test_one_pass_shared_bytes_of_the_cell():
    """P = 19,120 / 4 = 4,780 -> 4,784, halo 80: 4,864 samples a plane,
    5,472 floats padded, two planes."""
    assert one_pass_shared_bytes(19120, 19040, 80, 80, 4) == 2 * 4 * 5472
    assert one_pass_shared_bytes(19120, 19040, 80, 80, 2) == 86_784


def test_sync_align_one_pass_on_cpu_runs_the_plain_version():
    x = torch.as_tensor(_stream(TPL))
    before = (sync_align.launches, sync_align_one_pass.launches)
    got, raw = sync_align_one_pass(x, TPL, NEED, planar=True)
    ref, raw_ref = sync_align_reference(x, TPL, NEED, planar=True)
    assert torch.equal(got, ref) and torch.equal(raw, raw_ref)
    assert (sync_align.launches, sync_align_one_pass.launches) == before


KEY_CASES = ["real", "complex", *K1_EDGES]


def test_counters_name_every_hand_kernel():
    """``kernels.counters()`` is the one list of launch counters: the eight
    wrappers of the package's public kernel modules, each by its name."""
    found = counters()
    assert set(found) == {"sync_align", "sync_align_one_pass", "planar_align",
                          "sync_keys", "pin_rowmajor", "sync_align_chunked",
                          "eq_demod_pack", "derot_dft"}
    assert all(fn.__name__ == name and type(fn.launches) is int
               for name, fn in found.items())
    assert found["sync_align"] is sync_align and found["derot_dft"] is derot_dft


@pytest.mark.parametrize("name", KEY_CASES)
def test_sync_keys_reference_finds_the_first_peak(name):
    """The keys hold the first lag of maximal power (the lag whose offset,
    lag - 1, the JAX Pallas kernel gives on these streams:
    test_sync_align_reference_edges_match_pallas) and that lag's power."""
    s, tpl, lag_bound, first = _keys_case(name)
    keys = sync_keys_reference(torch.as_tensor(s), tpl, lag_bound)
    np.testing.assert_array_equal(key_lag(keys).numpy(), first)
    pad = np.concatenate([s, np.zeros((s.shape[0], len(tpl)), s.dtype)], axis=1)
    want = np.array([abs(np.dot(pad[i, lag:lag + len(tpl)].astype(np.complex128),
                                np.conj(tpl.astype(np.complex128)))) ** 2
                     for i, lag in enumerate(first)])
    np.testing.assert_allclose(key_power(keys).numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_sync_keys_on_cpu_runs_the_plain_version():
    x = torch.as_tensor(_stream(TPL))
    planes = torch.stack([x.real, x.imag], dim=1).contiguous()
    before = sync_keys.launches
    got = sync_keys(x, TPL, 1000)
    assert torch.equal(got, sync_keys_reference(x, TPL, 1000))
    assert torch.equal(sync_keys(planes, TPL, 1000), got)
    assert sync_keys.launches == before
    # the lag of each key is sync_align's raw offset + 1 over the same scan
    _, raw = sync_align_reference(x, TPL, NEED, search_window=1000 - len(TPL))
    assert torch.equal(key_lag(got), raw.long() + 1)


def test_packed_keys_order_by_power_then_lowest_lag():
    power = torch.tensor([1.0, 2.0, 2.0, 0.0, 3.5e38])
    lag = torch.tensor([7, 9, 3, 0, 123456789])
    keys = pack_keys(power, lag)
    assert torch.equal(key_lag(keys), lag) and torch.equal(key_power(keys), power)
    assert keys[2] > keys[1] > keys[0] > keys[3] and keys[4] == keys.max()


@pytest.mark.parametrize("bad, err", [
    (lambda x: sync_keys(x, np.ones(129, np.complex64), 100), ValueError),
    (lambda x: sync_keys(x, TPL, 0), ValueError),
    (lambda x: sync_keys(x, TPL, T + 1), ValueError),
    (lambda x: sync_keys(x.T, TPL, 100), ValueError),
])
def test_sync_keys_rejects_bad_input(bad, err):
    with pytest.raises(err):
        bad(torch.as_tensor(_stream(TPL)))


# --- the derot DFT: dft_matmul_select_derot_planar ---------------------------
#
# Tolerances are relative to each row's RMS sample.  The float32 forms (the
# plain version's per-row matrix, the kernel's 8 x n/8 split) sum n float32
# products each in its own order, so they differ from the float64 DFT and
# from each other by up to ~n float32 epsilons of the terms' size: 2e-5 * n
# / 64, chip_smoke.py's limit.  float64 agrees to 1e-12 up to 128 points;
# above, the float64 DFT matrix's own entries, at angles up to 2 pi n, round
# by ~n epsilons each and n of them are summed, so its limit grows as n**2.
DEROT_N = [32, 64, 80, 128, 256]


def _derot_tol(dtype: torch.dtype, n: int) -> float:
    if dtype == torch.float32:
        return 2e-5 * n / 64
    return 1e-12 * max(1.0, n / 128) ** 2


def _derot_bins(n: int, guard_bands: bool) -> tuple:
    """The decode path's bins: every bin, or the 802.11a layout scaled to n
    (data bins, then the four pilots; at n = 64 the port's own layout)."""
    if not guard_bands:
        return tuple(range(n))
    pilots = (6, n // 2 - 7, n // 2 + 7, n - 6)
    return tuple(b for b in range(6, n - 5)
                 if b != n // 2 and b not in pilots) + pilots


def _derot_case(n: int, dtype=torch.float32, rows: int = 3, blocks: int = 7,
                seed: int = 0):
    """(xr, xi, omega, sample_offset): strided [R, C, n] views of aligned
    planes [R, 2, chunks * sym_len] past their sync chunks and cyclic
    prefix, as ``decode_frame`` passes them, and a CFO per row."""
    cp, n_sync = n // 4, 10
    rng = np.random.default_rng(seed)
    planes = torch.as_tensor(rng.standard_normal(
        (rows, 2, (n_sync + blocks) * (n + cp)))).to(dtype)
    v = planes.reshape(rows, 2, n_sync + blocks, n + cp)[:, :, n_sync:, cp:]
    omega = torch.as_tensor(0.04 * rng.random(rows) - 0.02).to(dtype)
    return v[:, 0], v[:, 1], omega, cp


def _derot_oracle(xr, xi, bins, omega, offset) -> np.ndarray:
    """The float64 numpy DFT at ``bins`` of the explicitly derotated
    symbols."""
    x = xr.double().cpu().numpy() + 1j * xi.double().cpu().numpy()
    p = np.arange(x.shape[-1]) + offset
    w = omega.double().cpu().numpy()[:, None, None]
    return np.fft.fft(x * np.exp(-1j * w * p), axis=-1)[..., list(bins)]


def _derot_err(yr, yi, want, xr, xi) -> float:
    """Largest |y - want| over each row's RMS sample."""
    got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
    rms = torch.sqrt((xr.double() ** 2 + xi.double() ** 2).mean((1, 2)))
    return float((np.abs(got - want).max((1, 2)) / rms.cpu().numpy()).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("guard_bands", [False, True], ids=["all", "guard"])
@pytest.mark.parametrize("n", DEROT_N)
def test_derot_dft_reference_matches_numpy(n, guard_bands, dtype):
    xr, xi, omega, offset = _derot_case(n, dtype)
    bins = _derot_bins(n, guard_bands)
    yr, yi = dft_matmul_select_derot_planar_reference(xr, xi, bins, omega,
                                                      offset)
    assert yr.shape == yi.shape == (*xr.shape[:2], len(bins))
    assert yr.dtype == dtype and yr.stride() == yi.stride() \
        == (xr.shape[1] * 2 * len(bins), 2 * len(bins), 1)
    assert yi.data_ptr() == yr.data_ptr() + len(bins) * yr.element_size()
    want = _derot_oracle(xr, xi, bins, omega, offset)
    assert _derot_err(yr, yi, want, xr, xi) < _derot_tol(dtype, n)


@pytest.mark.parametrize("guard_bands", [False, True], ids=["all", "guard"])
@pytest.mark.parametrize("n", [8] + DEROT_N)
def test_derot_dft_kernel_tables_give_the_dft(n, guard_bands):
    """The kernel's split, in float64 numpy with the tables its wrapper
    builds: 8-point DFTs over samples n/8 apart, then each bin's column of
    n/8 twiddles against the 8-point output at bin mod 8."""
    bins = _derot_bins(n, guard_bands) if n >= 32 else (7, 0, 3, 5)
    x = np.random.default_rng(n).standard_normal((5, n, 2)) @ [1, 1j]
    sel = kernel_bins(n, bins)
    tw = kernel_twiddle(n, bins) @ [1, 1j]                # [n/8, k]
    a = np.fft.fft(x.reshape(5, 8, n // 8), axis=1)           # [5, 8, n/8]
    got = (a[:, sel % 8, :] * tw.T).sum(-1)
    np.testing.assert_allclose(got, np.fft.fft(x)[:, list(bins)], rtol=0,
                               atol=1e-12 * np.sqrt(n))


@pytest.mark.parametrize("bad", [
    lambda xr, xi, w: (xr, xi[:, :-1], w),          # xi one block short
    lambda xr, xi, w: (xr, xi[..., :-8], w),        # xi's symbols shorter
    lambda xr, xi, w: (xr[0], xi[0], w),            # not [R, C, n]
    lambda xr, xi, w: (xr, xi, w[:-1]),             # omega one row short
    lambda xr, xi, w: (xr, xi, w[:, None]),         # omega [R, 1]
    lambda xr, xi, w: (xr, xi, w[0]),               # omega a scalar
    lambda xr, xi, w: (xr, xi, w.double()),         # omega of another dtype
], ids=["blocks", "symbols", "2d", "omega short", "omega column",
        "omega scalar", "omega dtype"])
def test_derot_dft_rejects_bad_input(bad):
    xr, xi, omega, offset = _derot_case(64)
    args = bad(xr, xi, omega)
    for form in (dft_matmul_select_derot_planar,
                 dft_matmul_select_derot_planar_reference):
        with pytest.raises(ValueError):
            form(args[0], args[1], _derot_bins(64, True), args[2], offset)


def test_derot_dft_on_cpu_runs_the_plain_version():
    xr, xi, omega, offset = _derot_case(64)
    bins = _derot_bins(64, True)
    before = derot_dft.launches
    got = dft_matmul_select_derot_planar(xr, xi, bins, omega, offset)
    ref = dft_matmul_select_derot_planar_reference(xr, xi, bins, omega, offset)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert derot_dft.launches == before


def test_derot_dft_on_another_device_raises():
    xr, xi, omega, offset = _derot_case(64)
    meta = [t.to("meta") for t in (xr, xi, omega)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        dft_matmul_select_derot_planar(meta[0], meta[1], _derot_bins(64, True),
                                       meta[2], offset)


@pytest.mark.parametrize("n,dtype,bins,offset,err", [
    (48, torch.float32, None, 12, "n_fft"),
    (8, torch.float32, (7, 0, 3, 5), 2, "n_fft"),
    (64, torch.float32, (), 16, "bins"),
    (64, torch.float32, None, -1, "sample_offset"),
    (64, torch.float32, None, 16, "float32 CUDA"),     # a CPU tensor
    (64, torch.float64, None, 16, "float32 CUDA"),
], ids=["n48", "n8", "no bins", "offset", "cpu", "f64"])
def test_derot_dft_kernel_refuses_what_it_does_not_take(n, dtype, bins, offset,
                                                        err):
    """The kernel's wrapper refuses, before any launch, the inputs the
    kernel is not built for: on the card these raise, with no other form
    to fall back to."""
    xr, xi, omega, _ = _derot_case(n, dtype)
    bins = _derot_bins(n, True) if bins is None else bins
    before = derot_dft.launches
    with pytest.raises(ValueError, match=err):
        derot_dft(xr, xi, bins, omega, offset)
    assert derot_dft.launches == before


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phases 2-3 run this "
                    "check on the GPU")
    set_full_fp32()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tpl_name", ["real", "complex"])
def test_sync_align_kernel_matches_plain(tpl_name):
    """Covered on the card by chip_smoke.py phase 2."""
    dev = _cuda()
    tpl = TPL if tpl_name == "real" else TPL_C
    for planar_in in (False, True):
        x = _as_input(_stream(tpl), planar_in).to(dev)
        for planar in (False, True):
            got, raw = sync_align(x, tpl, NEED, planar=planar)
            ref, raw_ref = sync_align_reference(x, tpl, NEED, planar=planar)
            assert torch.equal(raw, raw_ref) and torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("mod,guard_bands", TAIL_CASES,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_eq_demod_pack_kernel_matches_plain(mod, guard_bands):
    """Covered on the card by chip_smoke.py phase 3."""
    dev = _cuda()
    y, h, nd, n_pilots, _ = _tail_case(mod, guard_bands, seed=4)
    packed = torch.as_tensor(np.concatenate([y.real, y.imag], -1)).to(dev)
    nbins = y.shape[-1]
    args = (packed[..., :nbins], packed[..., nbins:], torch.as_tensor(h).to(dev),
            torch.full((len(y),), 0.01, device=dev))
    kw = dict(n_data=nd, n_pilots=n_pilots, modulation=mod, cfg=DEFAULT_CONFIG)
    assert torch.equal(eq_demod_pack(*args, **kw),
                       eq_demod_pack_reference(*args, **kw))


@pytest.mark.gpu
def test_planar_align_kernel_matches_plain():
    """Covered on the card by chip_smoke.py's planar_align phase."""
    dev = _cuda()
    s = torch.as_tensor(_stream(TPL)).to(dev)
    offs = torch.tensor([0, 1, 79, 80, 127, 128, 129, T - NEED],
                        dtype=torch.int32, device=dev)
    for x in (s, torch.stack([s.real, s.imag], dim=1).contiguous()):
        for planar in (False, True):
            assert torch.equal(planar_align(x, offs, NEED, planar=planar),
                               planar_align_reference(x, offs, NEED,
                                                      planar=planar))


@pytest.mark.gpu
@pytest.mark.parametrize("tpl_name", ["real", "complex"])
def test_sync_align_chunked_kernel_matches_plain(tpl_name):
    """Covered on the card by chip_smoke.py's sync_align_chunked phase."""
    dev = _cuda()
    tpl = TPL if tpl_name == "real" else TPL_C
    s = torch.as_tensor(_stream(tpl)).to(dev)
    for x in (s, torch.stack([s.real, s.imag], dim=1).contiguous()):
        (gr, gi), _, _ = sync_align_chunked(x, tpl, n_chunks=30)
        (rr, ri), _, _ = sync_align_chunked_reference(x, tpl, n_chunks=30)
        assert torch.equal(gr, rr) and torch.equal(gi, ri)


@pytest.mark.gpu
def test_pin_rowmajor_kernel_matches_plain():
    """Covered on the card by chip_smoke.py's pin_rowmajor phase."""
    dev = _cuda()
    rx = torch.as_tensor(_stream(TPL)).to(dev)
    views = [torch.view_as_real(rx).transpose(1, 2),          # f32 [R, 2, T]
             rx.t(),                                          # complex64 2-D
             torch.arange(5 * 2 * 7 * 128, device=dev, dtype=torch.int32)
             .reshape(5, 2, 7, 128).permute(3, 1, 0, 2),     # int32 4-D
             torch.arange(999, device=dev, dtype=torch.uint8).reshape(27, 37).t(),
             rx.real.contiguous()]                            # already row-major
    for v in views:
        got = pin_rowmajor(v)
        assert got.is_contiguous() and torch.equal(got, pin_rowmajor_reference(v))


@pytest.mark.gpu
def test_eq_demod_pack_block_table_kernel_matches_plain():
    dev = _cuda()
    y, h, nd, n_pilots, _ = _tail_case(Modulation.QAM64, True, seed=4)
    packed = torch.as_tensor(np.concatenate([y.real, y.imag], -1)).to(dev)
    nbins = y.shape[-1]
    blocks = torch.as_tensor(np.random.default_rng(5).permutation(y.shape[1])[:15],
                             dtype=torch.int32).to(dev)
    args = (packed[..., :nbins], packed[..., nbins:], torch.as_tensor(h).to(dev),
            torch.full((len(y),), 0.01, device=dev))
    kw = dict(n_data=nd, n_pilots=n_pilots, modulation=Modulation.QAM64,
              cfg=DEFAULT_CONFIG, blocks=blocks)
    assert torch.equal(eq_demod_pack(*args, **kw),
                       eq_demod_pack_reference(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("name", K1_EDGES)
def test_sync_align_kernel_edges_match_plain(name):
    """Covered on the card by chip_smoke.py phase 2's edge cases."""
    dev = _cuda()
    s, tpl, need, win, first = _k1_edge(name)
    for planar_in in (False, True):
        x = _as_input(s, planar_in).to(dev)
        for planar in (False, True):
            got, raw = sync_align(x, tpl, need, search_window=win, planar=planar)
            ref, raw_ref = sync_align_reference(x, tpl, need, search_window=win,
                                                planar=planar)
            assert torch.equal(raw, raw_ref) and torch.equal(got, ref)
            assert raw.tolist() == [f - 1 for f in first]


# K1's one pass against the two kernels and the plain version.  Its CTAs
# own 4,784 lags each at T = 19,120 (4 a row), so lags 4,784, 9,568 and
# 14,352 open the second to fourth CTA's share.
ONE_PASS_CASES = ["cell", "CTA edges", "ties at CTA edges", "offset max_off",
                  "halo 1,120", "T odd", "one row", "complex template",
                  "search_window", "too long"]


def _one_pass_case(name):
    """(stream [R, T], template, need, search_window, first peak lag per
    row)."""
    rng = np.random.default_rng(31)
    t, need, win, tpl, rows = 19120, 19040, None, TPL, 256
    if name == "ties at CTA edges":
        # integer rows, so every power is exact: copies of one template at
        # two lags 80 or more apart tie, the lower lag on one side of a
        # CTA edge and the higher on the other (or both in one CTA's halo)
        tpl = rng.choice([-2.0, -1.0, 1.0, 2.0], 80).astype(np.complex64)
        pairs = [(4704, 4784), (4744, 4824), (4784, 9568), (9500, 14352),
                 (0, 19040), ()]
        s = np.zeros((144, t), np.complex64)
        for row in range(144):
            for lag in pairs[row % len(pairs)]:
                s[row, lag:lag + 80] += tpl
        first = [(pairs[row % len(pairs)] or (0,))[0] for row in range(144)]
        return s, tpl, need, win, first       # an all-zero row: lag 0
    if name == "CTA edges":
        base = [4783, 4784, 4785, 9567, 9568, 14351, 14352, 19039, 19040,
                0, 1, 7, 8, 81, 4700]
        delays = [base[i % len(base)] for i in range(rows)]
    elif name == "offset max_off":          # every offset clipped to 80
        delays = rng.integers(81, 4000, rows).tolist()
    elif name == "halo 1,120":              # max_off 1,120: the halo
        need = 18000
        delays = rng.integers(0, 1122, rows).tolist()
    elif name == "T odd":                   # T not a multiple of 4
        t, need = 19121, 19041
        delays = rng.integers(0, 200, rows).tolist()
    elif name == "one row":
        rows, delays = 1, [4785]
    elif name == "complex template":
        rows, tpl = 144, TPL_C
        delays = rng.integers(0, 19040, rows).tolist()
    elif name == "search_window":           # serving's shape: 1 CTA a row
        rows, t, need, win = 780, 2560, 2560, 80
        delays = rng.integers(0, 160, rows).tolist()
    elif name == "too long":                # a BPSK frame's row
        rows, t, need = 2, 110_320, 110_240
        delays = [54_321, 110_240]
    else:
        delays = rng.integers(0, 200, rows).tolist()
    s = 0.01 * (rng.standard_normal((rows, t))
                + 1j * rng.standard_normal((rows, t)))
    for i, d in enumerate(delays):
        s[i, d:d + len(tpl)] += tpl
    return s.astype(np.complex64), tpl, need, win, delays


@pytest.mark.gpu
@pytest.mark.parametrize("name", ONE_PASS_CASES)
def test_sync_align_one_pass_matches_two_kernels_and_plain(name):
    """Covered on the card by chip_smoke.py phase 2.  ``sync_align`` takes
    one pass where ``one_pass_cluster`` says, and ``sync_align_one_pass``
    runs every shape that fits; offsets and windows are bitwise those of
    the two kernels and of the plain version, on complex and planar input
    and output."""
    dev = _cuda()
    s, tpl, need, win, first = _one_pass_case(name)
    rows, t = s.shape
    lag_bound = t if win is None else min(t, win + len(tpl))
    takes = one_pass_cluster(rows, t, need, lag_bound, len(tpl)) is not None
    fits = name != "too long"
    assert takes == (fits and name != "one row")
    for planar_in in (False, True):
        x = _as_input(s, planar_in).to(dev)
        for planar in (False, True):
            ref, raw_ref = sync_align_reference(x, tpl, need, search_window=win,
                                                planar=planar)
            two, raw_two = align._two_pass(x, tpl, need, lag_bound, planar)
            before = sync_align_one_pass.launches
            got, raw = sync_align(x, tpl, need, search_window=win,
                                  planar=planar)
            assert sync_align_one_pass.launches - before == int(takes)
            if fits:
                one, raw_one = sync_align_one_pass(x, tpl, need,
                                                   search_window=win,
                                                   planar=planar)
            else:
                with pytest.raises(ValueError, match="do not fit one pass"):
                    sync_align_one_pass(x, tpl, need, search_window=win,
                                        planar=planar)
                one, raw_one = got, raw
            assert sync_align_one_pass.launches - before == takes + fits
            for w, r in ((two, raw_two), (got, raw), (one, raw_one)):
                assert torch.equal(r, raw_ref) and torch.equal(w, ref)
            assert raw.tolist() == [f - 1 for f in first]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(19120, 19040, 19120, 80, 80),
                                   (19120, 18000, 19120, 128, 1120),
                                   (2560, 2560, 160, 80, 0),
                                   (110_320, 110_240, 110_320, 80, 80)])
def test_one_pass_shared_bytes_agree_with_the_kernel(shape):
    """kernels/align.py's staging arithmetic is the kernel's, byte for byte,
    at every cluster size."""
    _cuda()
    t, need, lag_bound, taps, max_off = shape
    lib = align.sync_lib()
    for c in (1, 2, 4, 8):
        assert lib.ofdm_sync_align_one_pass_shared_bytes(
            lag_bound, need, taps, max_off, c) == one_pass_shared_bytes(
                lag_bound, need, taps, max_off, c)


@pytest.mark.gpu
@pytest.mark.parametrize("mod,guard_bands", TAIL_CASES,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_eq_demod_pack_block_table_every_modulation_kernel(mod, guard_bands):
    """Covered on the card by chip_smoke.py phase 3."""
    args, ordered, blocks, kw = _block_table_case(mod, guard_bands, _cuda())
    got = eq_demod_pack(*args, blocks=blocks, **kw)
    assert torch.equal(got, eq_demod_pack_reference(*args, blocks=blocks, **kw))
    assert torch.equal(got, eq_demod_pack_reference(*ordered, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("mod", [Modulation.QAM64, Modulation.QPSK],
                         ids=lambda m: m.value)
def test_eq_demod_pack_kernel_guard_bands_without_pilots(mod):
    """Covered on the card by chip_smoke.py phase 3."""
    dev = _cuda()
    y, h, nd, _, _ = _tail_case(mod, True, seed=7)
    packed = torch.as_tensor(np.concatenate([y.real, y.imag], -1)).to(dev)
    nbins = y.shape[-1]
    args = (packed[..., :nbins], packed[..., nbins:], torch.as_tensor(h).to(dev),
            torch.full((len(y),), 0.01, device=dev))
    kw = dict(n_data=nd, n_pilots=0, modulation=mod, cfg=DEFAULT_CONFIG)
    assert torch.equal(eq_demod_pack(*args, **kw),
                       eq_demod_pack_reference(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["complex", "planar", "planar strided"])
def test_planar_align_shared_stream_kernel_matches_plain(form):
    """Covered on the card by chip_smoke.py phase 6."""
    dev = _cuda()
    x = stream_forms(torch.as_tensor(shared_stream_case()).to(dev))[form]
    offs = torch.tensor(OFFS_S, dtype=torch.int32, device=dev)
    for planar in (False, True):
        got = planar_align(x, offs, NEED_S, planar=planar)
        assert torch.equal(got, planar_align_reference(x, offs, NEED_S,
                                                       planar=planar))


@pytest.mark.gpu
@pytest.mark.parametrize("resync", [True, False])
def test_decode_regular_on_cuda_waits_once(resync):
    """Covered on the card by chip_smoke.py phase 9: the CPU's bytes, and
    one synchronizing call per decode (the output fetch)."""
    dev = _cuda()
    user = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (4, 96), dtype=np.uint8))
    frames = ott.encode_hamming(user, guard_bands=True, modulation=Modulation.QPSK)
    stream = frames.reshape(-1)
    kw = dict(n_frames=4, spacing=frames.shape[1], payload_len=168,
              modulation=Modulation.QPSK, fec="hamming", data_len=96,
              resync=resync)
    want = ott.decode_regular(stream, **kw)
    on_card = stream.to(dev)
    ott.decode_regular(on_card, **kw)                       # warm the tables
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = ott.decode_regular(on_card, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, syncs
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], user.numpy())


# --- the frozen captures and the decode diagnostics on the card ---------------

GOLDEN = Path(__file__).resolve().parent / "golden"
CAPTURES = {"rx_capture_qam64": Modulation.QAM64,
            "torch_capture_qam256": Modulation.QAM256,
            "torch_capture_bpsk_gb": Modulation.BPSK}


def _capture(name):
    """(rows complex64 [R, T], bytes JAX's decode_frame gave [R, n], n_blocks,
    the payload JAX's decode gave for row 0) of a frozen capture."""
    if name == "rx_capture_qam64":
        exp = np.load(GOLDEN / "rx_capture_expected.npz")
        rows = read_iq(GOLDEN / f"{name}.dat", dtype=np.complex64)[None]
        return rows, exp["decoded"][None], int(exp["n_blocks"]), exp["payload"]
    exp = np.load(GOLDEN / f"{name}.npz")
    rows = read_iq(GOLDEN / f"{name}.dat", dtype=np.complex64).reshape(
        -1, int(exp["row_len"]))
    return rows, exp["decoded"], int(exp["n_blocks"]), exp["decode_payload"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CAPTURES)
def test_frozen_capture_decode_frame_on_cuda(name):
    """Covered on the card by chip_smoke.py phase 13: the bytes the JAX
    package decoded, as stored and tiled to 256 rows (the headline batch,
    so cuBLAS picks that shape's GEMM)."""
    dev = _cuda()
    rows, decoded, nb, _ = _capture(name)
    kw = dict(n_blocks=nb, guard_bands=True, modulation=CAPTURES[name])
    x = torch.as_tensor(rows).to(dev)
    want = torch.as_tensor(decoded).to(dev)
    assert torch.equal(ott.decode_frame(x, **kw), want)
    reps = 256 // x.shape[0]
    assert torch.equal(ott.decode_frame(x.repeat(reps, 1), **kw),
                       want.repeat(reps, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CAPTURES)
def test_decode_diagnostics_on_cuda(name):
    """Covered on the card by chip_smoke.py phase 13: row 0 through
    ``decode(return_diagnostics=True)`` on the card gives the payload JAX
    gave, and the CPU's offset, keys, shapes and (to 1e-4) signals."""
    dev = _cuda()
    rows, _, _, payload = _capture(name)
    kw = dict(guard_bands=True, modulation=CAPTURES[name],
              return_diagnostics=True)
    want, wdiag = ott.decode(rows[0], device="cpu", **kw)
    got, diag = ott.decode(rows[0], device=dev, **kw)
    np.testing.assert_array_equal(got, payload)
    np.testing.assert_array_equal(got, want)
    assert diag["offset"] == wdiag["offset"] and set(diag) == set(wdiag)
    for key, w in wdiag.items():
        if key == "offset":
            continue
        assert diag[key].shape == w.shape and diag[key].dtype == w.dtype, key
        np.testing.assert_allclose(diag[key], w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-3))


@pytest.mark.gpu
def test_plain_decode_launches_what_it_did():
    """A plain ``decode`` on the card launches K1 once and K2 once, with or
    without the diagnostics asked for (they are computed in plain torch)."""
    dev = _cuda()
    rows, _, _, _ = _capture("torch_capture_qam256")
    for diag in (False, True):
        sync_align.launches = eq_demod_pack.launches = 0
        ott.decode(rows[0], guard_bands=True, modulation=Modulation.QAM256,
                   device=dev, return_diagnostics=diag)
        assert (sync_align.launches, eq_demod_pack.launches) == (1, 1), diag


@pytest.mark.gpu
@pytest.mark.parametrize("name", KEY_CASES)
def test_sync_keys_kernel_matches_plain(name):
    """The same lag on every row and the power within 1e-6 relative (the
    kernel sums each correlation in another order); covered on the card by
    chip_smoke.py phase 15."""
    dev = _cuda()
    s, tpl, lag_bound, first = _keys_case(name)
    for planar_in in (False, True):
        x = _as_input(s, planar_in).to(dev)
        before = sync_keys.launches
        got = sync_keys(x, tpl, lag_bound)
        ref = sync_keys_reference(x, tpl, lag_bound)
        assert sync_keys.launches == before + 1
        assert torch.equal(key_lag(got), key_lag(ref))
        assert key_lag(got).tolist() == list(first)
        torch.testing.assert_close(key_power(got), key_power(ref), rtol=1e-6,
                                   atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("guard_bands", [False, True], ids=["all", "guard"])
@pytest.mark.parametrize("n", DEROT_N)
def test_derot_dft_kernel_matches_plain(n, guard_bands):
    """The kernel on strided plane views and on lane-sliced slots (the
    chunked route's 128 lanes; wider for 256 points), against the plain
    version and the float64 DFT; float64 planes and an n_fft the kernel is
    not built for raise on the card.  Covered on the card by chip_smoke.py's
    derot_dft phase."""
    dev = _cuda()
    bins = _derot_bins(n, guard_bands)
    xr, xi, omega, offset = (t.to(dev) if torch.is_tensor(t) else t
                             for t in _derot_case(n, rows=5, blocks=40))
    width = max(128, n + 64)
    slots = torch.zeros((2, 5, 40, width), device=dev)
    lanes = slice(width - n, width)
    slots[0, :, :, lanes], slots[1, :, :, lanes] = xr, xi
    for pr, pi in ((xr, xi), (slots[0, :, :, lanes], slots[1, :, :, lanes])):
        before = derot_dft.launches
        yr, yi = dft_matmul_select_derot_planar(pr, pi, bins, omega, offset)
        assert derot_dft.launches == before + 1
        rr, ri = dft_matmul_select_derot_planar_reference(pr, pi, bins, omega,
                                                          offset)
        assert yr.stride() == rr.stride() and yi.stride() == ri.stride()
        assert yi.data_ptr() - yr.data_ptr() == ri.data_ptr() - rr.data_ptr()
        want = _derot_oracle(pr, pi, bins, omega, offset)
        plain = rr.double().cpu().numpy() + 1j * ri.double().cpu().numpy()
        assert _derot_err(yr, yi, plain, pr, pi) < _derot_tol(torch.float32, n)
        assert _derot_err(yr, yi, want, pr, pi) < _derot_tol(torch.float32, n)
    before = derot_dft.launches
    d = [t.double() for t in (xr, xi, omega)]
    with pytest.raises(ValueError, match="float32 CUDA"):
        dft_matmul_select_derot_planar(d[0], d[1], bins, d[2], offset)
    with pytest.raises(ValueError, match="n_fft"):
        dft_matmul_select_derot_planar(xr[..., :-8], xi[..., :-8], bins[:4],
                                       omega, offset)
    assert derot_dft.launches == before
