"""The plain receiver against the program's CPU path, and the comparison
against output computed in a lower precision."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ofdm_tpu_torch.phy.modulation import Modulation
from ofdm_tpu_torch.phy.rx import decode_frame
from ofdm_tpu_torch.phy.streaming import decode_regular
from rxbench import check, registry, traffic
from rxbench.reference import receiver
from rxbench.wire import frame, tx

CPU = torch.device("cpu")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (the operands
    a TF32 matmul multiplies)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def batch(rows: int, payload: int, snr: float, seed: int, timing_error: bool):
    cfg = {"modulation": "qam64", "guard_bands": True, "payload_bytes": payload,
           "row_samples": frame.SYNC_LEN + 80 * (frame.n_data_blocks(
               payload, "qam64", True) + 1)}
    tr = {"rows": rows, "timing_error": [timing_error], "snr_db": [snr, snr]}
    return cfg, traffic.frame_rows(cfg, tr, seed, 0, CPU)


def stream(frames: int, user: int, snr: float, seed: int):
    cfg = {"modulation": "qam64", "guard_bands": True, "fec": "hamming",
           "user_bytes": user}
    tr = {"frames": frames, "timing_error": [False], "snr_db": [snr, snr]}
    return cfg, traffic.stream(cfg, tr, seed, 0, CPU)


@pytest.mark.parametrize("seed,snr,timing_error",
                         [(1, 45.0, False), (2, 45.0, True), (3, 20.0, True),
                          (2**32 + 5, 25.0, False)])
def test_reference_decodes_rows_as_the_program(seed, snr, timing_error):
    cfg, rows = batch(8, 256, snr, seed, timing_error)
    nb = frame.n_data_blocks(256, "qam64", True)
    got = decode_frame(rows, n_blocks=nb, guard_bands=True,
                       modulation=Modulation.QAM64)
    want = receiver.decode_rows(rows, n_blocks=nb, modulation="qam64")
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed,snr", [(1, 45.0), (4, 20.0)])
def test_reference_decodes_streams_as_the_program(seed, snr):
    cfg, s = stream(4, 300, snr, seed)
    plen, flen = traffic.payload_len(cfg), traffic.frame_len(cfg)
    nb = frame.n_data_blocks(plen, "qam64", True)
    got, ok = decode_regular(s, n_frames=4, spacing=flen, payload_len=plen,
                             guard_bands=True, modulation=Modulation.QAM64,
                             fec="hamming", data_len=300, resync=False)
    raw = receiver.decode_stream(s, n_frames=4, spacing=flen, n_blocks=nb,
                                 modulation="qam64")
    want = receiver.hamming_decode(raw[:, 16:16 + plen], 300)
    assert ok.all()
    assert np.array_equal(got, want.numpy())


def test_clean_frames_decode_to_what_was_sent():
    cfg = {"modulation": "qam64", "guard_bands": True, "fec": "hamming",
           "user_bytes": 50}
    g = traffic.generator(CPU, 9, 0)
    data = torch.randint(0, 256, (3, 50), generator=g, dtype=torch.uint8)
    sent = tx.encode(tx.hamming_encode(data), "qam64")
    plen = traffic.payload_len(cfg)
    nb = frame.n_data_blocks(plen, "qam64", True)
    raw = receiver.decode_windows(sent.to(torch.complex128), n_blocks=nb,
                                  modulation="qam64", guard_bands=True)
    assert torch.equal(receiver.hamming_decode(raw[:, 16:16 + plen], 50), data)


def test_hamming_corrects_one_flip_a_codeword():
    data = torch.arange(40, dtype=torch.uint8)[None]
    coded = tx.hamming_encode(data)
    bits = ((coded[..., None] >> torch.arange(8)) & 1).reshape(-1)
    for cw in range(2 * 40):
        bits[7 * cw + cw % 7] ^= 1
    flipped = (bits.reshape(-1, 8).to(torch.int32) << torch.arange(8)).sum(-1)
    out = receiver.hamming_decode(flipped.to(torch.uint8)[None], 40)
    assert torch.equal(out, data)


@pytest.mark.parametrize("name", ["batch_qam64_b2048",
                                  "stream_hamming_qam64_f2048"])
def test_lower_precision_fails_the_comparison(name):
    """At the low end of the cells' SNR range, the plain receiver with its
    matmul operands in TF32 (the control) reads above the cell's limit,
    and the program reads within it."""
    limit = registry.limits(name)[check.NUMBER]["limit"]
    if name.startswith("batch"):
        cfg, rows = batch(16, 8192, 20.0, 11, True)
        nb = frame.n_data_blocks(8192, "qam64", True)
        prog = decode_frame(rows, n_blocks=nb, guard_bands=True,
                            modulation=Modulation.QAM64).numpy()

        def ref(**kw):
            return receiver.decode_rows(rows, n_blocks=nb, modulation="qam64",
                                        **kw).numpy()
    else:
        cfg, s = stream(32, 4680, 20.0, 11)
        plen, flen = traffic.payload_len(cfg), traffic.frame_len(cfg)
        nb = frame.n_data_blocks(plen, "qam64", True)
        prog = decode_regular(s, n_frames=32, spacing=flen, payload_len=plen,
                              guard_bands=True, modulation=Modulation.QAM64,
                              fec="hamming", data_len=4680, resync=False)[0]

        def ref(**kw):
            raw = receiver.decode_stream(s, n_frames=32, spacing=flen,
                                         n_blocks=nb, modulation="qam64", **kw)
            return receiver.hamming_decode(raw[:, 16:16 + plen], 4680).numpy()
    judge = ref()
    control = ref(dtype=torch.float32, operands=tf32)
    assert check.mismatch_ppm(prog, judge) <= limit
    assert check.mismatch_ppm(control, judge) > limit


@pytest.mark.gpu
def test_tf32_control_fails_on_the_card(card):
    """The control as the chip runs it: TF32 matmuls switched on for the
    plain receiver in float32."""
    from rxbench.control import tf32_matmuls
    limit = registry.limits("batch_qam64_b2048")[check.NUMBER]["limit"]
    cfg, rows = batch(64, 8192, 20.0, 12, True)
    rows = rows.to(card)
    nb = frame.n_data_blocks(8192, "qam64", True)
    judge = receiver.decode_rows(rows, n_blocks=nb, modulation="qam64")
    with tf32_matmuls():
        control = receiver.decode_rows(rows, n_blocks=nb, modulation="qam64",
                                       dtype=torch.float32)
    assert check.mismatch_ppm(control.cpu().numpy(),
                              judge.cpu().numpy()) > limit
