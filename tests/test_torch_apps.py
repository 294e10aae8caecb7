"""The port's CLI apps on the CPU (``--device cpu``) with their seeded
defaults: every case of tests/test_apps.py and of the apps in
tests/test_stats_apps2.py, ``ber_sweep --awgn-theory`` against the JAX
app's JSON (equal, not close: both draw data and noise with numpy from the
same seeds), and tests/test_ber_theory.py's cases on the port's mapper
(within 20% of the analytic curve, as there).  Cases that write a PNG or
read a GIF need Pillow and skip without it."""

import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdm_tpu.apps import ber_sweep as jax_ber_sweep
from ofdm_tpu_torch.apps import (ber_sweep, common, datatoframe, lab3a, lab3b,
                                 lab3b_image, lab3c, lab3c_image, monitor,
                                 probe, rx_stream, stream_bytes, transmitloop)
from ofdm_tpu_torch.io.iqfile import read_iq, write_iq
from ofdm_tpu_torch.obs import taps
from ofdm_tpu_torch.obs.ber_theory import ber_awgn, q_func
from ofdm_tpu_torch.packets.colors import id_to_rgb
from ofdm_tpu_torch.phy.modulation import Modulation

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
APPS_DIR = Path(__file__).resolve().parent.parent / "ofdm_tpu_torch" / "apps"
DEVICE_APPS = [ber_sweep, lab3a, lab3b, lab3b_image, lab3c, lab3c_image, monitor,
               probe, rx_stream, stream_bytes, transmitloop]


# --- tests/test_apps.py -------------------------------------------------------

def test_lab3a_loopback(capsys):
    rc = lab3a.main(["--msg-bytes", "120", "--ecc", "--guard-bands", "--cfo",
                     "--seed", "1", *CPU])
    out = capsys.readouterr().out
    assert rc == 0
    assert "I met a traveller" in out


def test_lab3a_qam64(capsys):
    rc = lab3a.main(["--msg-bytes", "64", "--modulation", "qam64",
                     "--snr", "45", "--guard-bands", *CPU])
    assert rc == 0


def test_lab3a_taps(tmp_path, monkeypatch, capsys):
    """--taps writes the transmitted and channeled streams and the decoder's
    four signals under the reference's names, and leaves taps off."""
    monkeypatch.chdir(tmp_path)
    rc = lab3a.main(["--msg-bytes", "120", "--ecc", "--guard-bands", "--cfo",
                     "--seed", "1", "--taps", *CPU])
    assert rc == 0 and not taps.enabled()
    names = ["transmitted_3a", "channeled_3a", "preq_correction_3a",
             "post_correction_3a", "hk_estimate_3a", "no_phaseoffset"]
    assert sorted(os.listdir(tmp_path / "data" / "simulated")) == sorted(
        f"{n}_{part}.npy" for n in names for part in ("reals", "imag"))
    assert np.load(tmp_path / "data/simulated/hk_estimate_3a_reals.npy").shape == (64,)


def test_lab3c_roundtrip(tmp_path, capsys):
    path = str(tmp_path / "tx.dat")
    assert lab3c.main(["--transmit", path, "--msg-bytes", "100", *CPU]) == 0
    assert os.path.getsize(path) > 0
    assert lab3c.main(["--receive", path, "--msg-bytes", "100", *CPU]) == 0
    assert "I met a traveller" in capsys.readouterr().out


def test_lab3c_start_stop_slicing(tmp_path):
    path = str(tmp_path / "tx.dat")
    lab3c.main(["--transmit", path, "--msg-bytes", "50", *CPU])
    # prepend junk then receive with --start to skip it
    sig = read_iq(path)
    write_iq(path, np.concatenate([np.zeros(500, np.complex128), sig]))
    assert lab3c.main(["--receive", path, "--msg-bytes", "50",
                       "--start", "400", *CPU]) == 0


def test_lab3c_plot(tmp_path, capsys):
    assert lab3c.main(["--transmit", str(tmp_path / "tx.dat"), "--msg-bytes",
                       "50", "--plot", *CPU]) == 0
    out = capsys.readouterr().out
    assert any(0x2800 <= ord(ch) <= 0x28ff for ch in out)     # braille art
    assert os.path.getsize(tmp_path / "tx.dat") % 8 == 0


def test_lab3b_image():
    """The seeded default image survives the channel (return code 0 means
    0 bit errors after FEC); no Pillow without --out."""
    assert lab3b_image.main(["--snr", "28", "--seed", "3", *CPU]) == 0


def test_lab3b_image_png(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    out = str(tmp_path / "r.png")
    assert lab3b_image.main(["--out", out, "--snr", "28", "--seed", "3", *CPU]) == 0
    want = id_to_rgb(common.seeded_image(24, 24)).reshape(24, 24, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)


def test_lab3b_image_from_a_file(tmp_path):
    image = np.random.default_rng(5).integers(0, 256, 16 * 12, dtype=np.uint8)
    (tmp_path / "img.bytes").write_bytes(image.tobytes())
    assert lab3b_image.main(["--image", str(tmp_path / "img.bytes"), "--width",
                             "16", "--height", "12", "--snr", "28", *CPU]) == 0


def test_stream_bytes_and_replay(tmp_path):
    rc = stream_bytes.main(["--out-dir", str(tmp_path), *CPU])
    assert rc == 0
    files = sorted(str(tmp_path / f) for f in os.listdir(tmp_path))
    assert len(files) == 8
    rc = rx_stream.main(["--files", *files[:2], *CPU])
    assert rc == 0


def test_stream_bytes_frames_differ(tmp_path):
    stream_bytes.main(["--out-dir", str(tmp_path), *CPU])
    a, b = (read_iq(tmp_path / f"tx_dance{i}.dat") for i in (0, 1))
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_rx_stream_synthetic(tmp_path):
    pytest.importorskip("PIL")
    rc = rx_stream.main(["--buffers", "2", "--buffer-len", "32768",
                         "--out-dir", str(tmp_path), *CPU])
    assert rc == 0
    assert len(os.listdir(tmp_path)) == 2


def test_monitor(capsys):
    rc = monitor.main(["--buffers", "1", "--no-clear", *CPU])
    out = capsys.readouterr().out
    assert rc == 0
    assert "decode ok" in out and "errs=0" in out
    assert "-- equalized constellation --" in out


def test_probe(capsys):
    assert probe.main(CPU) == 0
    out = capsys.readouterr().out
    assert "device" in out and "matmul smoke test: OK" in out
    assert f"torch {torch.__version__}" in out


def test_datatoframe(capsys):
    """The terminal preview of the seeded image: one ANSI cell per pixel."""
    assert datatoframe.main([]) == 0
    out = capsys.readouterr().out
    assert out.count("\x1b[48;2;") == 24 * 24 and len(out.splitlines()) == 24
    r, g, b = id_to_rgb(common.seeded_image(24, 24))[0]
    assert out.startswith(f"\x1b[48;2;{r};{g};{b}m ")


def test_datatoframe_png(tmp_path):
    pytest.importorskip("PIL")
    out = str(tmp_path / "frame.png")
    assert datatoframe.main(["--out", out]) == 0
    assert os.path.getsize(out) > 0


def test_datatoframe_short_file(tmp_path, capsys):
    (tmp_path / "short.bytes").write_bytes(bytes(100))
    assert datatoframe.main([str(tmp_path / "short.bytes")]) == 1
    assert "need 576" in capsys.readouterr().out


def test_rx_stream_continuous_burst():
    """--continuous default (burst) and --scan-loop both recover frames."""
    args = ["--buffers", "2", "--buffer-len", "32768", "--continuous", *CPU]
    assert rx_stream.main(args) == 0
    assert rx_stream.main(args + ["--scan-loop"]) == 0


def test_ber_sweep(capsys):
    rc = ber_sweep.main(["--snrs", "0", "30", "--modulations", "qpsk",
                         "--batch", "4", "--payload", "64", "--json", *CPU])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    curve = res["ber"]["qpsk"]
    assert curve[1] == 0.0          # clean at the reference operating SNR
    assert curve[0] > curve[1]      # waterfall: worse at 0 dB


def test_ber_sweep_takes_qam256_and_plots(capsys):
    rc = ber_sweep.main(["--snrs", "5", "55", "--modulations", "qam256",
                         "--batch", "2", "--payload", "96", *CPU])
    out = capsys.readouterr().out
    assert rc == 0 and "log10(BER)" in out
    curve = json.loads(next(l for l in out.splitlines()
                            if l.startswith("{")))["ber"]["qam256"]
    assert curve[1] == 0.0 and curve[0] > 0.0


# --- tests/test_stats_apps2.py ------------------------------------------------

class TestApps2:
    def test_lab3b_is_lab3a_with_cfo(self, capsys):
        rc = lab3b.main(["--msg-bytes", "80", "--guard-bands", "--seed", "1",
                         *CPU])
        assert rc == 0

    def test_lab3c_image_roundtrip(self, tmp_path):
        """The recovered frame equals the seeded image's ids (no Pillow)."""
        iq = str(tmp_path / "img.dat")
        ids = tmp_path / "img.bytes"
        assert lab3c_image.main(["--transmit", iq, *CPU]) == 0
        assert lab3c_image.main(["--receive", iq, "--out-bytes", str(ids),
                                 *CPU]) == 0
        assert ids.read_bytes() == common.seeded_image(24, 24).tobytes()

    def test_lab3c_image_png(self, tmp_path):
        Image = pytest.importorskip("PIL.Image")
        iq = str(tmp_path / "img.dat")
        png = str(tmp_path / "img.png")
        assert lab3c_image.main(["--transmit", iq, *CPU]) == 0
        assert lab3c_image.main(["--receive", iq, "--out", png, *CPU]) == 0
        expected = id_to_rgb(common.seeded_image(24, 24)).reshape(24, 24, 3)
        np.testing.assert_array_equal(np.asarray(Image.open(png)), expected)

    def test_transmitloop(self, tmp_path):
        out = str(tmp_path / "loop.dat")
        rc = transmitloop.main(["--iterations", "3", "--out", out, *CPU])
        assert rc == 0
        sz = os.path.getsize(out)
        assert sz > 0 and sz % 8 == 0  # whole fc32 samples

    def test_transmitloop_stream_decodable(self, tmp_path):
        # frames written by transmitloop decode through the streaming receiver
        out = str(tmp_path / "loop.dat")
        transmitloop.main(["--iterations", "1", "--out", out, *CPU])
        assert rx_stream.main(["--files", out, *CPU]) == 0

    def test_transmitloop_dry_run(self):
        assert transmitloop.main(["--iterations", "2", *CPU]) == 0


def test_gif_input(tmp_path):
    """--gif still reads a GIF through gif_to_bytestream (Pillow)."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    frames = [Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                              "RGB") for _ in range(3)]
    gif = tmp_path / "tiny.gif"
    frames[0].save(gif, save_all=True, append_images=frames[1:])
    assert stream_bytes.main(["--gif", str(gif), "--out-dir",
                              str(tmp_path / "out"), *CPU]) == 0
    assert len(os.listdir(tmp_path / "out")) == 3


# --- the defaults and the device flag -----------------------------------------

def test_seeded_defaults():
    image = common.seeded_image(24, 24)
    assert image.dtype == np.uint8 and image.shape == (576,)
    np.testing.assert_array_equal(image, common.load_image(None, 24, 24))
    dims, frames = common.load_frames(None)
    assert dims == (24, 24) and len(frames) == 8
    np.testing.assert_array_equal(frames[0], image)
    assert len({f.tobytes() for f in frames}) == 8


@pytest.mark.parametrize("path", sorted(APPS_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_no_app_defaults_to_the_reference_checkout(path):
    """The JAX apps default to files under the reference's support/
    directory, which a bare checkout lacks."""
    text = path.read_text()
    assert "reference/support" not in text and "DEFAULT_GIF" not in text


@pytest.mark.parametrize("app", DEVICE_APPS, ids=lambda m: m.__name__.split(".")[-1])
def test_apps_default_to_cuda_and_do_not_fall_back(app, monkeypatch, tmp_path):
    """Without --device an app asks for the card, and where there is none it
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    args = {"lab3c": ["--transmit", "x.dat"],
            "lab3c_image": ["--transmit", "x.dat"]}.get(
                app.__name__.split(".")[-1], [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.main(args)


# --- ber_sweep --awgn-theory and tests/test_ber_theory.py ----------------------

def test_awgn_theory_json_equals_the_jax_apps(capsys):
    args = ["--awgn-theory", "--json", "--snrs", "6", "14", "--modulations",
            "bpsk", "qam16", "qam256"]
    assert jax_ber_sweep.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ber_sweep.main(args + CPU) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["awgn"]["qam16"][1]["measured"] > 0


# (modulation, Es/N0 dB points) of tests/test_ber_theory.py: BER ~2e-3 .. 3e-2
THEORY_CASES = [
    (Modulation.BPSK, [4.0, 7.0]),
    (Modulation.QPSK, [7.0, 10.0]),
    (Modulation.QAM16, [12.0, 15.0]),
    (Modulation.QAM64, [18.0, 21.0]),
    (Modulation.QAM256, [24.0, 27.0]),
]


@pytest.mark.parametrize("mod,snrs", THEORY_CASES,
                         ids=[m.value for m, _ in THEORY_CASES])
def test_ber_matches_analytic_gray_curve(mod, snrs):
    for snr_db in snrs:
        theory = ber_awgn(mod, snr_db)
        measured = ber_sweep.measure_ber_awgn(
            mod, snr_db, n_bytes=3 * (1 << 15), seed=int(snr_db * 10),
            device="cpu")
        assert 0.8 * theory < measured < 1.2 * theory, (
            f"{mod.value} @ {snr_db} dB Es/N0: measured BER {measured:.3e} "
            f"outside 20% of analytic {theory:.3e}")


def test_analytic_formula_sanity():
    """Pin the copied closed form to independently known values."""
    assert abs(ber_awgn(Modulation.BPSK, 0.0) - q_func(math.sqrt(2))) < 1e-12
    for s in (3.0, 6.0, 9.0):
        g = 10 ** (s / 10)
        assert abs(ber_awgn(Modulation.QPSK, s) - q_func(math.sqrt(g))) < 1e-12
    g = 10 ** (20 / 10)
    lead = 0.75 * q_func(math.sqrt(g / 5))
    assert abs(ber_awgn(Modulation.QAM16, 20.0) - lead) / lead < 0.02
    for mod, _ in THEORY_CASES:
        vals = [ber_awgn(mod, s) for s in (5, 10, 15, 20, 25)]
        assert all(a > b for a, b in zip(vals, vals[1:]))


def test_measure_ber_counts_on_the_device():
    kw = dict(batch=4, payload=64, guard_bands=True, cfo=False, seed=7,
              device="cpu")
    assert ber_sweep.measure_ber(Modulation.QAM64, 45.0, **kw) == 0.0
    noisy = ber_sweep.measure_ber(Modulation.QAM64, 5.0, **kw)
    assert 0.0 < noisy < 0.5
    assert noisy == ber_sweep.measure_ber(Modulation.QAM64, 5.0, **kw)
