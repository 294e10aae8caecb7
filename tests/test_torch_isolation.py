"""The port must run where jax is absent: it imports neither jax nor
anything of ofdm_tpu, and neither does chip_smoke.py."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ofdm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ofdm_tpu"), f"{path} imports {mod}"


PORT = ROOT / "ofdm_tpu_torch"


def _imports(tree: ast.AST, path: Path):
    """(module, name, bound) per import: ``import a.b as c`` gives
    (a.b, None, c), ``from a import b as c`` gives (a, b, c), a relative
    module resolved against the file's package."""
    package = path.relative_to(ROOT).parts[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, None, a.asname or a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            base = list(package[:len(package) + 1 - node.level]) \
                if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            for a in node.names:
                yield mod, a.name, a.asname or a.name


def _ops_reaching_up():
    up = tuple(f"ofdm_tpu_torch.{p}" for p in ("kernels", "phy", "parallel"))
    found = []
    for p in sorted((PORT / "ops").rglob("*.py")):
        for mod, name, _ in _imports(ast.parse(p.read_text()), p):
            full = f"{mod}.{name}" if name else mod
            if any(m == u or m.startswith(u + ".") for m in (mod, full)
                   for u in up):
                found.append((str(p.relative_to(ROOT)), full))
    return found


def _private_front_uses():
    """Underscore names of phy/rx.py or phy/front.py that a file outside
    phy/ imports, or reads off a name bound to either module."""
    hidden = ("ofdm_tpu_torch.phy.rx", "ofdm_tpu_torch.phy.front")
    found = []
    for p in sorted(PORT.rglob("*.py")):
        if PORT / "phy" in p.parents:
            continue
        tree = ast.parse(p.read_text())
        bound = set()
        for mod, name, as_ in _imports(tree, p):
            if mod in hidden and name and name.startswith("_"):
                found.append((str(p.relative_to(ROOT)), f"{mod}.{name}"))
            if (f"{mod}.{name}" if name else mod) in hidden:
                bound.add(as_)
        found += [(str(p.relative_to(ROOT)), f"{n.value.id}.{n.attr}")
                  for n in ast.walk(tree)
                  if isinstance(n, ast.Attribute) and n.attr.startswith("_")
                  and isinstance(n.value, ast.Name) and n.value.id in bound]
    return found


@pytest.mark.parametrize("rule", [_ops_reaching_up, _private_front_uses],
                         ids=["ops-below-kernels-phy-parallel",
                              "no-private-rx-or-front-outside-phy"])
def test_layering(rule):
    """The arrows between the port's layers point one way: ``ops/`` is
    below the kernels, the decoders and ``parallel/``; the front half's
    and the decoders' private helpers stay inside ``phy/``."""
    assert rule() == []


ROUND_TRIP = """
import sys
sys.modules["jax"] = None          # any attempt to import jax now fails
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
import ofdm_tpu_torch as ott
data = torch.arange(64, dtype=torch.uint8)
tx = ott.encode(data, guard_bands=True, modulation=ott.Modulation.QAM16)
assert torch.equal(ott.encode(bytes(range(64)), guard_bands=True,
                              modulation=ott.Modulation.QAM16, device="cpu"), tx)
rx = ott.channel(tx, snr=40.0, timing_error=True,
                 generator=torch.Generator().manual_seed(1))
nb = ott.n_data_blocks(64, ott.Modulation.QAM16, True)
out = ott.decode_frame(rx, n_blocks=nb, guard_bands=True,
                       modulation=ott.Modulation.QAM16)
assert torch.equal(out[16:80], data), out
for kw in (dict(align_impl="chunked"), dict(sync_dtype=torch.bfloat16),
           dict(sync_dtype="conv", derot_impl="stream")):
    assert torch.equal(ott.decode_frame(rx, n_blocks=nb, guard_bands=True,
                                        modulation=ott.Modulation.QAM16, **kw),
                       out), kw
assert bytes(ott.decode(rx, guard_bands=True,
                        modulation=ott.Modulation.QAM16)) == bytes(range(64))
from ofdm_tpu_torch.fec import interleave, reed_solomon
from ofdm_tpu_torch.phy.streaming import coded_len
user = torch.arange(96, dtype=torch.uint8).reshape(2, 48)
frames = ott.encode_hamming(user, guard_bands=True, modulation=ott.Modulation.QPSK)
stream = torch.cat([torch.zeros(300, dtype=torch.complex64), frames.reshape(-1)])
kw = dict(payload_len=coded_len(48, "hamming"), modulation=ott.Modulation.QPSK,
          fec="hamming", data_len=48)
for resync in (True, False):
    p, ok = ott.decode_regular(stream, n_frames=2, spacing=frames.shape[1],
                               resync=resync, **kw)
    assert ok.all() and (p == user.numpy()).all(), resync
burst = ott.decode_burst(stream, **kw)
assert [b[0] for b in burst] == [299, 299 + frames.shape[1]], burst
assert all((b[1] == user[i].numpy()).all() for i, b in enumerate(burst))
assert [c[0] for c in ott.decode_continuous(stream, **kw)] == [b[0] for b in burst]
assert ott.Analysis.new(p, user.numpy()).num_errs == 0
assert (interleave.deinterleave_device(interleave.interleave_device(user, 5), 5, 48)
        == user).all()
assert reed_solomon.decode_stream(reed_solomon.encode_stream(b"abc"))[1]
from ofdm_tpu_torch.core.transfer import Uploader, to_host
from ofdm_tpu_torch.io.feed import SampleFeed, double_buffered
from ofdm_tpu_torch.io.serving import serve, synth_buffers
from ofdm_tpu_torch.apps import rx_stream
bufs, pixels = synth_buffers(2, 2, device="cpu")
with SampleFeed(to_host(b) for b in bufs) as feed:
    served = list(serve(double_buffered(feed, Uploader("cpu")), 2, in_flight=1))
assert [s.index for s in served] == [0, 1]
assert all(s.ok.all() and (s.pixels == pixels[s.index]).all() for s in served)
# the application layer: every app's main, the diagnostics, the small modules
import contextlib, io, os, tempfile
from ofdm_tpu_torch.apps import (ber_sweep, datatoframe, lab3a, lab3b,
                                 lab3b_image, lab3c, lab3c_image, monitor, probe,
                                 stream_bytes, transmitloop)
from ofdm_tpu_torch.core import bitops
from ofdm_tpu_torch.obs import ber_theory, plots, profiler, taps
from ofdm_tpu_torch.ops import shift, stats
from ofdm_tpu_torch.ops.convolve import convolve_fft
from ofdm_tpu_torch.ops.xcorr import xcorr_fft
cpu = ["--device", "cpu"]
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()) as shown:
    os.chdir(tmp)
    runs = [(probe, cpu), (lab3a, ["--msg-bytes", "60", "--guard-bands", "--taps"] + cpu),
            (lab3b, ["--msg-bytes", "60", "--guard-bands", "--seed", "1"] + cpu),
            (lab3c, ["--transmit", "t.dat", "--msg-bytes", "60"] + cpu),
            (lab3c, ["--receive", "t.dat", "--msg-bytes", "60"] + cpu),
            (ber_sweep, ["--snrs", "30", "--modulations", "qpsk", "--batch", "2",
                         "--payload", "32", "--json"] + cpu),
            (ber_sweep, ["--awgn-theory", "--snrs", "8", "--modulations", "qpsk"] + cpu),
            (monitor, ["--buffers", "1", "--no-clear"] + cpu), (datatoframe, []),
            (lab3b_image, ["--snr", "28", "--seed", "3"] + cpu),
            (lab3c_image, ["--transmit", "i.dat"] + cpu),
            (lab3c_image, ["--receive", "i.dat", "--out-bytes", "i.bytes"] + cpu),
            (stream_bytes, ["--out-dir", "sb"] + cpu),
            (rx_stream, ["--files", "sb/tx_dance0.dat"] + cpu),
            (transmitloop, ["--iterations", "2", "--out", "loop.dat"] + cpu)]
    for app, args in runs:
        assert app.main(args) == 0, (app.__name__, args)
    assert len(os.listdir("data/simulated")) == 12 and not taps.enabled()
    with profiler.trace("trace"), profiler.annotate("a"), profiler.timed("t"):
        _, diag = ott.decode(rx, guard_bands=True, modulation=ott.Modulation.QAM16,
                             return_diagnostics=True)
    assert os.path.getsize("trace/trace.json") > 0 and diag["h_k"].shape == (64,)
    os.chdir("/")
assert "decode ok" in shown.getvalue() and "I met a traveller" in shown.getvalue()
bits = bitops.bytes_to_bits(data)
assert torch.equal(bitops.bits_to_bytes(bits), data)
assert int(stats.idmax(shift.fft_shift(tx))) >= 0 and ber_theory.q_func(0.0) == 0.5
assert int(xcorr_fft(tx[:80], tx[:80])[0]) == 79 and convolve_fft(tx, tx[:4].real).shape[0] == tx.shape[0] + 3
assert plots.stem_plot(tx[:64].numpy())
from ofdm_tpu_torch import bench
from ofdm_tpu_torch.core import native
assert bench.tail_percentile(100) == 90 and native.MODULES
assert not any(m == "ofdm_tpu" or m.startswith("ofdm_tpu.") for m in sys.modules)
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("ok")
"""


def test_round_trip_without_jax():
    """The library, the serve loop, every app's ``main``, the small modules
    and the bench's module run in a process where importing jax fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", ROUND_TRIP, str(ROOT)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
