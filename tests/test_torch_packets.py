"""The port's numpy-only modules (``obs/logging.py``, ``packets/colors.py``,
``packets/compression.py``, ``packets/gif.py``, ``core/corpus.py``) are
byte-for-byte copies of ofdm_tpu's, and give its values on random input.
The corpus copy resolves its imports to the port's RS codec and colorspace.
"""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdm_tpu.core import corpus as jcorpus
from ofdm_tpu.obs import logging as jlogging
from ofdm_tpu.packets import colors as jcolors
from ofdm_tpu.packets import compression as jcompression
from ofdm_tpu.packets import gif as jgif
from ofdm_tpu_torch.core import corpus
from ofdm_tpu_torch.fec import reed_solomon
from ofdm_tpu_torch.obs import logging as tlogging
from ofdm_tpu_torch.packets import colors, compression, gif

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
COPIES = ["obs/logging.py", "packets/colors.py", "packets/compression.py",
          "packets/gif.py", "core/corpus.py"]


@pytest.mark.parametrize("module", COPIES)
def test_copies_are_byte_equal(module):
    assert (ROOT / "ofdm_tpu_torch" / module).read_bytes() == \
        (ROOT / "ofdm_tpu" / module).read_bytes()


def test_corpus_uses_the_ports_modules():
    assert corpus.rs is reed_solomon
    assert corpus.colors is colors


def test_palette_and_ids():
    np.testing.assert_array_equal(colors.palette(), jcolors.palette())
    ids = np.random.default_rng(0).integers(0, 256, (7, 9), dtype=np.uint8)
    np.testing.assert_array_equal(colors.id_to_rgb(ids), jcolors.id_to_rgb(ids))
    np.testing.assert_array_equal(colors.id_to_u32(ids), jcolors.id_to_u32(ids))


def test_nearest_id():
    rgb = np.random.default_rng(1).integers(0, 256, (5, 11, 3), dtype=np.uint8)
    got = colors.nearest_id(rgb)
    np.testing.assert_array_equal(got, jcolors.nearest_id(rgb))
    # every palette colour maps to an id of that colour
    pal = colors.palette()
    np.testing.assert_array_equal(pal[colors.nearest_id(pal)], pal)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_compression(level):
    data = np.random.default_rng(2).integers(0, 8, 4000, dtype=np.uint8)
    packed = compression.compress(data, level)
    np.testing.assert_array_equal(packed, jcompression.compress(data, level))
    np.testing.assert_array_equal(compression.decompress(packed), data)
    np.testing.assert_array_equal(compression.decompress(bytes(packed)),
                                  jcompression.decompress(bytes(packed)))


def _gif_bytes() -> bytes:
    """A 3-frame 8 x 6 GIF, made in memory from a seed."""
    import io

    from PIL import Image
    rng = np.random.default_rng(3)
    frames = [Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8),
                              "RGB") for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:])
    return buf.getvalue()


def test_gif_to_bytestream():
    pytest.importorskip("PIL")
    raw = _gif_bytes()
    dims, frames = gif.gif_to_bytestream(raw)
    jdims, jframes = jgif.gif_to_bytestream(raw)
    assert dims == jdims == (8, 6)
    assert len(frames) == len(jframes) == 3
    for f, jf in zip(frames, jframes):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(gif.bytestream_to_rgb(f, 8, 6),
                                      jgif.bytestream_to_rgb(jf, 8, 6))


@pytest.mark.parametrize("ecc", [False, True])
def test_transmission_text(ecc):
    got = corpus.create_transmission_text(700, ecc)
    np.testing.assert_array_equal(got, jcorpus.create_transmission_text(700, ecc))
    text = corpus.decipher_transmission_text(700, got, ecc)
    assert text == jcorpus.decipher_transmission_text(700, got, ecc)
    assert text.startswith("\nI met a traveller")


@pytest.mark.parametrize("ecc", [False, True])
def test_transmission_colorspace(ecc):
    ids = np.random.default_rng(4).integers(0, 256, 576, dtype=np.uint8)
    data = reed_solomon.encode_stream(ids) if ecc else ids
    got = corpus.decipher_transmission_colorspace(data, ecc)
    np.testing.assert_array_equal(
        got, jcorpus.decipher_transmission_colorspace(data, ecc))
    np.testing.assert_array_equal(got[:576], colors.id_to_u32(ids))


def test_colorspace_uncorrectable_is_none():
    data = reed_solomon.encode_stream(np.zeros(100, np.uint8))
    data[:40] ^= 0xFF                       # 40 byte errors > 16 correctable
    assert corpus.decipher_transmission_colorspace(data, True) is None
    assert jcorpus.decipher_transmission_colorspace(data, True) is None


def test_logging_format():
    record = logging.LogRecord("rx_stream", logging.WARNING, __file__, 1,
                               "buffer %d skipped", (3,), None)
    record.created, record.msecs = 0.0, 0.25
    got = tlogging._ColorFormatter().format(record)
    assert got == jlogging._ColorFormatter().format(record)
    assert got.endswith("[rx_stream][WARNING]\x1b[0m buffer 3 skipped")


def test_set_up_logging():
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        log = tlogging.set_up_logging("rx_test")
        assert log.name == "rx_test" and log.level == logging.DEBUG
        assert len(root.handlers) == 1
        assert isinstance(root.handlers[0].formatter, tlogging._ColorFormatter)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
