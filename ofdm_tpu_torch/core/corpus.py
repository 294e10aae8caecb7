"""Test-payload helpers: the Ozymandias corpus + FEC-framed transmissions.

Rebuilds ``create_transmission_text``/``decipher_transmission_text`` and
friends (src/utils.rs:71-205): cyclic text corpus, optional Reed-Solomon
framing, and colorspace deciphering for image payloads.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..fec import reed_solomon as rs
from ..packets import colors

CORPUS = """
I met a traveller from an antique land,
Who said—“Two vast and trunkless legs of stone
Stand in the desert. . . . Near them, on the sand,
Half sunk a shattered visage lies, whose frown,
And wrinkled lip, and sneer of cold command,
Tell that its sculptor well those passions read
Which yet survive, stamped on these lifeless things,
The hand that mocked them, and the heart that fed;
And on the pedestal, these words appear:
My name is Ozymandias, King of Kings;
Look on my Works, ye Mighty, and despair!
Nothing beside remains. Round the decay
Of that colossal Wreck, boundless and bare
The lone and level sands stretch far away.
"""


def create_transmission_text(msg_bytes: int, ecc: bool) -> np.ndarray:
    """Cyclic corpus of ``msg_bytes`` bytes, optionally RS(255,223)-framed
    (src/utils.rs:88-95)."""
    body = bytes(itertools.islice(itertools.cycle(CORPUS.encode()), msg_bytes))
    if not ecc:
        return np.frombuffer(body, np.uint8)
    return rs.encode_stream(body)


def decipher_transmission_text(num_bytes: int, data, ecc: bool) -> str | None:
    """Inverse of create_transmission_text (src/utils.rs:139-150)."""
    arr = np.asarray(data, dtype=np.uint8)
    if ecc:
        arr, ok = rs.decode_stream(arr)
        if not ok:
            return None
    try:
        return arr[:num_bytes].tobytes().decode("utf-8")
    except UnicodeDecodeError:
        return None


def decipher_transmission_colorspace(data, ecc: bool) -> np.ndarray | None:
    """Payload bytes -> packed 0xRRGGBB u32 pixels (src/utils.rs:182-205)."""
    arr = np.asarray(data, dtype=np.uint8)
    if ecc:
        arr, ok = rs.decode_stream(arr)
        if not ok:
            return None
    return colors.id_to_u32(arr)
