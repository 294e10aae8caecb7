"""GIF -> radio-colorspace byte streams ("video over radio" source material).

Rebuilds ``gif_to_bytestream`` (src/packets/mod.rs:67-95): decode GIF frames,
quantize each RGBA pixel to the nearest xterm-256 palette entry, emit one byte
per pixel per frame.  Uses Pillow instead of the Rust ``image`` crate; the
nearest-color step is the vectorized quantizer in :mod:`.colors`.
"""

from __future__ import annotations

import numpy as np

from .colors import id_to_rgb, nearest_id


def gif_to_bytestream(path_or_bytes) -> tuple[tuple[int, int], list[np.ndarray]]:
    """Returns ((width, height), [uint8[w*h] per frame])."""
    import io

    from PIL import Image

    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) \
        else path_or_bytes
    im = Image.open(src)
    dims = im.size
    frames = []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        rgba = np.asarray(im.convert("RGBA"))
        frames.append(nearest_id(rgba[..., :3]).reshape(-1))
    return dims, frames


def bytestream_to_rgb(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8[w*h] color ids -> uint8[h, w, 3] image."""
    return id_to_rgb(np.asarray(frame, dtype=np.uint8)).reshape(height, width, 3)
