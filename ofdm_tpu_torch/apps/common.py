"""What the apps share: the ``--device`` flag, full-fp32 set-up on CUDA and
the seeded default images.

The JAX package's apps default to image and GIF files of the reference
checkout; the port's default to id images made from a fixed seed, so every
app runs from a bare checkout and needs Pillow only to read a GIF or write a
PNG.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from ..core import device as device_mod
from ..ops.fft import set_full_fp32

IMAGE_SEED = 0
DEFAULT_FRAMES = 8


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the signal processing runs: cuda (default) or "
                        "cpu; cuda raises on a host without a card")


def resolve_device(name: str) -> torch.device:
    """``--device`` as a torch.device (raises where it asks for an absent
    card); on CUDA, TF32 is turned off, as the decoder requires."""
    dev = device_mod.resolve(name)
    if dev.type == "cuda":
        set_full_fp32()
    return dev


def seeded_image(width: int, height: int, seed: int = IMAGE_SEED) -> np.ndarray:
    """A ``width`` x ``height`` image of xterm-256 colour ids, uint8 [w*h]."""
    return np.random.default_rng(seed).integers(0, 256, width * height,
                                                dtype=np.uint8)


def load_image(path: str | None, width: int, height: int) -> np.ndarray:
    """The colourspace bytes of ``path``, or the seeded image without one."""
    if path:
        return np.frombuffer(pathlib.Path(path).read_bytes(), np.uint8)
    return seeded_image(width, height)


def load_frames(gif: str | None, width: int = 24, height: int = 24):
    """((width, height), frames): the GIF's frames as colour ids (needs
    Pillow), or ``DEFAULT_FRAMES`` seeded id images without one."""
    if gif:
        from ..packets.gif import gif_to_bytestream
        return gif_to_bytestream(pathlib.Path(gif).read_bytes())
    return (width, height), [seeded_image(width, height, IMAGE_SEED + i)
                             for i in range(DEFAULT_FRAMES)]
