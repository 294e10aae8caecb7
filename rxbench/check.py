"""The comparison that decides ``correct``.

Every sampled answer of a window (``cell.Window.answers``) is compared,
byte for byte, with the plain receiver's answer to the same input,
computed in float64 once the window has closed.  The number compared,
``byte_mismatch_ppm``, is the most wrong bytes in any one answer per
million bytes of that answer; an answer of another shape is wrong in
every byte.  Its limit comes from ``limits/<cell>.json``, which records
the readings it was set from.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBER = "byte_mismatch_ppm"


def mismatch_ppm(answer, expected: np.ndarray) -> float:
    a = np.asarray(answer)
    if a.shape != expected.shape:
        return 1e6
    return 1e6 * int((a != expected).sum()) / expected.size


def worst(cell, answers: list, dtype: torch.dtype = torch.float64,
          expected: dict | None = None) -> float:
    """The largest ``mismatch_ppm`` of the answers against
    ``cell.reference``; ``expected`` caches the reference's answers by
    input."""
    expected = {} if expected is None else expected
    out = 0.0
    for i, a in answers:
        if i not in expected:
            expected[i] = cell.reference(i, dtype).cpu().numpy()
        out = max(out, mismatch_ppm(a, expected[i]))
    return out


def judge(value: float, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}})."""
    limit = limits[NUMBER]["limit"]
    return value <= limit, {NUMBER: {"value": value, "limit": limit}}
