"""Terminal quick-look plots: stem and constellation.

Rebuilds src/plots.rs:6-58's braille-art charts with a dependency-free
unicode renderer (2x4 braille cells) for inspecting signals and equalized
constellations from the CLI apps.
"""

from __future__ import annotations

import numpy as np

_BRAILLE_BASE = 0x2800
# braille dot bit for (row 0..3, col 0..1) within a cell
_DOT = [[0x01, 0x08], [0x02, 0x10], [0x04, 0x20], [0x40, 0x80]]


def _render(grid: np.ndarray) -> str:
    """bool[H, W] -> braille string (H, W multiples of 4, 2)."""
    h, w = grid.shape
    lines = []
    for cy in range(0, h, 4):
        line = []
        for cx in range(0, w, 2):
            code = _BRAILLE_BASE
            for dy in range(4):
                for dx in range(2):
                    if cy + dy < h and cx + dx < w and grid[cy + dy, cx + dx]:
                        code |= _DOT[dy][dx]
            line.append(chr(code))
        lines.append("".join(line))
    return "\n".join(lines)


def _cubic_spline_resample(vals: np.ndarray, n_out: int) -> np.ndarray:
    """Natural cubic spline through the samples, evaluated at n_out points
    (the reference interpolates before rendering, src/plots.rs:20-26).
    Dependency-free tridiagonal solve for the second derivatives."""
    n = len(vals)
    if n < 3 or n_out <= n:
        return vals
    # natural spline: M[0] = M[n-1] = 0; solve the tridiagonal system for
    # the interior second derivatives (unit knot spacing)
    m = np.zeros(n)
    if n > 2:
        rhs = 6.0 * (vals[2:] - 2.0 * vals[1:-1] + vals[:-2])
        diag = np.full(n - 2, 4.0)
        c = np.ones(n - 3)
        # Thomas algorithm
        for i in range(1, n - 2):
            w = 1.0 / diag[i - 1]
            diag[i] -= w * c[i - 1]
            rhs[i] -= w * rhs[i - 1]
        sol = np.zeros(n - 2)
        sol[-1] = rhs[-1] / diag[-1]
        for i in range(n - 4, -1, -1):
            sol[i] = (rhs[i] - c[i] * sol[i + 1]) / diag[i]
        m[1:-1] = sol
    t = np.linspace(0, n - 1, n_out)
    k = np.clip(t.astype(int), 0, n - 2)
    u = t - k
    return ((1 - u) * vals[k] + u * vals[k + 1]
            - u * (1 - u) * ((2 - u) * m[k] + (1 + u) * m[k + 1]) / 6.0)


def stem_plot(signal, width: int = 120, height: int = 40,
              smooth: bool = False) -> str:
    """Real-part stem plot of a complex signal (src/plots.rs:6-30).

    ``smooth=True`` resamples through a natural cubic spline at one point
    per output column before rendering, like the reference's
    cubic_spline interpolation (src/plots.rs:20-26)."""
    vals = np.real(np.asarray(signal)).astype(np.float64)
    if smooth and len(vals) > 2:
        vals = _cubic_spline_resample(vals, width)
    n = len(vals)
    lo, hi = float(vals.min()), float(vals.max())
    if hi == lo:
        hi = lo + 1.0
    grid = np.zeros((height, width), dtype=bool)
    xs = np.minimum((np.arange(n) * width // max(n, 1)), width - 1)
    ys = ((hi - vals) / (hi - lo) * (height - 1)).astype(int).clip(0, height - 1)
    zero_y = int((hi - 0.0) / (hi - lo) * (height - 1)) if lo <= 0 <= hi else height - 1
    zero_y = min(max(zero_y, 0), height - 1)
    for x, y in zip(xs, ys):
        a, b = sorted((y, zero_y))
        grid[a:b + 1, x] = True
    return _render(grid)


def constellation(signal, width: int = 80, height: int = 40, lim: float | None = None) -> str:
    """IQ scatter plot (src/plots.rs:32-58)."""
    arr = np.asarray(signal)
    re, im = np.real(arr), np.imag(arr)
    if lim is None:
        lim = max(float(np.abs(re).max()), float(np.abs(im).max()), 1e-9) * 1.1
    grid = np.zeros((height, width), dtype=bool)
    xs = ((re / lim + 1) / 2 * (width - 1)).astype(int).clip(0, width - 1)
    ys = ((1 - im / lim) / 2 * (height - 1)).astype(int).clip(0, height - 1)
    grid[ys, xs] = True
    return _render(grid)
