"""1-D interpolation primitives for the fish kinematics (host, NumPy).

The port's own copy of ``cup3d_tpu/models/fish/interpolation.py`` (numpy,
float64 on the host; no torch needed).

Reference: Interpolation1D (main.cpp:7732-7804) -- natural cubic spline and
a two-point cubic Hermite that also returns the derivative.  Vectorized over
evaluation points instead of the reference's per-point binary search.
"""

from __future__ import annotations

import numpy as np


def natural_cubic_spline(x: np.ndarray, y: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Natural cubic spline through (x, y), evaluated at xq.

    Natural BCs: second derivative zero at both ends
    (main.cpp:7739-7770 semantics).  Query points are clamped to [x0, xn]
    segments but extrapolate with the end cubics, as the reference does.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    # tridiagonal solve for second derivatives y2 (Thomas algorithm)
    y2 = np.zeros(n)
    u = np.zeros(n)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        du = (y[i + 1] - y[i]) / (x[i + 1] - x[i]) - (y[i] - y[i - 1]) / (
            x[i] - x[i - 1]
        )
        u[i] = (6.0 * du / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    for k in range(n - 2, 0, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]

    xq = np.asarray(xq, dtype=np.float64)
    klo = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, n - 2)
    khi = klo + 1
    h = x[khi] - x[klo]
    a = (x[khi] - xq) / h
    b = (xq - x[klo]) / h
    return (
        a * y[klo]
        + b * y[khi]
        + ((a**3 - a) * y2[klo] + (b**3 - b) * y2[khi]) * (h * h) / 6.0
    )


def cubic_hermite(x0, x1, x, y0, y1, dy0=0.0, dy1=0.0):
    """Cubic with endpoint values/derivatives; returns (y, dy/dx).

    Matches Interpolation1D::cubicInterpolation (main.cpp:7780-7795);
    vectorized in any of the arguments.
    """
    xr = np.asarray(x) - x0
    dx = x1 - x0
    a = (dy0 + dy1) / (dx * dx) - 2.0 * (y1 - y0) / (dx * dx * dx)
    b = (-2.0 * dy0 - dy1) / dx + 3.0 * (y1 - y0) / (dx * dx)
    c = dy0
    d = y0
    y = a * xr**3 + b * xr**2 + c * xr + d
    dy = 3.0 * a * xr**2 + 2.0 * b * xr + c
    return y, dy
