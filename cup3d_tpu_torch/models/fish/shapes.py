"""Width/height profiles of the fish cross-sections.

The port's own copy of ``cup3d_tpu/models/fish/shapes.py`` (numpy,
float64 on the host; no torch needed).

Reference: MidlineShapes (main.cpp:11927-12198).  Profiles are functions of
arc length s in [0, L] giving the half-width (along the normal) and
half-height (along the binormal) of the elliptical cross-section:

- analytic piecewise profiles: ``stefan``, ``larval``, ``danio``, ``nacaNN``;
- B-spline control-polygon profiles: ``baseline`` (default), ``fatter``,
  ``largefin``, ``tunaclone`` -- a parametric cubic B-spline (x(t), y(t))
  through control points, evaluated at x = s.  The reference uses GSL's
  uniform-knot cubic bspline (integrateBSpline, main.cpp:11927-11964); here
  the same clamped-uniform-knot basis is built with a vectorized Cox-de Boor
  recursion and the curve is sampled densely then inverted with interp.
"""

from __future__ import annotations

import numpy as np


def _bspline_basis(t, knots, order):
    """Cox-de Boor: basis values for all n functions at points t.

    Returns (len(t), n) with n = len(knots) - order.
    """
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    n = len(knots) - order
    # degree-0: indicator of [knots[j], knots[j+1]) (last interval closed)
    b = np.zeros((len(t), len(knots) - 1))
    for j in range(len(knots) - 1):
        if knots[j + 1] > knots[j]:
            b[:, j] = (t >= knots[j]) & (t < knots[j + 1])
    b[t >= knots[-1] - 1e-14, np.max(np.nonzero(np.diff(knots))[0])] = 1.0
    for k in range(1, order):
        nb = np.zeros((len(t), len(knots) - 1 - k))
        for j in range(len(knots) - 1 - k):
            d1 = knots[j + k] - knots[j]
            d2 = knots[j + k + 1] - knots[j + 1]
            term = 0.0
            if d1 > 0:
                term = (t - knots[j]) / d1 * b[:, j]
            if d2 > 0:
                term = term + (knots[j + k + 1] - t) / d2 * b[:, j + 1]
            nb[:, j] = term
        b = nb
    return b[:, :n]


def bspline_profile(xc, yc, length, rs, nsamples=4096):
    """Parametric clamped-uniform cubic B-spline through control points
    (xc, yc); returns profile(s) = y at x = s, 0 outside (0, L)."""
    xc = np.asarray(xc, dtype=np.float64)
    yc = np.asarray(yc, dtype=np.float64)
    n = len(xc)
    # chord length parameterization bound, as the reference (11932-11935)
    clen = float(np.sum(np.hypot(np.diff(xc), np.diff(yc))))
    # GSL: order 4, nbreak = n-2 uniform breakpoints -> clamped knots
    order = 4
    interior = np.linspace(0.0, clen, n - 2)
    knots = np.concatenate([[0.0] * (order - 1), interior, [clen] * (order - 1)])
    t = np.linspace(0.0, clen, nsamples)
    basis = _bspline_basis(t, knots, order)
    xs = basis @ xc
    ys = basis @ yc
    # x(t) is monotone for these control polygons; invert by interpolation
    order_idx = np.argsort(xs)
    xs, ys = xs[order_idx], ys[order_idx]
    res = np.interp(rs, xs, ys)
    res = np.where((rs > 0) & (rs < length), res, 0.0)
    return res


def naca_width(t_ratio, length, rs):
    """Symmetric 4-digit NACA half-thickness (main.cpp:11965-11983)."""
    a, b, c, d, e = 0.2969, -0.1260, -0.3516, 0.2843, -0.1015
    t = t_ratio * length
    p = np.clip(rs / length, 0.0, 1.0)
    w = 5 * t * (a * np.sqrt(p) + b * p + c * p**2 + d * p**3 + e * p**4)
    return np.where((rs > 0) & (rs < length), w, 0.0)


def stefan_width(length, rs):
    """(main.cpp:11984-12001)"""
    L = length
    sb, st, wt, wh = 0.04 * L, 0.95 * L, 0.01 * L, 0.04 * L
    s = rs
    w = np.where(
        s < sb,
        np.sqrt(np.maximum(2.0 * wh * s - s * s, 0.0)),
        np.where(
            s < st,
            wh - (wh - wt) * ((s - sb) / (st - sb)) ** 2,
            wt * (L - s) / (L - st),
        ),
    )
    return np.where((rs > 0) & (rs < length), w, 0.0)


def stefan_height(length, rs):
    """(main.cpp:12002-12014)"""
    L = length
    a, b = 0.51 * L, 0.08 * L
    w = b * np.sqrt(np.maximum(1.0 - ((rs - a) / a) ** 2, 0.0))
    return np.where((rs > 0) & (rs < length), w, 0.0)


def larval_width(length, rs):
    """(main.cpp:12015-12036)"""
    L = length
    sb, st = 0.0862 * L, 0.3448 * L
    wh, wt = 0.0635 * L, 0.0254 * L
    s = rs
    x = (s - sb) / (st - sb)
    w = np.where(
        s < sb,
        wh * np.sqrt(np.maximum(1.0 - ((sb - s) / sb) ** 2, 0.0)),
        np.where(
            s < st,
            (-2 * (wt - wh) - wt * (st - sb)) * x**3
            + (3 * (wt - wh) + wt * (st - sb)) * x**2
            + wh,
            wt - wt * (s - st) / (L - st),
        ),
    )
    return np.where((rs > 0) & (rs < length), w, 0.0)


def larval_height(length, rs):
    """(main.cpp:12037-12070)"""
    L = length
    s1, h1 = 0.287 * L, 0.072 * L
    s2, h2 = 0.844 * L, 0.041 * L
    s3, h3 = 0.957 * L, 0.071 * L
    s = rs
    x12 = (s - s1) / (s2 - s1)
    x23 = (s - s2) / (s3 - s2)
    w = np.where(
        s < s1,
        h1 * np.sqrt(np.maximum(1.0 - ((s - s1) / s1) ** 2, 0.0)),
        np.where(
            s < s2,
            -2 * (h2 - h1) * x12**3 + 3 * (h2 - h1) * x12**2 + h1,
            np.where(
                s < s3,
                -2 * (h3 - h2) * x23**3 + 3 * (h3 - h2) * x23**2 + h2,
                h3 * np.sqrt(np.maximum(1.0 - ((s - s3) / (L - s3)) ** 3, 0.0)),
            ),
        ),
    )
    return np.where((rs > 0) & (rs < length), w, 0.0)


def _piecewise_cubic(breaks, coeffs, length, rs):
    """Zebrafish-measurement piecewise cubics in normalized s (danio_*)."""
    sn = np.clip(rs / length, 0.0, 1.0)
    seg = np.clip(np.searchsorted(breaks, sn, side="right") - 1, 0,
                  len(breaks) - 2)
    c = np.asarray(coeffs)[seg]
    xx = sn - np.asarray(breaks)[seg]
    w = length * (c[:, 0] + c[:, 1] * xx + c[:, 2] * xx**2 + c[:, 3] * xx**3)
    return np.where((rs > 0) & (rs < length), w, 0.0)


# measured zebrafish geometry tables (main.cpp:12071-12135)
_DANIO_W_BREAKS = [0, 0.005, 0.01, 0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 0.95, 1.0]
_DANIO_W_COEFFS = [
    [0.0015713, 2.6439, 0, -15410],
    [0.012865, 1.4882, -231.15, 15598],
    [0.016476, 0.34647, 2.8156, -39.328],
    [0.032323, 0.38294, -1.9038, 0.7411],
    [0.046803, 0.19812, -1.7926, 5.4876],
    [0.054176, 0.0042136, -0.14638, 0.077447],
    [0.049783, -0.045043, -0.099907, -0.12599],
    [0.03577, -0.10012, -0.1755, 0.62019],
    [0.013687, -0.0959, 0.19662, 0.82341],
    [0.0065049, 0.018665, 0.56715, -3.781],
]
_DANIO_H_BREAKS = [0, 0.01, 0.05, 0.1, 0.3, 0.5, 0.7, 0.8, 0.85, 0.87, 0.9,
                   0.993, 0.996, 0.998, 1]
_DANIO_H_COEFFS = [
    [0.0011746, 1.345, 2.2204e-14, -578.62],
    [0.014046, 1.1715, -17.359, 128.6],
    [0.041361, 0.40004, -1.9268, 9.7029],
    [0.057759, 0.28013, -0.47141, -0.08102],
    [0.094281, 0.081843, -0.52002, -0.76511],
    [0.083728, -0.21798, -0.97909, 3.9699],
    [0.032727, -0.13323, 1.4028, 2.5693],
    [0.036002, 0.22441, 2.1736, -13.194],
    [0.051007, 0.34282, 0.19446, 16.642],
    [0.058075, 0.37057, 1.193, -17.944],
    [0.069781, 0.3937, -0.42196, -29.388],
    [0.079107, -0.44731, -8.6211, -1.8283e5],
    [0.072751, -5.4355, -1654.1, -2.9121e5],
    [0.052934, -15.546, -3401.4, 5.6689e5],
]


def danio_width(length, rs):
    return _piecewise_cubic(_DANIO_W_BREAKS, _DANIO_W_COEFFS, length, rs)


def danio_height(length, rs):
    return _piecewise_cubic(_DANIO_H_BREAKS, _DANIO_H_COEFFS, length, rs)


def compute_widths_heights(height_name: str, width_name: str, length, rs):
    """Dispatcher (computeWidthsHeights, main.cpp:12136-12198).

    Returns (height, width) on the rs grid.
    """
    L = length

    def height_of(name):
        if name == "largefin":
            xh = np.array([0, 0, 0.2, 0.4, 0.6, 0.8, 1.0, 1.0]) * L
            yh = np.array([0, 0.055, 0.18, 0.2, 0.064, 0.002, 0.325, 0]) * L
            return bspline_profile(xh, yh, L, rs)
        if name == "tunaclone":
            xh = np.array([0, 0, 0.2, 0.4, 0.6, 0.9, 0.96, 1.0, 1.0]) * L
            yh = np.array([0, 0.05, 0.14, 0.15, 0.11, 0, 0.1, 0.2, 0]) * L
            return bspline_profile(xh, yh, L, rs)
        if name.startswith("naca"):
            return naca_width(int(name[4:]) * 0.01, L, rs)
        if name == "danio":
            return danio_height(L, rs)
        if name == "stefan":
            return stefan_height(L, rs)
        if name == "larval":
            return larval_height(L, rs)
        # baseline height control polygon (main.cpp:12167-12172)
        xh = np.array([0, 0, 0.2, 0.4, 0.6, 0.8, 1.0, 1.0]) * L
        yh = np.array([0, 0.055, 0.068, 0.076, 0.064, 0.0072, 0.11, 0]) * L
        return bspline_profile(xh, yh, L, rs)

    def width_of(name):
        if name == "fatter":
            xw = np.array([0, 0, 1 / 3, 2 / 3, 1.0, 1.0]) * L
            yw = np.array([0, 8.9e-2, 7.0e-2, 3.0e-2, 2.0e-2, 0]) * L
            return bspline_profile(xw, yw, L, rs)
        if name.startswith("naca"):
            return naca_width(int(name[4:]) * 0.01, L, rs)
        if name == "danio":
            return danio_width(L, rs)
        if name == "stefan":
            return stefan_width(L, rs)
        if name == "larval":
            return larval_width(L, rs)
        # baseline width control polygon (main.cpp:12188-12193)
        xw = np.array([0, 0, 1 / 3, 2 / 3, 1.0, 1.0]) * L
        yw = np.array([0, 8.9e-2, 1.7e-2, 1.6e-2, 1.3e-2, 0]) * L
        return bspline_profile(xw, yw, L, rs)

    return height_of(height_name), width_of(width_name)
