"""Frenet frame integration: midline curve from curvature + torsion.

The port's own copy of ``cup3d_tpu/models/fish/frenet.py`` (numpy,
float64 on the host; no torch needed).

Reference: Frenet3D::solve (main.cpp:7618-7731) -- forward-Euler integration
of the Frenet-Serret ODEs along the arc-length grid, carrying both the frame
(tangent ksi, normal, binormal) and its time derivative, renormalizing each
step.  The midline starts at the origin pointing +x with normal +y.

This is a short sequential recurrence over ~10^2 points; it stays host-side
NumPy (a lax.scan would gain nothing at this size and cost a compile).
"""

from __future__ import annotations

import numpy as np


def frenet_solve(rs, curv, curv_dt, tors, tors_dt):
    """Integrate the midline and its velocity from curvature/torsion.

    Args: all (Nm,) float64.
    Returns dict of (Nm,3) arrays: r, v, nor, vnor, bin, vbin.
    """
    nm = len(rs)
    r = np.zeros((nm, 3))
    v = np.zeros((nm, 3))
    nor = np.zeros((nm, 3))
    vnor = np.zeros((nm, 3))
    bin_ = np.zeros((nm, 3))
    vbin = np.zeros((nm, 3))

    ksi = np.array([1.0, 0.0, 0.0])
    vksi = np.zeros(3)
    nor[0] = (0.0, 1.0, 0.0)
    bin_[0] = (0.0, 0.0, 1.0)
    eps = np.finfo(np.float64).eps

    for i in range(1, nm):
        k, dk = curv[i - 1], curv_dt[i - 1]
        tau, dtau = tors[i - 1], tors_dt[i - 1]
        n0, b0, vn0, vb0 = nor[i - 1], bin_[i - 1], vnor[i - 1], vbin[i - 1]
        dksi = k * n0
        dnu = -k * ksi + tau * b0
        dbin = -tau * n0
        dvksi = dk * n0 + k * vn0
        dvnu = -dk * ksi - k * vksi + dtau * b0 + tau * vb0
        dvbin = -dtau * n0 - tau * vn0
        ds = rs[i] - rs[i - 1]
        r[i] = r[i - 1] + ds * ksi
        nor[i] = n0 + ds * dnu
        ksi = ksi + ds * dksi
        bin_[i] = b0 + ds * dbin
        v[i] = v[i - 1] + ds * vksi
        vnor[i] = vn0 + ds * dvnu
        vksi = vksi + ds * dvksi
        vbin[i] = vb0 + ds * dvbin
        for vec in (ksi, nor[i], bin_[i]):
            d = vec @ vec
            if d > eps:
                vec *= 1.0 / np.sqrt(d)

    return {"r": r, "v": v, "nor": nor, "vnor": vnor, "bin": bin_, "vbin": vbin}
