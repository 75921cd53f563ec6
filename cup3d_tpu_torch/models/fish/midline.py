"""FishMidlineData: the discretized deforming midline (host, NumPy).

The port's own copy of ``cup3d_tpu/models/fish/midline.py`` (numpy,
float64 on the host; no torch needed).

Reference: FishMidlineData (main.cpp:8005-8194) + momentum-removal integrals
(main.cpp:10961-11219).  Holds the arc-length grid rS (refined near nose and
tail), the Frenet frame r/nor/bin with time derivatives, and the cross-
section width/height profiles.  After each ``compute_midline`` the midline is
shifted/rotated so its *deformation* carries zero linear and angular momentum
-- the body-frame correction that makes swimming forces come out of the
fluid coupling, not the prescribed kinematics.
"""

from __future__ import annotations

import numpy as np


def _d_ds(rs: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """One-sided ends, averaged-slope interior derivative d(vals)/ds
    (main.cpp:8050-8059); vals is (Nm,) or (Nm, 3)."""
    out = np.empty_like(vals)
    ds = np.diff(rs)
    if vals.ndim == 2:
        ds = ds[:, None]
    fwd = (vals[1:] - vals[:-1]) / ds
    out[0] = fwd[0]
    out[-1] = fwd[-1]
    out[1:-1] = 0.5 * (fwd[1:] + fwd[:-1])
    return out


def midline_arc_grid(length: float, h: float):
    """Arc-length grid with refined ends (ctor, main.cpp:8078-8091).

    10% of the length at each end uses spacing ramping from 0.125h to
    h/sqrt(3); the middle 80% is uniform at h/sqrt(3).
    """
    frac_refined = 0.1
    frac_mid = 1.0 - 2 * frac_refined
    ds_mid_tgt = h / np.sqrt(3.0)
    ds_refine_tgt = 0.125 * h
    nmid = int(np.ceil(length * frac_mid / ds_mid_tgt / 8)) * 8
    ds_mid = length * frac_mid / nmid
    nend = int(np.ceil(frac_refined * length * 2 / (ds_mid + ds_refine_tgt) / 4)) * 4
    ds_ref = frac_refined * length * 2 / nend - ds_mid
    nm = nmid + 2 * nend + 1

    # guard for very coarse h, where the reference formula degenerates to
    # ds_ref <= 0 (duplicate points): keep a strictly positive ramp start
    ds_ref = max(ds_ref, 0.25 * ds_refine_tgt)

    rs = np.zeros(nm)
    k = 0
    for i in range(nend):
        rs[k + 1] = rs[k] + ds_ref + (ds_mid - ds_ref) * i / (nend - 1.0)
        k += 1
    for _ in range(nmid):
        rs[k + 1] = rs[k] + ds_mid
        k += 1
    for i in range(nend):
        rs[k + 1] = rs[k] + ds_ref + (ds_mid - ds_ref) * (nend - i - 1) / (nend - 1.0)
        k += 1
    # normalize so the midline spans exactly [0, L] and stays strictly
    # monotone even after the ds_ref guard
    rs *= length / rs[k]
    return rs


class FishMidlineData:
    """Midline state: geometry r, velocity v, frames nor/bin + derivatives,
    profiles width/height, internal-rotation quaternion."""

    def __init__(self, length, Tperiod, phase_shift, h, amplitude_factor=1.0):
        self.length = float(length)
        self.Tperiod = float(Tperiod)
        self.phaseShift = float(phase_shift)
        self.h = float(h)
        self.amplitudeFactor = float(amplitude_factor)
        self.waveLength = 1.0

        self.rS = midline_arc_grid(length, h)
        self.Nm = len(self.rS)
        z3 = lambda: np.zeros((self.Nm, 3))
        self.r, self.v = z3(), z3()
        self.nor, self.vnor = z3(), z3()
        self.bin, self.vbin = z3(), z3()
        self.width = np.zeros(self.Nm)
        self.height = np.zeros(self.Nm)
        # body-frame correction state (main.cpp:8045-8046)
        self.quaternion_internal = np.array([1.0, 0.0, 0.0, 0.0])
        self.angvel_internal = np.zeros(3)
        # 3 sensor points: nose, upper, lower (main.cpp:8044, filled by
        # the rasterizer in the reference, by StefanFish here)
        self.sensorLocation = np.zeros(9)

    def compute_midline(self, t: float, dt: float) -> None:
        raise NotImplementedError

    # -- deformation-momentum removal -------------------------------------

    def _section_integrals(self):
        """Common factors of the elliptic-section volume integrals.

        A cross-section at arc position s is an ellipse with semi-axes
        width (along nor) and height (along bin); the volume element
        follows the reference's first-order expansion in the frame
        derivatives (main.cpp:10961-10995).
        Returns (ds, cR, cN, cB, m00, m11, m22): trapezoid arc weights, the
        volume-normal (nor x bin) projected onto d(r,nor,bin)/ds, and the
        elliptic-section moments w*H, w^3*H/4, w*H^3/4.
        """
        rs = self.rS
        ds = np.empty(self.Nm)
        ds[0] = 0.5 * (rs[1] - rs[0])
        ds[-1] = 0.5 * (rs[-1] - rs[-2])
        ds[1:-1] = 0.5 * (rs[2:] - rs[:-2])
        c = np.cross(self.nor, self.bin)
        drds = _d_ds(rs, self.r)
        dnds = _d_ds(rs, self.nor)
        dbds = _d_ds(rs, self.bin)
        w, H = self.width, self.height
        m00 = w * H
        m11 = 0.25 * w**3 * H
        m22 = 0.25 * w * H**3
        cR = np.einsum("ij,ij->i", c, drds)
        cN = np.einsum("ij,ij->i", c, dnds)
        cB = np.einsum("ij,ij->i", c, dbds)
        return ds, cR, cN, cB, m00, m11, m22

    def integrate_linear_momentum(self) -> None:
        """Shift r and v so the deforming body has zero net volume-weighted
        position and linear momentum (main.cpp:10961-11012)."""
        ds, cR, cN, cB, m00, m11, m22 = self._section_integrals()
        aux1 = m00 * cR * ds
        aux2 = m11 * cN * ds
        aux3 = m22 * cB * ds
        vol = np.sum(aux1) * np.pi
        cm = (
            np.einsum("i,ij->j", aux1, self.r)
            + np.einsum("i,ij->j", aux2, self.nor)
            + np.einsum("i,ij->j", aux3, self.bin)
        ) * np.pi / vol
        lm = (
            np.einsum("i,ij->j", aux1, self.v)
            + np.einsum("i,ij->j", aux2, self.vnor)
            + np.einsum("i,ij->j", aux3, self.vbin)
        ) * np.pi / vol
        self.r -= cm
        self.v -= lm

    def integrate_angular_momentum(self, dt: float) -> None:
        """Solve J w = L for the deformation's angular velocity, rotate the
        whole midline by the accumulated internal quaternion, and add the
        -w x r counter-rotation to v (main.cpp:11013-11219)."""
        ds, cR, cN, cB, m00, m11, m22 = self._section_integrals()

        def moment2(a, an, ab_, b, bn, bb):
            """sum over section of p_a q_b dV up to O(w^2,h^2) terms, for
            fields p=(a,an,ab_), q=(b,bn,bb) in (center, normal, binormal)
            components."""
            return (
                cR * (a * b * m00 + an * bn * m11 + ab_ * bb * m22)
                + cN * m11 * (a * bn + b * an)
                + cB * m22 * (a * bb + b * ab_)
            )

        r, n, b_ = self.r, self.nor, self.bin
        v, vn, vb = self.v, self.vnor, self.vbin
        X, Y, Z = r[:, 0], r[:, 1], r[:, 2]
        JXY = -np.sum(ds * moment2(X, n[:, 0], b_[:, 0], Y, n[:, 1], b_[:, 1]))
        JZX = -np.sum(ds * moment2(Z, n[:, 2], b_[:, 2], X, n[:, 0], b_[:, 0]))
        JYZ = -np.sum(ds * moment2(Y, n[:, 1], b_[:, 1], Z, n[:, 2], b_[:, 2]))
        XX = ds * moment2(X, n[:, 0], b_[:, 0], X, n[:, 0], b_[:, 0])
        YY = ds * moment2(Y, n[:, 1], b_[:, 1], Y, n[:, 1], b_[:, 1])
        ZZ = ds * moment2(Z, n[:, 2], b_[:, 2], Z, n[:, 2], b_[:, 2])
        JXX = np.sum(YY + ZZ)
        JYY = np.sum(ZZ + XX)
        JZZ = np.sum(YY + XX)  # reference parity (main.cpp:11076)

        # angular momentum of deformation: AM = sum r x v dV.  Each term is
        # symmetric moment2 of one position and one velocity field; this
        # deliberately fixes the reference's dimensionally-inconsistent cN
        # term in x_yd (main.cpp:11078 mixes rY*norX into a velocity moment)
        # -- a typo, not a modeling choice; AM_Z differs accordingly.
        xd_y = moment2(v[:, 0], vn[:, 0], vb[:, 0], Y, n[:, 1], b_[:, 1])
        x_yd = moment2(X, n[:, 0], b_[:, 0], v[:, 1], vn[:, 1], vb[:, 1])
        xd_z = moment2(v[:, 0], vn[:, 0], vb[:, 0], Z, n[:, 2], b_[:, 2])
        x_zd = moment2(X, n[:, 0], b_[:, 0], v[:, 2], vn[:, 2], vb[:, 2])
        yd_z = moment2(v[:, 1], vn[:, 1], vb[:, 1], Z, n[:, 2], b_[:, 2])
        y_zd = moment2(Y, n[:, 1], b_[:, 1], v[:, 2], vn[:, 2], vb[:, 2])
        am = np.array(
            [
                np.sum((y_zd - yd_z) * ds),
                np.sum((xd_z - x_zd) * ds),
                np.sum((x_yd - xd_y) * ds),
            ]
        ) * np.pi

        eps = np.finfo(np.float64).eps
        J = np.array(
            [
                [max(JXX, eps), JXY, JZX],
                [JXY, max(JYY, eps), JYZ],
                [JZX, JYZ, max(JZZ, eps)],
            ]
        ) * np.pi
        self.angvel_internal = np.linalg.solve(J, am)

        # integrate internal quaternion *backwards* (counter-rotation)
        w_int = self.angvel_internal
        q = self.quaternion_internal
        dqdt = 0.5 * np.array(
            [
                -w_int[0] * q[1] - w_int[1] * q[2] - w_int[2] * q[3],
                +w_int[0] * q[0] + w_int[1] * q[3] - w_int[2] * q[2],
                -w_int[0] * q[3] + w_int[1] * q[0] + w_int[2] * q[1],
                +w_int[0] * q[2] - w_int[1] * q[1] + w_int[2] * q[0],
            ]
        )
        q = q - dt * dqdt
        self.quaternion_internal = q / np.linalg.norm(q)
        R = _quat_rot(self.quaternion_internal)

        for pos, vel in ((self.r, self.v), (self.nor, self.vnor),
                         (self.bin, self.vbin)):
            pos[:] = pos @ R.T
            vel[:] = vel @ R.T
            vel += np.cross(np.broadcast_to(w_int, pos.shape), pos) * -1.0


def _quat_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
