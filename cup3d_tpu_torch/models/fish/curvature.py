"""Carangiform curvature kinematics: the swimming gait generator.

The port's own copy of ``cup3d_tpu/models/fish/curvature.py`` (numpy,
float64 on the host; no torch needed).

Reference: CurvatureDefinedFishData (main.cpp:8979-9088, computeMidline
15463-15519, performPitchingMotion 15521-15571, recomputeNormalVectors
15572-15667, execute 15434-15462).

The midline curvature is a baseline amplitude envelope (natural cubic spline
through 6 control points growing toward the tail) times a traveling wave
sin(2 pi ((t - t0)/Tp + timeshift) + pi phi - 2 pi s/(L lambda)), plus RL
bending and PID corrections:

- alpha/dalpha: amplitude modulation from streamwise-position error;
- beta/dbeta:   additive curvature from lateral-position + yaw error;
- gamma/dgamma: pitching (bending out of plane) from depth error, applied as
  a cylinder-wrap of the computed midline (performPitchingMotion);
- rlBendingScheduler: RL turn commands riding the wave;
- period/torsion schedulers for RL period and torsion actions.
"""

from __future__ import annotations

import numpy as np

from cup3d_tpu_torch.models.fish.frenet import frenet_solve
from cup3d_tpu_torch.models.fish.midline import FishMidlineData
from cup3d_tpu_torch.models.fish.schedulers import (
    LearnWaveScheduler,
    ScalarScheduler,
    VectorScheduler,
)


class CurvatureDefinedFishData(FishMidlineData):
    def __init__(self, length, Tperiod, phase_shift, h, amplitude_factor=1.0):
        super().__init__(length, Tperiod, phase_shift, h, amplitude_factor)
        # PID / RL state (main.cpp:8981-9007)
        self.lastTact = 0.0
        self.lastCurv = 0.0
        self.oldrCurv = 0.0
        self.periodPIDval = self.Tperiod
        self.periodPIDdif = 0.0
        self.TperiodPID = False
        self.lastTime = 0.0
        self.time0 = 0.0
        self.timeshift = 0.0
        self.alpha, self.dalpha = 1.0, 0.0
        self.beta, self.dbeta = 0.0, 0.0
        self.gamma, self.dgamma = 0.0, 0.0
        self.curvatureScheduler = VectorScheduler(6)
        self.rlBendingScheduler = LearnWaveScheduler(7)
        self.periodScheduler = ScalarScheduler()
        # seed with Tperiod so a first call at t > 0.1 Tperiod is well-posed
        # (the reference relies on computeMidline being called from t=0)
        self.periodScheduler.params_t0[:] = self.Tperiod
        self.periodScheduler.params_t1[:] = self.Tperiod
        self.control_torsion = False
        self.torsionScheduler = VectorScheduler(3)
        self.torsionValues = np.zeros(3)
        self.torsionValues_previous = np.zeros(3)
        self.Ttorsion_start = 0.0
        self.current_period = self.Tperiod
        self.next_period = self.Tperiod
        self.transition_start = 0.0
        self.transition_duration = 0.1 * self.Tperiod

    # -- RL actions (execute, main.cpp:15434-15462) ------------------------

    def execute(self, time: float, l_tnext: float, action) -> None:
        action = np.atleast_1d(np.asarray(action, dtype=np.float64))
        if len(action) >= 1:
            self.rlBendingScheduler.turn(float(action[0]), l_tnext)
        if len(action) in (3, 5):
            self.current_period = self.periodPIDval
            self.next_period = self.Tperiod * (1 + float(action[1]))
            self.transition_start = l_tnext
        if len(action) == 5:
            self.torsionValues_previous = self.torsionValues.copy()
            self.torsionValues = action[2:5].copy()
            self.Ttorsion_start = time

    def correct_tail_period(self, period_fac, period_vel, t, dt):
        """PID tail-beat period modulation (main.cpp:9030-9043).

        Note a deliberate divergence: the condensed reference defines
        correctTailPeriod but never calls it, and its computeMidline
        unconditionally overwrites periodPIDval from the period scheduler
        (main.cpp:15467) — the API is dead there.  Here compute_midline
        skips the scheduler overwrite while TperiodPID is active, so this
        control entry point actually works (upstream CubismUP_3D behavior).
        """
        last_arg = (self.lastTime - self.time0) / self.periodPIDval + self.timeshift
        self.time0 = self.lastTime
        self.timeshift = last_arg
        self.periodPIDval = self.Tperiod * period_fac
        self.periodPIDdif = self.Tperiod * period_vel
        self.lastTime = t
        self.TperiodPID = True

    # -- gait -------------------------------------------------------------

    def compute_midline(self, t: float, dt: float) -> None:
        L = self.length
        self.periodScheduler.transition_scalar(
            t, self.transition_start,
            self.transition_start + self.transition_duration,
            self.current_period, self.next_period,
        )
        if not self.TperiodPID:  # PID takeover holds the period (see
            # correct_tail_period); otherwise the scheduler drives it
            self.periodPIDval, self.periodPIDdif = self.periodScheduler.get_scalar(t)
        if self.transition_start < t < self.transition_start + self.transition_duration:
            self.timeshift = (t - self.time0) / self.periodPIDval + self.timeshift
            self.time0 = t

        curvature_points = np.array([0.0, 0.15, 0.4, 0.65, 0.9, 1.0]) * L
        bend_points = np.array([-0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0])
        curvature_values = (
            np.array([0.82014, 1.46515, 2.57136, 3.75425, 5.09147, 5.70449]) / L
        )
        # amplitude ramps 0 -> baseline over the first period (15480-15483)
        self.curvatureScheduler.transition_between(
            0.0, 0.0, self.Tperiod, np.zeros(6), curvature_values
        )
        rC, vC = self.curvatureScheduler.get_fine(t, curvature_points, self.rS)
        rB, vB = self.rlBendingScheduler.get_fine(
            t, self.periodPIDval, L, bend_points, self.rS
        )

        diffT = (
            1.0 - (t - self.time0) * self.periodPIDdif / self.periodPIDval
            if self.TperiodPID
            else 1.0
        )
        darg = 2.0 * np.pi / self.periodPIDval * diffT
        arg0 = (
            2.0 * np.pi * ((t - self.time0) / self.periodPIDval + self.timeshift)
            + np.pi * self.phaseShift
        )
        arg = arg0 - 2.0 * np.pi * self.rS / (L * self.waveLength)
        curv = np.sin(arg) + rB + self.beta
        dcurv = np.cos(arg) * darg + vB + self.dbeta
        af = self.amplitudeFactor
        rK = self.alpha * af * rC * curv
        vK = self.alpha * af * (vC * curv + rC * dcurv) + self.dalpha * af * rC * curv
        if not np.all(np.isfinite(rK)) or not np.all(np.isfinite(vK)):
            raise FloatingPointError("non-finite midline curvature")

        rT = np.zeros(self.Nm)
        vT = np.zeros(self.Nm)
        if self.control_torsion:
            torsion_points = np.array([0.0, 0.5, 1.0]) * L
            self.torsionScheduler.transition_between(
                t, self.Ttorsion_start, self.Ttorsion_start + 0.5 * self.Tperiod,
                self.torsionValues_previous, self.torsionValues,
            )
            rT, vT = self.torsionScheduler.get_fine(t, torsion_points, self.rS)

        sol = frenet_solve(self.rS, rK, vK, rT, vT)
        self.r, self.v = sol["r"], sol["v"]
        self.nor, self.vnor = sol["nor"], sol["vnor"]
        self.bin, self.vbin = sol["bin"], sol["vbin"]
        self.perform_pitching_motion(t)

    def perform_pitching_motion(self, t: float) -> None:
        """Wrap the planar midline onto a cylinder of radius 1/gamma for
        depth control (main.cpp:15521-15571)."""
        if abs(self.gamma) > 1e-10:
            R = 1.0 / self.gamma
            Rdot = -self.dgamma / self.gamma**2
        else:
            R = 1e10 if self.gamma >= 0 else -1e10
            Rdot = 0.0
        x0N, y0N = self.r[-1, 0], self.r[-1, 1]
        x0Nd, y0Nd = self.v[-1, 0], self.v[-1, 1]
        phi = np.arctan2(y0N, x0N)
        phidot = (y0Nd / x0N - y0N * x0Nd / x0N**2) / (1.0 + (y0N / x0N) ** 2)
        M = np.hypot(x0N, y0N)
        Mdot = (x0N * x0Nd + y0N * y0Nd) / M
        cphi, sphi = np.cos(phi), np.sin(phi)

        x0, y0 = self.r[:, 0], self.r[:, 1]
        x0d, y0d = self.v[:, 0], self.v[:, 1]
        x1 = cphi * x0 - sphi * y0
        y1 = sphi * x0 + cphi * y0
        x1d = cphi * x0d - sphi * y0d + (-sphi * x0 - cphi * y0) * phidot
        y1d = sphi * x0d + cphi * y0d + (cphi * x0 - sphi * y0) * phidot
        theta = (M - x1) / R
        cth, sth = np.cos(theta), np.sin(theta)
        thetad = (Mdot - x1d) / R - (M - x1) / R**2 * Rdot
        self.r = np.stack([M - R * sth, y1, R - R * cth], axis=1)
        self.v = np.stack(
            [
                Mdot - Rdot * sth - R * cth * thetad,
                y1d,
                Rdot - Rdot * cth + R * sth * thetad,
            ],
            axis=1,
        )
        self.recompute_normal_vectors()

    def recompute_normal_vectors(self) -> None:
        """Re-orthonormalize nor/bin (+ their velocities) against the
        recomputed tangent after pitching (main.cpp:15572-15667)."""
        nm = self.Nm
        rs = self.rS
        t_vec = np.empty((nm, 3))
        dt_vec = np.empty((nm, 3))
        # nonuniform-grid one-sided-weights tangent in the interior
        hp = (rs[2:] - rs[1:-1])[:, None]
        hm = (rs[1:-1] - rs[:-2])[:, None]
        frac = hp / hm
        am, a, ap = -frac * frac, frac * frac - 1.0, np.ones_like(frac)
        denom = 1.0 / (hp * (1.0 + frac))
        t_vec[1:-1] = (am * self.r[:-2] + a * self.r[1:-1] + ap * self.r[2:]) * denom
        dt_vec[1:-1] = (am * self.v[:-2] + a * self.v[1:-1] + ap * self.v[2:]) * denom
        # ends: two-point slopes toward the interior
        for i, ipm in ((0, 1), (nm - 1, nm - 2)):
            ids = 1.0 / (rs[ipm] - rs[i])
            t_vec[i] = (self.r[ipm] - self.r[i]) * ids
            dt_vec[i] = (self.v[ipm] - self.v[i]) * ids

        # Gram-Schmidt nor against tangent, carrying time derivatives
        dot = np.einsum("ij,ij->i", self.nor, t_vec)[:, None]
        ddot = (
            np.einsum("ij,ij->i", self.vnor, t_vec)
            + np.einsum("ij,ij->i", self.nor, dt_vec)
        )[:, None]
        nor = self.nor - dot * t_vec
        inorm = 1.0 / np.linalg.norm(nor, axis=1, keepdims=True)
        self.nor = nor * inorm
        self.vnor = self.vnor - ddot * t_vec - dot * dt_vec
        bin_ = np.cross(t_vec, self.nor)
        ibnorm = 1.0 / np.linalg.norm(bin_, axis=1, keepdims=True)
        self.bin = bin_ * ibnorm
        self.vbin = np.cross(dt_vec, self.nor) + np.cross(t_vec, self.vnor)
