"""Parameter schedulers: smooth (C^1) transitions of control parameters.

The port's own copy of ``cup3d_tpu/models/fish/schedulers.py`` (numpy,
float64 on the host; no torch needed).

Reference: namespace Schedulers (main.cpp:7805-8004).  A scheduler holds a
transition window [t0, t1] with start/end parameter sets; inside the window
values follow the cubic Hermite between the endpoints (optionally starting
with the current derivative), outside they saturate.

``LearnWaveScheduler`` is the RL bending control: parameters live on wave
coordinates c = s/L - (t - t0)/Twave, so each commanded bend travels down
the body like the curvature wave (ParameterSchedulerLearnWave,
main.cpp:7949-8002).
"""

from __future__ import annotations

import numpy as np

from cup3d_tpu_torch.models.fish.interpolation import cubic_hermite, natural_cubic_spline


class ParameterScheduler:
    """N-parameter cubic-in-time transition (ParameterScheduler<N>)."""

    def __init__(self, npoints: int):
        self.npoints = npoints
        self.t0 = -1.0
        self.t1 = 0.0
        self.params_t0 = np.zeros(npoints)
        self.params_t1 = np.zeros(npoints)
        self.dparams_t0 = np.zeros(npoints)

    def transition(self, t, tstart, tend, params_tend,
                   use_current_derivative=False):
        """Start a transition toward params_tend (4-arg overload,
        main.cpp:7831-7845): the start values are the *current* values."""
        if t < tstart or t > tend:
            return
        params, dparams = self.get(tstart)
        self.t0 = tstart
        self.t1 = tend
        self.params_t0 = params
        self.params_t1 = np.asarray(params_tend, dtype=np.float64).copy()
        self.dparams_t0 = dparams if use_current_derivative else np.zeros(self.npoints)

    def transition_between(self, t, tstart, tend, params_tstart, params_tend):
        """5-arg overload (main.cpp:7846-7857): explicit start values;
        ignored if an earlier transition is still pending."""
        if t < tstart or t > tend:
            return
        if tstart < self.t0:
            return
        self.t0 = tstart
        self.t1 = tend
        self.params_t0 = np.asarray(params_tstart, dtype=np.float64).copy()
        self.params_t1 = np.asarray(params_tend, dtype=np.float64).copy()

    def get(self, t):
        """(params, dparams/dt) at time t (gimmeValues, main.cpp:7858-7872)."""
        if t < self.t0 or self.t0 < 0:
            return self.params_t0.copy(), np.zeros(self.npoints)
        if t > self.t1:
            return self.params_t1.copy(), np.zeros(self.npoints)
        y, dy = cubic_hermite(
            self.t0, self.t1, t, self.params_t0, self.params_t1, self.dparams_t0, 0.0
        )
        return y, dy

    def save_state(self) -> dict:
        return {
            "t0": self.t0, "t1": self.t1,
            "params_t0": self.params_t0.tolist(),
            "params_t1": self.params_t1.tolist(),
            "dparams_t0": self.dparams_t0.tolist(),
        }

    def load_state(self, d: dict) -> None:
        self.t0, self.t1 = d["t0"], d["t1"]
        self.params_t0 = np.asarray(d["params_t0"])
        self.params_t1 = np.asarray(d["params_t1"])
        self.dparams_t0 = np.asarray(d["dparams_t0"])


class ScalarScheduler(ParameterScheduler):
    """Single-parameter convenience (ParameterSchedulerScalar)."""

    def __init__(self):
        super().__init__(1)

    def transition_scalar(self, t, tstart, tend, val_start, val_end):
        self.transition_between(t, tstart, tend, [val_start], [val_end])

    def get_scalar(self, t):
        p, dp = self.get(t)
        return float(p[0]), float(dp[0])


class VectorScheduler(ParameterScheduler):
    """Spatially-distributed parameters: N control points -> values on the
    fine midline grid via natural cubic spline in s, cubic Hermite in time
    (ParameterSchedulerVector, main.cpp:7904-7948)."""

    def get_fine(self, t, positions, s_fine):
        p0 = natural_cubic_spline(positions, self.params_t0, s_fine)
        p1 = natural_cubic_spline(positions, self.params_t1, s_fine)
        dp0 = natural_cubic_spline(positions, self.dparams_t0, s_fine)
        if t < self.t0 or self.t0 < 0:
            return p0, np.zeros_like(p0)
        if t > self.t1:
            return p1, np.zeros_like(p1)
        return cubic_hermite(self.t0, self.t1, t, p0, p1, dp0, 0.0)


class LearnWaveScheduler(ParameterScheduler):
    """RL bending control riding the traveling wave.

    Values are interpolated at wave coordinate c = s/L - (t - t0)/Twave over
    the control points; outside the control range the end values extend
    flat.  ``turn`` shifts history down the body and inserts a new bend
    (ParameterSchedulerLearnWave::Turn, main.cpp:7994-8001).
    """

    def get_fine(self, t, twave, length, positions, s_fine):
        positions = np.asarray(positions, dtype=np.float64)
        c = np.asarray(s_fine) / length - (t - self.t0) / twave
        vals = np.zeros_like(c)
        dvals = np.zeros_like(c)
        below = c < positions[0]
        above = c > positions[-1]
        mid = ~(below | above)
        vals[below] = self.params_t0[0]
        vals[above] = self.params_t0[-1]
        if np.any(mid):
            cm = c[mid]
            j = np.clip(np.searchsorted(positions, cm, side="left"), 1,
                        len(positions) - 1)
            y, dy = cubic_hermite(
                positions[j - 1], positions[j], cm,
                self.params_t0[j - 1], self.params_t0[j],
            )
            vals[mid] = y
            dvals[mid] = -dy / twave  # chain rule: dc/dt = -1/Twave
        return vals, dvals

    def turn(self, b: float, t_turn: float) -> None:
        self.t0 = t_turn
        self.params_t0[2:] = self.params_t0[:-2]
        self.params_t0[1] = b
        self.params_t0[0] = 0.0
