"""The solver-consumption seam of ``cup3d_tpu/obs/trace.py::StepObserver``.

Only :meth:`StepObserver.note_solver` is ported: the drivers call it where
they read their step pack, with the host copies of the Poisson solve's
[residual, iterations].  It is the seam of the ``solver.nan_residual``
and ``solver.itercap`` faults (resilience/faults.py) and feeds the flight
recorder, which trips on an iteration cap or a non-finite residual.  The
rest of StepObserver (step spans, the trace sink) waits for ROADMAP A9.
"""

from __future__ import annotations

from typing import Optional

from cup3d_tpu_torch.obs import metrics as _metrics


class StepObserver:
    def __init__(self, flight=None, kind: str = "uniform"):
        self.flight = flight
        self.kind = kind
        self._g_iters = _metrics.gauge("poisson.iters", driver=kind)
        self._g_resid = _metrics.gauge("poisson.resid", driver=kind)
        self._h_iters = _metrics.histogram("poisson.iters_hist", driver=kind)
        self.last_solver: Optional[dict] = None

    def note_solver(self, step: int, iters: float, resid: float,
                    cap: Optional[int] = None) -> None:
        """Record one consumed (iterations, residual) pair.  The armed
        solver faults corrupt these host copies, so detection, trigger
        and recovery run exactly as on a real solver failure."""
        from cup3d_tpu_torch.resilience import faults

        if faults.fire("solver.nan_residual", step):
            resid = float("nan")
        if cap is not None and faults.fire("solver.itercap", step):
            iters = float(cap)
        self.last_solver = {"iters": float(iters), "resid": float(resid),
                            "at_step": int(step)}
        self._g_iters.set(float(iters))
        self._g_resid.set(float(resid))
        self._h_iters.observe(float(iters))
        if self.flight is not None:
            self.flight.note_solver(step, iters, resid, cap=cap)
