"""The port's copy of the fish's host stack (cup3d_tpu_torch/models/fish:
interpolation, schedulers, frenet, shapes, midline, curvature), the
StefanFish's position PID and its roll correction, against the JAX
package's, on the same inputs.  Both are float64 numpy, so everything is
held within 1e-12.
"""

import types

import numpy as np
import pytest

from cup3d_tpu.grid.uniform import UniformGrid as JGrid
from cup3d_tpu.models.fish import curvature as jcurv
from cup3d_tpu.models.fish import shapes as jshapes
from cup3d_tpu.models.fish.stefanfish import StefanFish as JFish
from cup3d_tpu_torch.grid.uniform import UniformGrid as TGrid
from cup3d_tpu_torch.models.fish import curvature as tcurv
from cup3d_tpu_torch.models.fish import shapes as tshapes
from cup3d_tpu_torch.models.fish.stefanfish import StefanFish as TFish

L, T, H = 0.4, 1.0, 1.0 / 32
DT = 1e-3
PHASES = (0.0, 0.25, 0.55, 0.8)  # gait phases t/T (tests/test_megaloop.py)
ARRAYS = ("rS", "r", "v", "nor", "vnor", "bin", "vbin", "width", "height",
          "quaternion_internal", "angvel_internal")


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(1.0, np.abs(a).max(
        initial=0.0))


def _fish_data(curv, shp, height="danio", width="stefan"):
    cf = curv.CurvatureDefinedFishData(L, T, 0.0, H, 1.0)
    cf.height, cf.width = shp.compute_widths_heights(height, width, L, cf.rS)
    return cf


@pytest.mark.parametrize("profiles", [("danio", "stefan"),
                                      ("baseline", "baseline")])
def test_midline_matches_at_four_gait_phases(profiles):
    cj = _fish_data(jcurv, jshapes, *profiles)
    ct = _fish_data(tcurv, tshapes, *profiles)
    # an RL bending action and a period change exercise the schedulers
    for cf in (cj, ct):
        cf.execute(0.1, 0.2, [0.3, 0.1, 0.0])
    for t in PHASES:
        for cf in (cj, ct):
            cf.compute_midline(t, DT)
            cf.integrate_linear_momentum()
            cf.integrate_angular_momentum(DT)
        for k in ARRAYS:
            _close(getattr(ct, k), getattr(cj, k))


def _fake_sim(grid, step):
    return types.SimpleNamespace(grid=grid, step=step, time=0.3,
                                 uinf=np.array([-0.01, 0.002, 0.0]), dt=DT)


def test_position_pid_matches():
    """alpha/beta/gamma corrections and the midline they bend, from a
    displaced, yawed and pitched fish."""
    spec = {"type": "StefanFish", "L": str(L), "T": str(T),
            "CorrectPosition": "1", "CorrectPositionZ": "1",
            "heightProfile": "danio", "widthProfile": "stefan"}
    fj = JFish(_fake_sim(JGrid((32, 32, 32), (1.0, 1.0, 1.0)), 5), spec)
    ft = TFish(_fake_sim(TGrid((32, 32, 32), (1.0, 1.0, 1.0)), 5), spec)
    yaw, pitch = 0.1, 0.05
    q = np.array([np.cos(yaw / 2), 0.0, np.sin(pitch / 2), np.sin(yaw / 2)])
    for f in (fj, ft):
        f.position = f.position + np.array([0.03, -0.02, 0.01])
        f.absPos = f.position.copy()
        f.transVel = np.array([0.02, 0.01, -0.005])
        f.quaternion = q / np.linalg.norm(q)
    for t in PHASES:
        for f in (fj, ft):
            f.update_shape(t, DT)
        for k in ("alpha", "dalpha", "beta", "dbeta", "gamma", "dgamma"):
            _close(getattr(ft.myFish, k), getattr(fj.myFish, k))
        for k in ARRAYS:
            _close(getattr(ft.myFish, k), getattr(fj.myFish, k))
        _close(ft.myFish.sensorLocation, fj.myFish.sensorLocation)
    assert fj.myFish.alpha != 1.0 and fj.myFish.gamma != 0.0


def test_roll_correction_matches():
    """StefanFish.compute_velocities with CorrectRoll (the host rigid path):
    the 6x6 solve, the 5-second roll-axis average and the clipped roll
    correction, from a rolled fish over a few updates."""
    spec = {"type": "StefanFish", "L": str(L), "T": str(T),
            "CorrectRoll": "1"}
    sims = [_fake_sim(JGrid((32, 32, 32), (1.0, 1.0, 1.0)), 5),
            _fake_sim(TGrid((32, 32, 32), (1.0, 1.0, 1.0)), 5)]
    fish = [JFish(sims[0], spec), TFish(sims[1], spec)]
    roll = 0.2
    for s, f in zip(sims, fish):
        s.time, s.dt = 1.2, 0.4
        f.quaternion = np.array([np.cos(roll / 2), np.sin(roll / 2), 0, 0])
        f.update_shape(0.3, DT)
    mom = {"mass": 2e-3, "center": np.array([1e-3, 1.1e-3, 0.9e-3]),
           "lin_mom": np.array([1e-5, -2e-5, 3e-6]),
           "ang_mom": np.array([2e-8, 1e-8, -3e-8]),
           "inertia": np.array([[4e-6, 1e-7, 0.0], [1e-7, 3e-5, 2e-7],
                                [0.0, 2e-7, 3.1e-5]])}
    for _ in range(4):
        for f in fish:
            f.compute_velocities(mom)
        _close(fish[1].angVel, fish[0].angVel)
        _close(fish[1].transVel, fish[0].transVel)
    assert not fish[1].supports_device_update()
    assert len(fish[1].r_axis) == len(fish[0].r_axis) > 2
