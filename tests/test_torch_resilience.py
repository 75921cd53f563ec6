"""The port's self-healing run loop (cup3d_tpu_torch/resilience, the
flight recorder and both drivers' ``simulate()``), the twins of
tests/test_resilience.py with shorter runs, on the CPU.

- a ``CUP3D_FAULT`` plan parses as in the JAX package;
- the port's engine and the JAX package's, on one configuration under
  one fault plan, take the same rollbacks (stage, failing step, snapshot
  step, dt scale) and end at the same step, time and velocity;
- a one-shot ``step.nan_velocity`` recovers on the uniform grid and on
  the forest: one rollback, no postmortem, kinetic energy within 5% of
  the unfaulted run (the retry halves dt over a few steps);
- recovery armed with no fault is bitwise the ``CUP3D_RECOVER=0`` loop,
  and that loop keeps crashing on a fault, with a postmortem;
- an ``solver.itercap`` fault takes the warm-restart rung;
- a persistent NaN residual walks all four rungs to a give-up with a
  4000-iteration budget, and under ``CUP3D_FUSED=1`` the rebuilt solve
  runs the tile-only getZ (B3 / B10's plain versions here), not the
  two-level one;
- the give-up writes a postmortem and a checkpoint that restarts to
  ``tend``;
- a plain ``RuntimeError`` inside a solve (what a kernel that fails to
  build or launch raises) ends ``simulate()`` with no retry.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_jax_twins as twins
from cup3d_tpu.resilience import faults as jfaults
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.obs.flight import load_postmortem
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.resilience.recovery import SimulationFailure
from cup3d_tpu_torch.sim.amr import AMRSimulation
from cup3d_tpu_torch.sim.simulation import Simulation
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRIDS = ("uniform", "amr")

#: the twin runs' plan, with a snapshot every 2 steps: a NaN velocity at
#: step 1 (dt-halve, back to step 0, recovering through step 1 + 4), an
#: iteration cap at step 5, the window's last step (the second attempt:
#: zero-guess), and a NaN residual at step 10, past the next window (a
#: first attempt again: warm-restart)
TWIN_FAULT = "step.nan_velocity@1; solver.itercap@5; solver.nan_residual@10"
TWIN_EVENTS = [("dt-halve", 1, 0, 0.5), ("zero-guess", 5, 4, 0.25),
               ("warm-restart", 10, 10, 0.5)]
TWIN_STEPS = 12


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for var in ("CUP3D_FAULT", "CUP3D_RECOVER", "CUP3D_FUSED",
                "CUP3D_COARSE", "CUP3D_GETZ", "CUP3D_SNAP_EVERY"):
        monkeypatch.delenv(var, raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def unfaulted(tmp_path_factory):
    """grid -> the port's unfaulted run with the engine armed, made once
    per module for the tests that compare against it."""
    runs = {}

    def get(grid):
        if grid not in runs:
            runs[grid] = _run(tmp_path_factory.mktemp(grid), grid)
        return runs[grid]

    return get


def _cfg(tmp, grid, **kw):
    base = dict(bpdx=2, bpdy=2, bpdz=2, levelMax=1, levelStart=0,
                extent=2 * np.pi, CFL=0.3, nu=0.02, tend=0.5, nsteps=0,
                rampup=0, initCond="taylorGreen", poissonSolver="iterative",
                poissonTol=1e-6, poissonTolRel=1e-4, verbose=False,
                freqDiagnostics=0, path4serialization=str(tmp))
    if grid == "amr":  # the JAX test's forest config, a shorter run
        base.update(levelMax=2, tend=0.2, Rtol=1.8, Ctol=0.05)
    base.update(kw)
    return SimulationConfig(**base)


def _driver(tmp, grid, **kw):
    cls = AMRSimulation if grid == "amr" else Simulation
    d = cls(_cfg(tmp, grid, **kw), device="cpu")
    d.init()
    return d


def _run(tmp, grid, **kw):
    d = _driver(tmp, grid, **kw)
    d.simulate()
    return d


def _vel(d):
    return d.state["vel"] if isinstance(d, AMRSimulation) else \
        d.sim.state["vel"]


def _time(d):
    return d.time if isinstance(d, AMRSimulation) else d.sim.time


def _ke(d):
    v = _vel(d).double()
    return float(torch.mean(torch.sum(v * v, dim=-1)))


def _flight_files(tmp):
    return sorted(f for f in os.listdir(tmp) if f.startswith("flight_"))


# -- fault plan --------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "step.nan_velocity@3:2; ckpt.write_fail@*",
    "solver.itercap@2:3",
    "dt.collapse@0,stream.stall@*:5;fleet.lane_nan@7",
    "solver.nan_residual@ 4 : 99 ;",
])
def test_fault_plans_parse_as_in_the_jax_package(spec):
    want, got = jfaults.FaultPlan(), faults.FaultPlan()
    want.parse(spec)
    got.parse(spec)
    assert got.snapshot() == want.snapshot()
    assert faults.SITES == jfaults.SITES


def test_fault_plan_fire_counts_env_reload_and_maybe_raise(monkeypatch):
    p = faults.FaultPlan()
    p.parse("step.nan_velocity@3:2; ckpt.write_fail@*")
    assert not p.fire("step.nan_velocity", 2)
    assert p.fire("step.nan_velocity", 3) and p.fire("step.nan_velocity", 4)
    assert not p.fire("step.nan_velocity", 5)
    assert p.fire("ckpt.write_fail", None)
    assert not p.fire("ckpt.write_fail", 99)
    with pytest.raises(ValueError, match="unknown fault site"):
        p.arm("bogus.site")
    with pytest.raises(ValueError, match="site@step"):
        p.parse("step.nan_velocity")
    s0 = M.snapshot()
    monkeypatch.setenv(faults.ENV_VAR, "ckpt.write_fail@5")
    faults.load_env()
    faults.maybe_raise("ckpt.write_fail", 4)  # before its step: silent
    with pytest.raises(faults.InjectedFault) as ei:
        faults.maybe_raise("ckpt.write_fail", 5)
    assert isinstance(ei.value, IOError)
    assert M.delta(s0)["faults.injected{site=ckpt.write_fail}"] == 1


# -- rollback / retry on the drivers ----------------------------------------


@pytest.mark.parametrize("grid", GRIDS)
def test_nan_velocity_fault_recovers_and_matches_ke(tmp_path, unfaulted,
                                                    grid):
    ref = unfaulted(grid)
    faults.arm("step.nan_velocity", 2, 1)
    s0 = M.snapshot()
    d = _run(tmp_path / "flt", grid)
    delta = M.delta(s0)
    assert _time(d) >= d.cfg.tend - 1e-9
    assert delta["resilience.rollbacks"] == 1
    assert delta.get("resilience.giveups", 0) == 0
    assert delta["resilience.retries{stage=dt-halve}"] == 1
    assert _flight_files(tmp_path / "flt") == []
    assert any(e.get("reason") == "nan-velocity" and e.get("stage")
               for e in d.flight.recovery_events)
    assert abs(_ke(d) - _ke(ref)) <= 0.05 * _ke(ref)


@pytest.mark.parametrize("grid", GRIDS)
def test_recover_armed_is_bitwise_vs_legacy(tmp_path, monkeypatch, unfaulted,
                                            grid):
    armed = unfaulted(grid)
    monkeypatch.setenv("CUP3D_RECOVER", "0")
    legacy = _run(tmp_path / "legacy", grid)
    assert torch.equal(_vel(armed), _vel(legacy))
    faults.arm("step.nan_velocity", 1, 1)
    d = _driver(tmp_path / "crash", grid)
    with pytest.raises(SimulationFailure, match="runaway"):
        d.simulate()
    files = _flight_files(tmp_path / "crash")
    assert len(files) == 1 and "nan-velocity" in files[0]


def _events(d):
    return [(e["stage"], e["failed_at_step"], e["rolled_back_to"],
             e["dt_scale"]) for e in d.flight.recovery_events if "stage" in e]


@pytest.mark.parametrize("grid", GRIDS)
def test_recovery_matches_the_jax_engine(tmp_path, monkeypatch, grid):
    """Both packages' drivers through ``simulate()`` on one 16^3
    Taylor-Green configuration (tests/test_torch_jax_twins.py) under
    TWIN_FAULT: the same recovery events, the same step and time, and
    velocity within 1e-5 of max|u|."""
    from cup3d_tpu_torch.__main__ import build_driver

    monkeypatch.setenv("CUP3D_SNAP_EVERY", "2")
    monkeypatch.setenv(faults.ENV_VAR, TWIN_FAULT)
    (tmp_path / "jax").mkdir()
    js = twins.jax_driver(grid, tmp_path / "jax", TWIN_STEPS)
    js.simulate()
    ts = build_driver(twins.argv(grid, tmp_path, TWIN_STEPS)
                      + ["-device", "cpu"])
    ts.init()
    ts.simulate()
    assert _events(ts) == _events(js) == TWIN_EVENTS
    assert _flight_files(tmp_path) == []
    assert twins.step_of(ts) == twins.step_of(js) == TWIN_STEPS
    t_j = twins.time_of(js)
    assert abs(twins.time_of(ts) - t_j) <= 1e-6 * t_j
    want = twins.velocity(js)
    assert np.abs(twins.velocity(ts) - want).max() <= 1e-5 * np.abs(
        want).max()


def test_itercap_fault_takes_the_warm_restart_rung(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "solver.itercap@2")
    s0 = M.snapshot()
    d = _run(tmp_path, "uniform")
    delta = M.delta(s0)
    assert d.sim.time >= d.cfg.tend - 1e-9
    assert delta["resilience.rollbacks"] == 1
    assert delta["resilience.retries{stage=warm-restart}"] == 1
    assert _flight_files(tmp_path) == []
    assert any(e.get("reason") == "poisson-itercap"
               for e in d.flight.recovery_events)


def _spy(monkeypatch, module, calls):
    for name in ("getz_two", "getz_tile"):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("grid", GRIDS)
def test_persistent_nan_residual_walks_all_four_rungs(tmp_path, monkeypatch,
                                                      grid):
    from cup3d_tpu_torch.ops import fused_amr_bicgstab, fused_bicgstab

    monkeypatch.setenv("CUP3D_FUSED", "1")
    calls = []
    _spy(monkeypatch, fused_amr_bicgstab if grid == "amr" else
         fused_bicgstab, calls)
    d = _driver(tmp_path, grid)
    rungs = []
    real_rebuild = d._resilience_rebuild_poisson

    def rebuild(**kw):
        rungs.append(len(calls))
        real_rebuild(**kw)

    d._resilience_rebuild_poisson = rebuild
    faults.arm("solver.nan_residual", 1, 99)
    s0 = M.snapshot()
    with pytest.raises(SimulationFailure, match="recovery exhausted"):
        d.simulate()
    delta = M.delta(s0)
    stages = {k.split("stage=")[1].rstrip("}"): v for k, v in delta.items()
              if k.startswith("resilience.retries") and v}
    assert stages == {"warm-restart": 1, "zero-guess": 1, "tile-only": 1,
                      "iter-bump": 1}
    assert delta["resilience.giveups"] == 1
    solver = d._solver if grid == "amr" else d.sim.poisson_solver
    assert solver.maxiter == 4000
    # before the tile-only rung only the two-level getZ ran; after it only
    # the tile-only one
    first = rungs[0]
    assert set(calls[:first]) == {"getz_two"}
    assert set(calls[first:]) == {"getz_tile"}
    files = _flight_files(tmp_path)
    assert len(files) == 1
    pm = load_postmortem(os.path.join(tmp_path, files[0]))
    assert pm["reason"] == "poisson-nan-residual"
    assert len(pm["recovery_events"]) >= 4


def test_give_up_writes_postmortem_and_restartable_checkpoint(tmp_path):
    from cup3d_tpu_torch.io.checkpoint import (latest_valid_checkpoint,
                                               load_checkpoint)

    faults.arm("step.nan_velocity", 2, 99)
    s0 = M.snapshot()
    d = _driver(tmp_path, "uniform")
    with pytest.raises(SimulationFailure, match="runaway"):
        d.simulate()
    delta = M.delta(s0)
    assert delta["resilience.giveups"] == 1
    assert delta["resilience.restart_checkpoints"] == 1
    assert len(_flight_files(tmp_path)) == 1
    faults.clear()
    path = latest_valid_checkpoint(str(tmp_path))
    assert path is not None
    res = load_checkpoint(path, device="cpu")
    assert res.sim.step == 0
    res.simulate()
    assert res.sim.time >= res.cfg.tend - 1e-9


@pytest.mark.parametrize("grid", GRIDS)
def test_runtime_error_in_a_solve_ends_the_run(tmp_path, grid):
    """A kernel that fails to build or launch raises a plain RuntimeError
    (ops/cuda_lib.py): the engine is installed but claims it not."""
    d = _driver(tmp_path, grid)
    solver = d._solver if grid == "amr" else d.sim.poisson_solver
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("cup3d_getz_two: CUDA error 700 at launch")
        return solver(*a, **kw)

    failing.supports_stats = True
    failing.maxiter = solver.maxiter
    if grid == "amr":
        d._solver = failing
    else:
        d.sim.poisson_solver = failing
        d._setup_operators()
    s0 = M.snapshot()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        d.simulate()
    assert len(calls) == 3
    delta = M.delta(s0)
    assert delta.get("resilience.rollbacks", 0) == 0
    assert not any(v for k, v in delta.items()
                   if k.startswith("resilience.retries"))
    assert d._resilience is None  # uninstalled on the way out
    assert _flight_files(tmp_path) == []
