"""The fish slice as a whole: BASELINE config #2 (one self-propelled
StefanFish, iterative Poisson 1e-6/1e-4, two-level, non-pipelined) cut
to 32^3, the port's driver against the JAX package's.

Both drivers start from one state: the JAX driver of
tests/test_torch_jax_twins.py (reset to its initial state) is carried
into the port through ``load_state_numpy`` (fields and scalars) and
``load_obstacle_state_numpy`` (the fish's rigid mirrors, gait and PID
state), and back.  Then:

- 3 steps: the rigid pack (transVel, angVel, position, quaternion)
  within 1e-5 abs, the force pack within 1e-4 of its largest entry,
  velocity within 1e-5 of max|u|, Poisson iterations within +-1 a step;
  then the RL observation within 1e-5 and an RL action's effect;
- the surface probe on the fish's fields (ops/surface.py) within 1e-5;
- ``simulate()`` under ``CUP3D_FAULT=solver.itercap@2:3``: the same
  rollbacks as the JAX engine (warm-restart, zero-guess, tile-only), the
  same step and time, velocity within 1e-5 of max|u|;
- a checkpoint round trip with the fish on the port;
- two fish, the sphere and the foil build on the forest too, and the
  pipelined forest takes a megastep with them.
"""

import pickle

import numpy as np
import pytest
import torch

import test_torch_jax_twins as twins
from cup3d_tpu.resilience import faults as jfaults
from cup3d_tpu_torch.__main__ import build_driver
from cup3d_tpu_torch.io.checkpoint import (load_checkpoint, read_payload,
                                           save_checkpoint)
from cup3d_tpu_torch.models.fish import StefanFish
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.sim.data import (load_obstacle_state_numpy,
                                      load_state_numpy,
                                      obstacle_state_to_numpy)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RIGID = ("transVel", "angVel", "position", "quaternion")
#: the gait state an RL action sets (CurvatureDefinedFishData.execute)
ACTED = {"lastCurv", "oldrCurv", "lastTact", "current_period",
         "next_period", "transition_start", "rlBendingScheduler",
         "torsionValues"}
FORCES = ("pres_force", "visc_force", "torque", "pow_out", "pout_bnd",
          "thrust", "drag", "def_power", "def_power_bnd", "p_locom")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("CUP3D_FAULT", "CUP3D_RECOVER", "CUP3D_FUSED",
                "CUP3D_COARSE", "CUP3D_GETZ", "CUP3D_SNAP_EVERY"):
        monkeypatch.delenv(var, raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _port_from(js, tmp, nsteps):
    """The port's fish driver at the JAX driver's state."""
    ts = build_driver(twins.argv("fish", tmp, nsteps) + ["-device", "cpu"])
    ts.init()
    s = js.sim
    load_state_numpy(ts.sim, {k: np.asarray(v) for k, v in s.state.items()},
                     {"time": s.time, "step": s.step, "dt": s.dt,
                      "uinf": s.uinf})
    load_obstacle_state_numpy(ts.sim, obstacle_state_to_numpy(s))
    ts._umax_next = js._umax_next
    return ts


def _vec(ob, keys):
    return np.concatenate([np.atleast_1d(np.asarray(getattr(ob, k),
                                                    np.float64))
                           for k in keys])


def _states_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _states_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)) or hasattr(a, "popleft"):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _states_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_three_steps_match_the_jax_package(tmp_path):
    (tmp_path / "jax").mkdir()
    js = twins.jax_driver("fish", tmp_path / "jax", 10)
    for _ in range(2):  # a swimming state: the body bent, the fluid moving
        js.advance(js.calc_max_timestep())
    ts = _port_from(js, tmp_path, 10)
    # the carry is exact both ways
    st = obstacle_state_to_numpy(ts.sim)
    _states_equal(st, obstacle_state_to_numpy(js.sim))
    load_obstacle_state_numpy(js.sim, st)
    _states_equal(obstacle_state_to_numpy(js.sim), st)
    assert float(np.asarray(js.sim.state["chi"]).sum()) > 0
    for _ in range(3):
        dt_j, dt_t = js.calc_max_timestep(), ts.calc_max_timestep()
        assert abs(dt_t - dt_j) <= 1e-6 * dt_j
        js.advance(dt_j)
        ts.advance(dt_t)
        it_j = js.flight.residuals[-1]["iters"]
        assert abs(ts.step_log[-1]["iters"] - it_j) <= 1, (
            ts.step_log[-1]["iters"], it_j)
    jo, to = js.sim.obstacles[0], ts.sim.obstacles[0]
    assert np.abs(_vec(to, RIGID) - _vec(jo, RIGID)).max() <= 1e-5
    fj, ft = _vec(jo, FORCES), _vec(to, FORCES)
    assert np.abs(ft - fj).max() <= 1e-4 * np.abs(fj).max()
    assert np.abs(_vec(jo, ("transVel",))).max() > 0
    want = twins.velocity(js)
    assert np.abs(twins.velocity(ts) - want).max() <= 1e-5 * np.abs(
        want).max()
    # the host bound on the body's speed (rigid + deformation)
    assert abs(to.max_body_speed(ts.sim.uinf)
               - jo.max_body_speed(js.sim.uinf)) <= 1e-5
    # the RL accessors: the 25-value observation (shear sensors included)
    # and an action
    np.testing.assert_allclose(to.state(), jo.state(), rtol=0, atol=1e-5)
    for ob in (jo, to):
        ob.act(js.sim.time + 0.1, [0.3, 0.1, 0.0])
    gait = [{k: v for k, v in obstacle_state_to_numpy(d.sim)["obstacles"][0][
        "myFish"].items() if k in ACTED} for d in (ts, js)]
    assert set(gait[0]) == ACTED
    _states_equal(*gait)


def test_force_probe_matches_on_the_fish(tmp_path):
    """``force_integrals_probe_uniform`` -> ``pack_forces`` on the swimming
    fish's own fields (the JAX driver's state after 3 steps), within 1e-5
    of the pack's largest force entry, the surface-cell count exactly."""
    import jax.numpy as jnp

    from cup3d_tpu.models.base import pack_forces as j_pack
    from cup3d_tpu.ops.surface import force_integrals_probe_uniform as j_probe
    from cup3d_tpu_torch.models.base import pack_forces
    from cup3d_tpu_torch.ops.surface import force_integrals_probe_uniform

    (tmp_path / "jax").mkdir()
    js = twins.jax_driver("fish", tmp_path / "jax", 10)
    for _ in range(3):
        js.advance(js.calc_max_timestep())
    s, ob = js.sim, js.sim.obstacles[0]
    kin = [ob.centerOfMass, ob.transVel + 0.01, ob.angVel + 0.1]
    args = [s.state["vel"], s.state["p"], ob.chi, ob.sdf, ob.udef]
    # the driver's static arguments: the 32^3 window and 4096 slots
    pj = np.asarray(j_pack(j_probe(
        s.grid, ob, *args, s.nu, *[jnp.asarray(k, jnp.float32) for k in kin],
        max_points=4096)), np.float64)
    ts = _port_from(js, tmp_path, 10)
    to = ts.sim.obstacles[0]
    for k in ("chi", "sdf", "udef"):
        setattr(to, k, torch.tensor(np.asarray(getattr(ob, k))))
    pt = pack_forces(force_integrals_probe_uniform(
        ts.sim.grid, to, ts.sim.state["vel"], ts.sim.state["p"], to.chi,
        to.sdf, to.udef, ts.sim.nu,
        *[torch.tensor(k, dtype=torch.float32) for k in kin],
        max_points=4096)).numpy().astype(np.float64)
    assert pt.shape == (17,) and pt[16] == pj[16] and 0 < pj[16] < 4096
    assert np.abs(pt[:16] - pj[:16]).max() <= 1e-5 * np.abs(pj[:16]).max()


def test_recovery_ladder_matches_the_jax_engine(tmp_path, monkeypatch):
    """Three iteration-cap failures at step 2 walk both engines down the
    ladder to its tile-only rung, with the fish present."""
    monkeypatch.setenv(faults.ENV_VAR, "solver.itercap@2:3")
    (tmp_path / "jax").mkdir()
    js = twins.jax_driver("fish", tmp_path / "jax", 4)
    ts = _port_from(js, tmp_path, 4)
    js.simulate()
    ts.simulate()

    def events(d):
        return [(e["stage"], e["failed_at_step"], e["rolled_back_to"],
                 e["dt_scale"]) for e in d.flight.recovery_events
                if "stage" in e]

    assert [e[0] for e in events(js)] == ["warm-restart", "zero-guess",
                                          "tile-only"]
    assert events(ts) == events(js)
    assert twins.step_of(ts) == twins.step_of(js) == 4
    t_j = twins.time_of(js)
    assert abs(twins.time_of(ts) - t_j) <= 1e-6 * t_j
    want = twins.velocity(js)
    assert np.abs(twins.velocity(ts) - want).max() <= 1e-5 * np.abs(
        want).max()


def test_checkpoint_round_trip_with_the_fish(tmp_path):
    d = build_driver(twins.argv("fish", tmp_path, 4) + ["-device", "cpu"])
    d.init()
    for _ in range(2):
        d.advance(d.calc_max_timestep())
    path = save_checkpoint(d)
    obs = read_payload(path)["obstacles"]
    assert [type(o) for o in obs] == [StefanFish]
    r = load_checkpoint(path, device="cpu")
    assert r.sim.step == 2 and r.sim.obstacles[0].sim is r.sim
    # chi/udef rebuilt from the restored host state (at the restored time,
    # so not the live fields of the last step's start)
    assert float(r.sim.state["chi"].sum()) > 0
    assert r.sim.obstacles[0].udef is not None
    for k in RIGID + ("absPos", "centerOfMass"):
        np.testing.assert_array_equal(getattr(r.sim.obstacles[0], k),
                                      getattr(d.sim.obstacles[0], k))
    for k in ("vel", "p"):
        assert torch.equal(r.sim.state[k], d.sim.state[k])
    # the next step at the live run's dt (the restored driver reads max|u|
    # afresh, over the rebuilt udef: the step pack's value is not saved)
    dt = d.calc_max_timestep()
    r.calc_max_timestep()
    r.sim.dt, r.sim.lambda_penal = d.sim.dt, d.sim.lambda_penal
    for drv in (d, r):
        drv.advance(dt)
    v, w = r.sim.state["vel"], d.sim.state["vel"]
    assert float(torch.max(torch.abs(v - w))) <= 1e-5 * float(
        torch.max(torch.abs(w)))
    # the engine's snapshot pickles the same objects
    assert type(pickle.loads(pickle.dumps(d.sim.obstacles))[0]) is StefanFish


@pytest.mark.parametrize("body", [twins.FISH_BODY + "\n" + twins.FISH_BODY,
                                  "sphere L=0.1", "naca L=0.2"])
def test_other_bodies_build_on_the_forest(tmp_path, body):
    """Two fish, the sphere and the foil run on the uniform grid (ROADMAP
    A5, tests/test_torch_bodies.py) and build on the forest as well: its
    init() rasterizes each onto the finest level, and the pipelined forest
    builds the same bodies and takes a megastep with them."""
    argv = twins.argv("fish", tmp_path, 1)
    argv[-1] = body
    d = build_driver(argv + ["-device", "cpu"])
    d.init()
    assert len(d.sim.obstacles) == len(body.splitlines())
    import dataclasses

    from cup3d_tpu_torch.sim.amr import AMRSimulation

    cfg = dataclasses.replace(d.cfg, levelMax=2, levelStart=1, bpdx=2,
                              bpdy=2, bpdz=2)
    f = AMRSimulation(cfg, device="cpu")
    f.init()
    assert len(f.obstacles) == len(body.splitlines())
    # the body's volume is the uniform grid's at the same finest h (the
    # foil is thinner than a cell there: no cell of either is inside)
    vol = float(torch.sum(f._unpad(f.state["chi"])
                          * f.grid.h_column() ** 3))
    d.pipeline[0](0.0)  # the uniform grid's CreateObstacles at t = 0
    want = float(d.sim.state["chi"].sum()) * d.sim.grid.h ** 3
    assert abs(vol - want) <= 1e-5 * want
    near = f.scores()[1].numpy()
    assert near.any() == (want > 0) and np.all(f.grid.level[near] == 1)
    p = AMRSimulation(dataclasses.replace(cfg, pipelined=True), device="cpu")
    p.init()
    assert torch.equal(p.state["chi"], f.state["chi"])
    p.advance(p.calc_max_timestep())
    p.flush_packs()
    assert len(p.step_log) == 1 and bool(torch.isfinite(p.state["vel"]).all())
