"""Bodies on the forest: BASELINE config #4 (run.sh's two StefanFish on
the adapting forest, non-pipelined host path) cut to bpd 1, levelMax 3,
levelStart 2, the port's driver against the JAX package's.

The JAX driver is tests/test_torch_jax_twins.py's "amr_fish" (the
unpadded host path, ``CUP3D_BUCKET=0``); the port runs on the plain
versions of its fused forest stages (``CUP3D_FUSED=1`` on the CPU).  Both
run ``init()`` and 3 steps:

- after ``init()`` the octree leaf keys are equal and every block that
  touches a body's interface is at the finest level;
- each step: dt within 1e-6 relative, Poisson iterations +-1, the
  collision pass's firing equal; after the steps each fish's rigid state
  (transVel, angVel, position) within 1e-5 absolute, its force pack
  within 1e-4 of its largest entry, the velocity within 1e-5 of max|u|;
- on the JAX state after the steps, carried into the port: the block
  rasterizer's sdf/udef within 1e-5, each fish's RL observation (its
  shear sensors read in the holding leaves) within 1e-5, the block
  surface probe within 1e-5
  of its largest force entry (its surface-cell count equal), the fluid's
  max|div u| within 1e-6 relative;
- the JAX state at step 2, bodies included, loaded into the port steps
  on to the JAX package's step 3;
- a forest checkpoint with both fish: the JAX package's reader accepts
  it; the port resumes it bitwise as the in-memory rollback to the same
  state, and within 1e-5 of max|u| of the run it was taken from at the
  frame velocity and dt a restore takes (it re-creates the bodies at the
  restored time, as the JAX package's loader does).

At finest h = 1/32 these two fish touch every octant of the box, so the
forest here cannot change while stepping; the regrid-while-stepping test
is tests/test_torch_amr_sim.py's towed fish.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import test_torch_jax_twins as twins
from cup3d_tpu.resilience import faults as jfaults
from cup3d_tpu_torch.__main__ import build_driver
from cup3d_tpu_torch.models.fish import StefanFish
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.sim import amr as tamr
from cup3d_tpu_torch.sim.data import obstacle_state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
RIGID = ("transVel", "angVel", "position")
FORCES = ("pres_force", "visc_force", "torque", "pow_out", "pout_bnd",
          "thrust", "drag", "def_power", "def_power_bnd", "p_locom")


def _vec(ob, keys):
    return np.concatenate([np.atleast_1d(np.asarray(getattr(ob, k),
                                                    np.float64))
                           for k in keys])


def _np(v):
    return np.array(v.numpy() if isinstance(v, torch.Tensor) else v)


def _state(d):
    """(arrays, scalars) of either package's forest driver at its step,
    bodies included, in the form ``sim.amr.load_state_numpy`` takes."""
    nb = d.grid.nb
    arrays = {k: _np(d._unpad(d.state[k]))[:nb]
              for k in ("vel", "p", "chi", "udef")}
    arrays["keys"] = np.asarray(d.grid.keys, np.int64).reshape(-1, 4)
    scalars = {"time": d.time, "step": d.step_idx, "dt": d.dt,
               "uinf": np.array(d.uinf, np.float64),
               "bodies": obstacle_state_to_numpy(d)}
    return arrays, scalars


def _row(d, iters):
    return {"dt": d.dt, "iters": iters,
            "rigid": [_vec(ob, RIGID) for ob in d.obstacles],
            "forces": [_vec(ob, FORCES) for ob in d.obstacles],
            "latched": [ob.collision_counter > 0 for ob in d.obstacles],
            "vel": twins.velocity(d)}


def _port(tmp, nsteps=10):
    return build_driver(twins.argv("amr_fish", tmp, nsteps)
                        + ["-device", "cpu"])


def _port_at(tmp, arrays, scalars, umax_next=None):
    """A port driver at a JAX state (its forest, fields and bodies)."""
    d = _port(tmp)
    d.init()
    tamr.load_state_numpy(d, arrays, scalars)
    d._umax_next = umax_next
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp

    from cup3d_tpu.models.base import pack_forces as j_pack
    from cup3d_tpu.ops.diagnostics import fluid_divergence_max_blocks as jdiv
    from cup3d_tpu.ops.surface import force_integrals_probe_blocks as jprobe

    saved = {k: os.environ.get(k) for k in ("CUP3D_FUSED", "CUP3D_FAULT",
                                            "CUP3D_RECOVER")}
    for k in saved:
        os.environ.pop(k, None)
    faults.clear()
    jfaults.clear()
    try:
        js = twins.jax_driver("amr_fish", tmp_path_factory.mktemp("jax"),
                              10)
        out = {"j_keys": list(js.grid.keys), "j_rows": []}
        for i in range(STEPS):
            if i == 2:
                out["j_state2"] = _state(js)
                out["j_umax2"] = js._umax_next
            js.advance(js.calc_max_timestep())
            out["j_rows"].append(_row(js, js.flight.residuals[-1]["iters"]))
        out["j_state3"] = _state(js)
        # the block probe on the swimming fish's own fields, at shifted
        # kinematics (the same window and 4096 slots on both sides)
        ob = js.obstacles[0]
        out["probe_kin"] = [ob.centerOfMass, ob.transVel + 0.01,
                            ob.angVel + 0.1]
        out["probe_fields"] = {k: _np(getattr(ob, k))
                               for k in ("chi", "sdf", "udef")}
        out["j_probe"] = np.asarray(j_pack(jprobe(
            js.grid, {"vel": js.state["vel"], "p": js.state["p"]}, ob.chi,
            ob.sdf, ob.udef, js.nu, ob.position, ob.length,
            *[jnp.asarray(k, jnp.float32) for k in out["probe_kin"]],
            max_points=4096)), np.float64)
        out["j_raster"] = [tuple(_np(a) for a in o._rasterize_blocks(
            js.time)) for o in js.obstacles]
        out["j_div"] = float(jdiv(js.grid, js.state["vel"], js.state["chi"],
                                  js._tab1))
        # the RL observation: its shear sensors sample the holding leaves
        out["j_obs"] = [o.state() for o in js.obstacles]

        os.environ["CUP3D_FUSED"] = "1"
        ts = _port(tmp_path_factory.mktemp("torch"))
        ts.init()
        out["t_keys"] = list(ts.grid.keys)
        _, near = ts.scores()
        out["t_near_levels"] = ts.grid.level[near.numpy()]
        out["t_rows"] = []
        for _ in range(STEPS):
            collisions = ts.collisions
            ts.advance(ts.calc_max_timestep())
            row = _row(ts, ts.step_log[-1]["iters"])
            row["fired"] = ts.collisions - collisions
            out["t_rows"].append(row)
        out["t_sim"] = ts
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.clear()
        jfaults.clear()


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("CUP3D_FUSED", "1")
    for var in ("CUP3D_FAULT", "CUP3D_RECOVER"):
        monkeypatch.delenv(var, raising=False)


def test_init_converges_to_the_same_forest(runs):
    assert runs["t_keys"] == runs["j_keys"]
    levels = runs["t_near_levels"]
    # the bodies' interface blocks, all at the finest level (levelMax 3)
    assert levels.size > 0 and np.all(levels == 2)


def test_three_steps_match_jax(runs):
    for jr, tr in zip(runs["j_rows"], runs["t_rows"]):
        assert abs(tr["dt"] - jr["dt"]) <= 1e-6 * jr["dt"]
        assert abs(tr["iters"] - jr["iters"]) <= 1, (tr["iters"],
                                                      jr["iters"])
        assert tr["latched"] == jr["latched"]
        assert tr["fired"] == int(any(jr["latched"]))
    jr, tr = runs["j_rows"][-1], runs["t_rows"][-1]
    for jv, tv in zip(jr["rigid"], tr["rigid"]):
        assert np.abs(tv - jv).max() <= 1e-5
    assert np.abs(jr["rigid"][0][:3]).max() > 0  # the fish swim
    for jf, tf in zip(jr["forces"], tr["forces"]):
        assert np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()
    want = jr["vel"]
    assert np.abs(tr["vel"] - want).max() <= 1e-5 * np.abs(want).max()
    assert len(runs["t_sim"].obstacles) == 2
    assert runs["t_sim"].step_log[-1]["nb"] == len(runs["j_keys"])


def test_block_rasterizer_sensors_and_divergence_match_jax(runs, tmp_path, fused):
    ts = _port_at(tmp_path, *runs["j_state3"])
    for (js_sdf, js_udef), ob in zip(runs["j_raster"], ts.obstacles):
        sdf, udef = ob._rasterize_blocks(ts.time)
        assert sdf.shape == js_sdf.shape and udef.shape == js_udef.shape
        assert np.abs(sdf.numpy() - js_sdf).max() <= 1e-5
        # udef within 4 cells of the surface, where chi (so the masked
        # udef) can be non-zero; farther out the closest section is a
        # near-tie between segments, and chi masks its udef to 0
        near = js_sdf > -4.0 / 32
        assert near.sum() > 1000
        assert np.abs(udef.numpy()[near] - js_udef[near]).max() <= 1e-5
        assert float(sdf.max()) > 0  # the body owns cells
    for want, ob in zip(runs["j_obs"], ts.obstacles):
        np.testing.assert_allclose(ob.state(), want, rtol=0, atol=1e-5)
        assert np.abs(want[16:]).max() > 0  # the sensors read a shear
    from cup3d_tpu_torch.ops.diagnostics import fluid_divergence_max_blocks

    div = float(fluid_divergence_max_blocks(
        ts._geom, ts.state["vel"], ts.state["chi"], ts._tab1))
    assert div > 0 and abs(div - runs["j_div"]) <= 1e-6 * runs["j_div"]


def test_block_probe_matches_jax(runs, tmp_path, fused):
    from cup3d_tpu_torch.models.base import pack_forces
    from cup3d_tpu_torch.ops.surface import force_integrals_probe_blocks

    ts = _port_at(tmp_path, *runs["j_state3"])
    ob = ts.obstacles[0]
    f = {k: torch.tensor(v) for k, v in runs["probe_fields"].items()}
    pt = pack_forces(force_integrals_probe_blocks(
        ts.grid, ts.state["vel"], ts.state["p"], f["chi"], f["sdf"],
        f["udef"], ts.nu, ob.position, ob.length,
        *[torch.tensor(k, dtype=torch.float32) for k in runs["probe_kin"]],
        max_points=4096)).numpy().astype(np.float64)
    pj = runs["j_probe"]
    assert pt.shape == (17,) and pt[16] == pj[16] and 0 < pj[16] < 4096
    assert np.abs(pt[:16] - pj[:16]).max() <= 1e-5 * np.abs(pj[:16]).max()


def test_state_at_step_two_carries_from_jax(runs, tmp_path, fused):
    arrays, scalars = runs["j_state2"]
    ts = _port_at(tmp_path, arrays, scalars, runs["j_umax2"])
    assert ts.step_idx == 2 and list(ts.grid.keys) == runs["j_keys"]
    ts.advance(ts.calc_max_timestep())
    for ref in (runs["j_rows"][2], runs["t_rows"][2]):
        assert abs(ts.dt - ref["dt"]) <= 1e-6 * ref["dt"]
        for ob, rv in zip(ts.obstacles, ref["rigid"]):
            assert np.abs(_vec(ob, RIGID) - rv).max() <= 1e-5
        want = ref["vel"]
        assert np.abs(twins.velocity(ts) - want).max() <= 1e-5 * np.abs(
            want).max()
    # and back out: state_to_numpy carries the bodies' state too
    a2, s2 = tamr.state_to_numpy(ts)
    assert set(a2) == {"vel", "p", "chi", "udef", "keys"}
    assert len(s2["bodies"]["obstacles"]) == 2
    bad = dict(a2, chi=a2["chi"][:-1])
    with pytest.raises(ValueError, match="chi"):
        tamr.load_state_numpy(ts, bad, s2)


def test_checkpoint_with_both_fish_resumes_bitwise(tmp_path, fused):
    from cup3d_tpu.io.checkpoint import read_payload as jax_read

    from cup3d_tpu_torch.io.checkpoint import (build_payload,
                                               load_checkpoint, read_payload,
                                               save_checkpoint)

    d = _port(tmp_path, 5)
    d.init()
    for _ in range(3):  # the fish swim: the frame moves with the first
        d.advance(d.calc_max_timestep())
    path = save_checkpoint(d)
    # the JAX package's reader takes the file: its format and layouts
    jp = jax_read(path)
    assert jp["kind"] == "amr" and jp["step"] == 3
    np.testing.assert_array_equal(jp["leaves"], np.asarray(d.grid.keys))
    for k in ("vel", "p", "chi", "udef"):
        np.testing.assert_array_equal(jp["fields"][k],
                                      d._unpad(d.state[k]).numpy())
    assert [type(o) for o in read_payload(path)["obstacles"]] == [
        StefanFish, StefanFish]
    r = load_checkpoint(path, device="cpu")
    assert r.step_idx == 3 and all(o.sim is r for o in r.obstacles)
    assert r.grid.keys == d.grid.keys
    for a, b in zip(r.obstacles, d.obstacles):
        assert np.abs(a.transVel).max() > 0
        for k in RIGID + ("quaternion", "absPos", "centerOfMass"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    # the run it was taken from, stepped on at the frame velocity and the
    # dt the restore takes: the loader re-creates the bodies at the restored time,
    # and their frame velocity is then the updated fish's (the JAX
    # package's loader does the same), one rigid update ahead of the one
    # the uninterrupted step advects with
    assert np.abs(r.uinf - d.uinf).max() > 0
    (tmp_path / "live").mkdir()
    live = _port(tmp_path / "live", 5)
    live.init()
    tamr.load_state_numpy(live, *tamr.state_to_numpy(d))
    live.uinf = r.uinf.copy()
    # the file resumes bitwise as the in-memory rollback to its state
    snap = build_payload(d)
    snap["fields"] = {k: v.clone() for k, v in snap["fields"].items()}
    snap["obstacles"] = pickle.dumps(snap["obstacles"])
    d._resilience_restore(snap)
    for drv in (d, r):
        drv.advance(drv.calc_max_timestep())
    assert r.dt == d.dt
    for k in ("vel", "p", "chi", "udef"):
        assert torch.equal(r.state[k], d.state[k]), k
    for a, b in zip(r.obstacles, d.obstacles):
        np.testing.assert_array_equal(_vec(a, RIGID + FORCES),
                                      _vec(b, RIGID + FORCES))
    # ... and at its dt (it reads max|u| afresh over the re-created udef:
    # the step pack's value is not saved)
    live.dt, live.lambda_penal = r.dt, r.lambda_penal
    live.advance(r.dt)
    want = live.state["vel"]
    assert float(torch.max(torch.abs(r.state["vel"] - want))) <= 1e-5 * \
        float(torch.max(torch.abs(want)))
    # the recovery engine's snapshot pickles the same objects
    assert type(pickle.loads(pickle.dumps(d.obstacles))[1]) is StefanFish
