"""BASELINE config #5 (the forced channel, bench.py::bench_channel) in the
port against the JAX package, cut to 32x16x16 (bpdx 4, bpdy 2, bpdz 2,
extent 2, walls in y, uMax_forced 0.5, bFixMassFlux, CFL 0.4, nu 1e-3,
rampup 0, iterative Poisson at 1e-6 / 1e-4).

As the bench runs it (zero initial velocity) the channel stays a
streamwise flow u(y): its divergence is exactly zero and every Poisson
solve converges at iteration 0.  That run is held tight: 5 steps,
velocity within 1e-5 of its scale, flux.txt rows within 1e-6,
iterations +-1, with the port's bulk-velocity mean summed in the JAX
package's CPU order (one sequential f32 sum: at step 1 it sits 2.3e-5
off the exact mean of a field near 0.33 everywhere, the port's
pairwise mean 2e-8); the port's own mean is held to the float64 mean
of its field within 1e-6.  A second run starts both packages from one
seeded divergent state, so the Krylov solve works on the wall-bounded
system (the fused driver's cross-tile wall planes and the coarse graph
without coupling through the wall); it is held to the driver bound of
tests/test_torch_simulation.py (velocity within 1e-3 of max|u|: the
solve stops at 1e-4 relative).  ExternalForcing and FixMassFlux are also
held alone to the JAX operators on seeded fields."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.__main__ import build_driver as jax_build_driver
from cup3d_tpu_torch import __main__ as tmain
from cup3d_tpu_torch.ops import fused_bicgstab as tfb
from cup3d_tpu_torch.sim import data as tdata
from cup3d_tpu_torch.sim import operators as tops
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGV = ("-bpdx 4 -bpdy 2 -bpdz 2 -levelMax 1 -levelStart 0 -extent 2 "
        "-BC_y wall -uMax_forced 0.5 -bFixMassFlux 1 -CFL 0.4 -nu 1e-3 "
        "-rampup 0 -poissonSolver iterative -poissonTol 1e-6 "
        "-poissonTolRel 1e-4 -tend 0 -nsteps 5 -verbose 0 "
        "-freqDiagnostics 0").split()


def _pair(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    js = jax_build_driver(ARGV + ["-path4serialization", str(jdir)])
    ts = tmain.build_driver(ARGV + ["-path4serialization", str(tdir),
                                    "-device", "cpu"])
    assert dataclasses.asdict(ts.cfg) | {"path4serialization": ""} == \
        dataclasses.asdict(js.cfg) | {"path4serialization": ""}
    js.init()
    ts.init()
    return js, ts, jdir, tdir


def _flux_rows(path):
    return np.array([[float(v) for v in ln.split()]
                     for ln in path.read_text().splitlines()])


def _step_both(js, ts, nsteps):
    its = []
    for _ in range(nsteps):
        dt_j = js.calc_max_timestep()
        dt_t = ts.calc_max_timestep()
        assert abs(dt_t - dt_j) <= 1e-6 * dt_j, (dt_t, dt_j)
        js.advance(dt_j)
        ts.advance(dt_t)
        it_j = js.flight.residuals[-1]["iters"]
        it_t = ts.step_log[-1]["iters"]
        assert abs(it_t - it_j) <= 1, (it_t, it_j)
        its.append(it_t)
    js.sim.logger.flush()
    ts.sim.logger.flush()
    return its


def _sequential_mean(vel):
    """The JAX package's CPU mean of vel[..., 0]: one sequential f32 sum
    in C order, then / n."""
    u = vel[..., 0].reshape(-1).numpy()
    return torch.as_tensor(np.add.accumulate(u)[-1] / np.float32(u.size))


@pytest.mark.parametrize("fused", ["0", "1"])
def test_channel_as_the_bench_runs_it_matches_jax(monkeypatch, tmp_path,
                                                  fused):
    monkeypatch.setenv("CUP3D_FUSED", fused)
    monkeypatch.setattr(tops, "bulk_velocity", _sequential_mean)
    js, ts, jdir, tdir = _pair(tmp_path)
    names = [op.name for op in ts.pipeline]
    assert names == [op.name for op in js.pipeline]
    assert names[:2] == ["AdvectionDiffusion", "FixMassFlux"]
    its = _step_both(js, ts, 5)
    assert its == [0.0] * 5  # u(y) only: div u = 0 exactly
    v_j = np.asarray(js.sim.state["vel"])
    v_t = ts.sim.state["vel"].numpy()
    assert np.abs(v_t - v_j).max() <= 1e-5 * np.abs(v_j).max()
    f_j, f_t = _flux_rows(jdir / "flux.txt"), _flux_rows(tdir / "flux.txt")
    assert f_t.shape == f_j.shape == (5, 4)
    np.testing.assert_array_equal(f_t[:, 0], f_j[:, 0])
    np.testing.assert_allclose(f_t[:, 1:], f_j[:, 1:], rtol=0, atol=1e-6)
    # the bulk velocity holds the target (tests/test_massflux.py's 5%)
    target = 2.0 / 3.0 * 0.5
    u_avg = float(np.mean(v_t[..., 0]))
    assert abs(u_avg - target) < 0.05 * target, (u_avg, target)


def test_bulk_velocity_is_the_exact_mean(tmp_path):
    js, ts, _, _ = _pair(tmp_path)
    for _ in range(2):
        ts.advance(ts.calc_max_timestep())
    vel = ts.sim.state["vel"]
    exact = float(np.mean(vel[..., 0].numpy().astype(np.float64)))
    assert abs(float(tops.bulk_velocity(vel)) - exact) <= 1e-6 * exact


def test_channel_from_a_perturbed_state_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("CUP3D_FUSED", "1")
    js, ts, _, _ = _pair(tmp_path)
    rng = np.random.default_rng(5)
    vel = (np.asarray(js.sim.state["vel"])
           + 0.05 * rng.standard_normal(js.sim.state["vel"].shape)
           ).astype(np.float32)
    js.sim.state["vel"] = jnp.asarray(vel)
    arrays = {k: np.asarray(v) for k, v in js.sim.state.items()}
    tdata.load_state_numpy(ts.sim, arrays, {
        "time": js.sim.time, "step": js.sim.step, "dt": js.sim.dt,
        "uinf": np.asarray(js.sim.uinf)})
    tfb.reset_launches()
    its = _step_both(js, ts, 3)
    assert min(its) > 0
    v_j = np.asarray(js.sim.state["vel"])
    v_t = ts.sim.state["vel"].numpy()
    assert np.abs(v_t - v_j).max() <= 1e-3 * np.abs(v_j).max()
    # the fused driver ran its plain versions (no launch on the CPU)
    assert tfb.iterations["executed"] > 0
    assert all(n == 0 for n in tfb.launches.values())


def _op_pair(tmp_path, flags):
    """A JAX and a port driver of config #5 with ``flags``, and one
    seeded velocity field loaded into both."""
    argv = ARGV + flags + ["-path4serialization", str(tmp_path)]
    js = jax_build_driver(argv)
    ts = tmain.build_driver(argv + ["-device", "cpu"])
    rng = np.random.default_rng(11)
    vel = rng.standard_normal(js.sim.state["vel"].shape).astype(np.float32)
    js.sim.state["vel"] = jnp.asarray(vel)
    ts.sim.state["vel"] = torch.as_tensor(vel)
    for d in (js, ts):
        d.sim.uinf = np.array([0.1, 0.0, 0.0])
        d.sim.step, d.sim.time = 3, 0.25
    return js, ts


def test_external_forcing_matches_jax(tmp_path):
    from cup3d_tpu.sim import operators as jops

    js, ts = _op_pair(tmp_path, ["-bFixMassFlux", "0"])
    dt = 3e-3
    jops.ExternalForcing(js.sim)(jnp.float32(dt))
    tops.ExternalForcing(ts.sim)(torch.tensor(dt, dtype=torch.float32))
    np.testing.assert_array_equal(ts.sim.state["vel"].numpy(),
                                  np.asarray(js.sim.state["vel"]))


def test_fix_mass_flux_matches_jax(tmp_path):
    from cup3d_tpu.sim import operators as jops

    js, ts = _op_pair(tmp_path, [])
    jops.FixMassFlux(js.sim)(jnp.float32(3e-3))
    tops.FixMassFlux(ts.sim)(torch.tensor(3e-3, dtype=torch.float32))
    v_j = np.asarray(js.sim.state["vel"])
    np.testing.assert_allclose(ts.sim.state["vel"].numpy(), v_j, rtol=0,
                               atol=1e-6 * np.abs(v_j).max())
    js.sim.logger.flush()
    ts.sim.logger.flush()
    row_j = (tmp_path / "flux.txt").read_text().splitlines()
    assert len(row_j) == 2  # both wrote a row to the same file
    a, b = (np.array([float(v) for v in r.split()]) for r in row_j)
    assert a[0] == b[0] == 3
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
