"""The port's driver against the JAX package's, and its CLI.

Whole slice: both packages run the 32^3 Taylor-Green vortex with the
iterative solver and CUP3D_FUSED=1 for 5 steps from one numpy state
(seeded perturbation of the TGV field, carried by load_state_numpy).
Per step: dt within 1e-6 relative, Poisson iterations within +-1,
kinetic energy within 1e-4 relative and velocity within 1e-3 of max|u|
(the Krylov solve stops at 1e-4 relative, so one iteration more or less
moves the pressure at about that level)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.__main__ import build_driver as jax_build_driver
from cup3d_tpu_torch import __main__ as tmain
from cup3d_tpu_torch.ops import diagnostics as tdiag
from cup3d_tpu_torch.ops import fused_bicgstab as tfb
from cup3d_tpu_torch.sim import data as tdata
from cup3d_tpu_torch.sim.simulation import resolve_device
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGV = ("-bpdx 4 -bpdy 4 -bpdz 4 -levelMax 1 -extent 6.283185307179586 "
        "-initCond taylorGreen -poissonSolver iterative -poissonTol 1e-6 "
        "-poissonTolRel 1e-4 -nu 1e-3 -CFL 0.4 -rampup 0 -tend 0 -nsteps 5 "
        "-verbose 0").split()


def _ke(vel):
    v = np.asarray(vel, np.float64)
    return 0.5 * float(np.sum(v * v))


def test_simulation_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("CUP3D_FUSED", "1")
    argv = ARGV + ["-path4serialization", str(tmp_path)]
    js = jax_build_driver(argv)
    ts = tmain.build_driver(argv + ["-device", "cpu"])
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    js.init()
    ts.init()
    # one state for both: the TGV field plus a seeded, divergent bump
    rng = np.random.default_rng(0)
    vel = np.asarray(js.sim.state["vel"]) + 0.05 * rng.standard_normal(
        js.sim.state["vel"].shape).astype(np.float32)
    js.sim.state["vel"] = jnp.asarray(vel)
    arrays = {k: np.asarray(v) for k, v in js.sim.state.items()}
    scalars = {"time": js.sim.time, "step": js.sim.step, "dt": js.sim.dt,
               "uinf": np.asarray(js.sim.uinf)}
    tdata.load_state_numpy(ts.sim, arrays, scalars)
    got_arrays, got_scalars = tdata.state_to_numpy(ts.sim)
    for k in arrays:
        np.testing.assert_array_equal(got_arrays[k], arrays[k])
    assert got_scalars["time"] == scalars["time"]

    tfb.reset_launches()
    for _ in range(5):
        dt_j = js.calc_max_timestep()
        dt_t = ts.calc_max_timestep()
        assert abs(dt_t - dt_j) <= 1e-6 * dt_j, (dt_t, dt_j)
        js.advance(dt_j)
        ts.advance(dt_t)
        it_j = js.flight.residuals[-1]["iters"]
        it_t = ts.step_log[-1]["iters"]
        assert abs(it_t - it_j) <= 1, (it_t, it_j)
        v_j = np.asarray(js.sim.state["vel"])
        v_t = ts.sim.state["vel"].numpy()
        ke_j, ke_t = _ke(v_j), _ke(v_t)
        assert abs(ke_t - ke_j) <= 1e-4 * ke_j, (ke_t, ke_j)
        assert np.abs(v_t - v_j).max() <= 1e-3 * np.abs(v_j).max()
    assert ts.sim.step == js.sim.step == 5
    # the fused driver ran (plain versions on the CPU: no kernel launches)
    assert tfb.iterations["executed"] > 0
    assert all(n == 0 for n in tfb.launches.values())


def test_simulate_runs_to_nsteps_and_logs(tmp_path):
    argv = ["-bpdx", "2", "-bpdy", "2", "-bpdz", "2", "-extent",
            "6.283185307179586", "-initCond", "taylorGreen", "-nu", "1e-2",
            "-tend", "0", "-nsteps", "3", "-freqDiagnostics", "1",
            "-verbose", "0", "-path4serialization", str(tmp_path),
            "-device", "cpu"]
    d = tmain.build_driver(argv)
    d.init()
    ke0 = float(tdiag.dissipation(d.sim.grid, d.sim.state["vel"],
                                  d.sim.nu)["kinetic_energy"])
    d.simulate()
    assert d.sim.step == 3 and len(d.step_log) == 3
    energy = (tmp_path / "energy.txt").read_text().splitlines()
    assert len(energy) == 3 and float(energy[-1].split()[1]) < ke0
    div = (tmp_path / "div.txt").read_text().splitlines()
    # the spectral solve removes the centered divergence exactly
    assert float(div[-1].split()[3]) < 1e-4


def test_cli_device_flag_and_conf(tmp_path):
    conf = tmp_path / "run.conf"
    conf.write_text("# lower precedence than the command line\n"
                    "-nu 5e-3\n-CFL 0.1\n")
    argv = ["-bpdx", "1", "-bpdy", "1", "-bpdz", "1", "-CFL", "0.3",
            "-conf", str(conf), "-verbose", "0"]
    d = tmain.build_driver(argv + ["-device", "cpu"])
    assert d.device == torch.device("cpu")
    assert d.cfg.CFL == 0.3 and d.cfg.nu == 5e-3
    # the port's config is the JAX package's, flag for flag
    from cup3d_tpu.__main__ import _expand_conf
    from cup3d_tpu.config import parse_args

    assert dataclasses.asdict(d.cfg) == dataclasses.asdict(
        parse_args(_expand_conf(argv)))
    with pytest.raises(ValueError, match="-device"):
        tmain.build_driver(argv + ["-device", "tpu"])
    # levelMax > 1 builds the AMR driver, with bodies too, pipelined or
    # not
    from cup3d_tpu_torch.sim.amr import AMRSimulation

    amr = tmain.build_driver(argv + ["-levelMax", "2", "-device", "cpu"])
    assert isinstance(amr, AMRSimulation)
    body = ["-levelMax", "2", "-factory-content", "sphere L=0.1"]
    amr = tmain.build_driver(argv + body + ["-device", "cpu"])
    assert isinstance(amr, AMRSimulation) and "chi" in amr.state
    amr = tmain.build_driver(argv + body + ["-pipelined", "1", "-device",
                                            "cpu"])
    assert isinstance(amr, AMRSimulation) and amr.cfg.pipelined
    # pipelined stepping and the megaloop run, and so do dumps and
    # periodic checkpoints
    d = tmain.build_driver(argv + ["-pipelined", "1", "-scan_k", "8",
                                   "-device", "cpu"])
    assert d.cfg.pipelined and d.cfg.scan_k == 8
    d = tmain.build_driver(argv + ["-saveFreq", "5", "-tdump", "0.1",
                                   "-device", "cpu"])
    assert d.sim.cadence.save_freq == 5 and d.sim.cadence.tdump == 0.1


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.build_driver(["-bpdx", "1", "-bpdy", "1", "-bpdz", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


# -- scan_k without pipelined: the per-step loop, as in the JAX package ---

SCAN_CFG = dict(bpdx=2, bpdy=2, bpdz=2, levelMax=1, nsteps=2, tend=0.0,
                initCond="taylorGreen", verbose=False)


def test_scan_k_without_pipelined_runs_the_per_step_loop(tmp_path):
    """scan_k=8 without pipelined runs (the megaloop needs pipelined
    stepping) and gives the scan_k=0 run's fields bitwise; the JAX
    driver's init() resolves the same config to K = 0."""
    from cup3d_tpu.config import SimulationConfig as JConfig
    from cup3d_tpu.sim.simulation import Simulation as JSimulation
    from cup3d_tpu_torch.config import SimulationConfig
    from cup3d_tpu_torch.sim.simulation import Simulation

    fields = []
    for k in (8, 0):
        d = Simulation(SimulationConfig(
            scan_k=k, path4serialization=str(tmp_path / f"k{k}"),
            **SCAN_CFG), device="cpu")
        d.init()
        d.simulate()
        assert d._scan_k == 0 and d.sim.step == 2
        fields.append({n: v.clone() for n, v in d.sim.state.items()})
    for n in fields[0]:
        assert torch.equal(fields[0][n], fields[1][n]), n
    js = JSimulation(JConfig(scan_k=8, path4serialization=str(tmp_path),
                             **SCAN_CFG))
    js.init()
    assert js._scan_k == 0


@pytest.mark.parametrize("env", [None, "4", "1", "-3", "eight", ""])
def test_resolve_scan_k_matches_jax(monkeypatch, env):
    """CUP3D_SCAN_K overrides cfg.scan_k; a malformed value falls back
    to cfg.scan_k, as in the JAX package's megaloop.resolve_scan_k."""
    from cup3d_tpu.config import SimulationConfig as JConfig
    from cup3d_tpu.sim.megaloop import resolve_scan_k as jax_resolve
    from cup3d_tpu_torch.config import SimulationConfig
    from cup3d_tpu_torch.sim.simulation import resolve_scan_k

    if env is None:
        monkeypatch.delenv("CUP3D_SCAN_K", raising=False)
    else:
        monkeypatch.setenv("CUP3D_SCAN_K", env)
    want = jax_resolve(JConfig(scan_k=8))
    assert resolve_scan_k(SimulationConfig(scan_k=8)) == want
    assert want == {None: 8, "4": 4, "1": 1, "-3": 0, "eight": 8, "": 8}[env]
