"""The port's pipelined forest against its own host path, and the
pipelined forest's fallbacks and device chains (the JAX package's cases
and bounds, tests/test_amr_pipelined.py, at its sizes):

- two spheres on the bpd-1 forest at levelMax 2, 5 steps at dt 1e-3,
  pipelined against the host path, adaptation off and on: position rtol
  1e-6, transVel rtol 1e-3, force rtol 2e-3, velocity atol 5e-5 (the
  host path solves the 6x6 in f64 numpy, the device chain in f32); the
  adapting run's steps take the scores staged by the step before;
- the collision fallback: two interpenetrating spheres latch
  ``_collision_hot``, the host path takes the steps, all stays finite;
- the device dt chain against the host dt policy (atol 2e-4, time
  1e-4 relative, each dt 1e-6 relative);
- the obstacle-free pipelined step on 4 CPU shards under
  ``CUP3D_RING_HALO=1``: bitwise the sharded host path (the same
  arithmetic), within 1e-5 of the unsharded pipelined forest (the static
  tile-only solve against the two-level one).
"""

import numpy as np
import pytest
import torch

import test_torch_jax_twins as twins
from cup3d_tpu_torch.__main__ import build_driver
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.sim.amr import AMRSimulation
from test_torch_amr_pipelined import _plain_env, _port  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPHERE_STEPS = 5


def _sphere_pair(tmp, adapt):
    pipe = _port("amr_spheres", tmp / "p", SPHERE_STEPS, adapt=adapt)
    pipe.simulate()
    host = _port("amr_spheres", tmp / "h", SPHERE_STEPS, "-pipelined", "0",
                 adapt=adapt)
    host.simulate()
    return pipe, host


@pytest.mark.parametrize("adapt", [False, True])
def test_pipelined_spheres_match_host_path(tmp_path, adapt):
    """Fixed dt: the device rigid chain never depends on the host
    mirrors, so the two paths agree to f32 round-off (the host path
    solves the 6x6 in f64 numpy, the chain in f32)."""
    pipe, host = _sphere_pair(tmp_path, adapt)
    assert not pipe._pack_reader and pipe.grid.nb == host.grid.nb
    for op, oh in zip(pipe.obstacles, host.obstacles):
        np.testing.assert_allclose(op.position, oh.position, rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(op.transVel, oh.transVel, rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(op.force, oh.force, rtol=2e-3,
                                   atol=1e-5)
    np.testing.assert_allclose(twins.velocity(pipe), twins.velocity(host),
                               atol=5e-5)
    np.testing.assert_allclose(pipe.uinf, host.uinf, rtol=1e-3, atol=1e-5)
    if adapt:
        # steps 1-4 adapt from the scores staged by the step before
        assert pipe.prefetch == {"hits": SPHERE_STEPS - 1, "misses": 1}
        assert pipe._pack_reader.stats["bytes_staged"] > 0


def test_pipelined_collision_fallback(tmp_path):
    """The JAX package's case: two spheres start interpenetrated, so the
    overlap count of the first pack latches the host path, whose fresh
    pre-check and collision pass take the steps; all stays finite."""
    argv = twins.argv("amr_spheres", tmp_path, 14)
    argv[argv.index("-dt") + 1] = "0.002"
    argv[-1] = ("Sphere radius=0.12 xpos=0.45 ypos=0.5 zpos=0.5 xvel=0.5\n"
                "Sphere radius=0.12 xpos=0.55 ypos=0.5 zpos=0.5 xvel=-0.5")
    d = build_driver(argv + ["-device", "cpu"])
    d.init()
    d.adapt_enabled = False
    went_hot = False
    for _ in range(14):
        d.advance(d.calc_max_timestep())
        went_hot = went_hot or d._collision_hot
    d.flush_packs()
    assert went_hot and d.collision_fallbacks > 0
    for ob in d.obstacles:
        assert np.all(np.isfinite(ob.position))
        assert np.all(np.isfinite(ob.transVel))
    assert bool(torch.isfinite(d.state["vel"]).all())
    v_rel = d.obstacles[1].transVel[0] - d.obstacles[0].transVel[0]
    assert v_rel > -4.0


def _tgv_cfg(tmp, **kw):
    base = dict(bpdx=2, bpdy=2, bpdz=2, levelMax=2, levelStart=0,
                extent=float(2 * np.pi), CFL=0.3, Rtol=1.8, Ctol=0.05,
                nu=1e-3, tend=0.0, nsteps=8, rampup=0,
                poissonSolver="iterative", poissonTol=1e-6,
                poissonTolRel=1e-4, initCond="taylorGreen", verbose=False,
                freqDiagnostics=0, path4serialization=str(tmp))
    base.update(kw)
    return SimulationConfig(**base)


def test_device_dt_chain_matches_host_policy(tmp_path):
    """The device dt chain (dtDevice 1) is the non-pipelined policy (no
    margin, no growth bound): only f32-against-f64 dt round-off separates
    the runs."""
    runs = {}
    for pipe, dtd in ((True, 1), (False, 0)):
        d = AMRSimulation(_tgv_cfg(tmp_path / str(pipe), pipelined=pipe,
                                   dtDevice=dtd), device="cpu")
        d.init()
        d.adapt_enabled = False
        assert d._use_device_dt() == (dtd == 1) == d._dt_chain
        d.simulate()
        runs[pipe] = d
    dev, host = runs[True], runs[False]
    assert dev.step_idx == host.step_idx == 8
    assert abs(dev.time - host.time) < 1e-4 * host.time
    np.testing.assert_allclose([r["dt"] for r in dev.step_log],
                               [r["dt"] for r in host.step_log], rtol=1e-6)
    np.testing.assert_allclose(twins.velocity(dev), twins.velocity(host),
                               atol=2e-4)
    # on by default only on the card; never with bodies or on shards
    cpu = AMRSimulation(_tgv_cfg(tmp_path / "d", pipelined=True),
                        device="cpu")
    cpu.init()
    assert not cpu._dt_chain


def test_sharded_pipelined_forest(tmp_path, monkeypatch):
    from cup3d_tpu_torch.parallel.forest import make_block_mesh

    monkeypatch.setenv("CUP3D_RING_HALO", "1")
    runs = {}
    for tag, pipe, shards in (("pipe", True, 4), ("host", False, 4),
                              ("flat", True, 0)):
        mesh = (make_block_mesh([torch.device("cpu")] * shards) if shards
                else None)
        d = AMRSimulation(_tgv_cfg(tmp_path / tag, pipelined=pipe,
                                   dt=1e-3, nsteps=5), device="cpu",
                          mesh=mesh)
        d.init()
        d.adapt_enabled = False
        d.simulate()
        runs[tag] = d
    pipe, host, flat = runs["pipe"], runs["host"], runs["flat"]
    assert not pipe._dt_chain and pipe.forest.nb_pad > pipe.grid.nb
    assert torch.equal(pipe.state["vel"], host.state["vel"])
    assert torch.equal(pipe.state["p"], host.state["p"])
    assert not pipe.state["vel"][pipe.grid.nb:].any()
    np.testing.assert_allclose(twins.velocity(pipe), twins.velocity(flat),
                               atol=1e-5)
