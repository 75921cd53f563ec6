"""The port's mesh factory and x-slab sharded megaloop
(cup3d_tpu_torch/parallel/{mesh,topology,collectives}.py, the ``pad=``
hook of ops/advection.py, the sharded builders of sim/megaloop.py and
the ``CUP3D_MESH_X`` routing of sim/simulation.py) against the JAX
package's, at the sizes of tests/test_topology.py: the 16^3 Taylor-Green
(bpd 2) and the 32^3 StefanFish, K = 8.

- the factory: ``make_mesh2d`` shapes, ``CUP3D_MESH`` and its errors,
  ``_factor2(divide=)``, ``make_mesh``, placement determinism and the
  mesh state, each against the JAX function on the conftest's 8 virtual
  CPU devices (the port's entries are 8 shards of one CPU device);
- the ``megaloop_mesh`` gate, and the loud fallback of a grid that does
  not cut into the slabs (a warning and ``topology.megaloop_mesh_
  fallbacks``), routed as the JAX driver routes it; an iterative solver
  routes to the solo megaloop, as in JAX;
- the collectives on the shard axis; ``rk3_step(pad=pad_slab_vector)``
  on D slabs bitwise the unsharded ``rk3_step`` for periodic and wall x;
- the sharded TGV and fish megaloops (``CUP3D_MESH_X=4``) bitwise the
  port's solo megaloop, and against JAX's sharded megaloop: per-step
  rows within ROW_RTOL (TGV) / FISH_RTOL (fish, rigid state against its
  scale) of tests/test_torch_megaloop.py, the fish's position within
  1e-6, KE within 1e-6 relative for the TGV and within FISH_RTOL for
  the fish (whose solo megaloop differs from JAX's solo one by ~3e-6 in
  KE already).
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from cup3d_tpu.config import SimulationConfig as JConfig
from cup3d_tpu.parallel import mesh as jmesh
from cup3d_tpu.parallel import topology as jtopo
from cup3d_tpu.sim.simulation import Simulation as JSimulation
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.grid.uniform import BC, UniformGrid
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.ops.advection import rk3_step
from cup3d_tpu_torch.parallel import collectives as coll
from cup3d_tpu_torch.parallel import mesh as tmesh
from cup3d_tpu_torch.parallel import ring
from cup3d_tpu_torch.parallel import topology as topo
from cup3d_tpu_torch.parallel.compat import shard_view
from cup3d_tpu_torch.sim.simulation import Simulation
from test_torch_megaloop import (FISH_RTOL, ROW_RTOL, _fish, _jax_rows,
                                 _ke, _port_rows, _tgv)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
KE_RTOL = 1e-6   # sharded against solo (tests/test_topology.py)
POS_ATOL = 1e-6
FALLBACKS = "topology.megaloop_mesh_fallbacks"


@pytest.fixture(autouse=True)
def _no_mesh_env(monkeypatch):
    for k in ("CUP3D_MESH", "CUP3D_MESH_X", "CUP3D_DIST"):
        monkeypatch.delenv(k, raising=False)


# -- the factory -------------------------------------------------------------


def _shape(fn, *a, **kw):
    """The mesh array's shape, or the exception's type."""
    try:
        return tuple(fn(*a, **kw).devices.shape)
    except (ValueError, NotImplementedError) as e:
        return type(e)


MESH2D_CASES = [dict(), dict(lanes=2, x=4), dict(x=2), dict(lanes=4),
                dict(lanes=3), dict(lanes=2, x=2), dict(x=3), dict(x=8)]


def test_make_mesh2d_shapes_env_and_errors_match_jax(monkeypatch):
    jdevs, tdevs = jax.devices()[:8], [CPU] * 8
    for kw in MESH2D_CASES:
        want = _shape(jtopo.make_mesh2d, devices=jdevs, **kw)
        assert _shape(topo.make_mesh2d, devices=tdevs, **kw) == want, kw
    for env in ("2x4", "4x2", "1x8", "bogus", "auto", "3x3"):
        monkeypatch.setenv("CUP3D_MESH", env)
        want = _shape(jtopo.make_mesh2d, devices=jdevs)
        assert _shape(topo.make_mesh2d, devices=tdevs) == want, env
    monkeypatch.delenv("CUP3D_MESH")
    m = topo.make_mesh2d(lanes=2, x=4, devices=tdevs)
    assert m.axis_names == ("lanes", "x") and m.shape == {"lanes": 2, "x": 4}
    assert topo.mesh_axis_size(m, "x") == 4
    assert topo.mesh_axis_size(m, "y") == 1
    # shards of distinct devices: transport between cards
    with pytest.raises(NotImplementedError, match="A7"):
        topo.make_mesh2d(devices=[CPU, torch.device("meta")])


def test_factor2_and_make_mesh_match_jax():
    for n in range(1, 13):
        for divide in (None, (48, 64), (64, 48), (64, 64), (12, 10)):
            try:
                want = jmesh._factor2(n, divide)
            except ValueError:
                with pytest.raises(ValueError):
                    tmesh._factor2(n, divide)
                continue
            assert tmesh._factor2(n, divide) == want, (n, divide)
    with pytest.raises(ValueError):
        tmesh._factor2(0)
    for n, divide in ((8, None), (6, None), (6, (64, 48)), (1, None)):
        want = jmesh.make_mesh(jax.devices()[:n], divide=divide).shape
        got = tmesh.make_mesh([CPU] * n, divide=divide).shape
        assert got == dict(want), (n, divide)
    # a field viewed by shard: entry [i, j] the (i, j) shard's block
    mesh = tmesh.make_mesh([CPU] * 8)
    f = torch.arange(8 * 6 * 4 * 3, dtype=torch.float32).reshape(8, 6, 4, 3)
    v = tmesh.shard_field(f, mesh)
    assert v.shape == (4, 2, 2, 3, 4, 3)
    assert v.data_ptr() == f.data_ptr()
    assert torch.equal(v[3, 1], f[6:8, 3:6])
    assert tmesh.field_sharding(mesh).spec == ("x", "y", None, None)
    assert tmesh.scalar_sharding(mesh).spec == ("x", "y", None)


def test_placement_map_and_mesh_state():
    mk = lambda: topo.make_mesh2d(lanes=2, x=4, devices=[CPU] * 8)  # noqa
    pm = topo.placement_map(mk())
    assert pm == topo.placement_map(mk())  # a function of the shard list
    want = jtopo.placement_map(jtopo.make_mesh2d(
        lanes=2, x=4, devices=jax.devices()[:8]))
    assert [(e["lane_shard"], e["x_shard"]) for e in pm] == [
        (e["lane_shard"], e["x_shard"]) for e in want]
    assert {e["platform"] for e in pm} == {"cpu"}
    st = topo.mesh_state(mk(), fallbacks=3)
    assert set(st) == set(jtopo.mesh_state(None)) | {"placement"}
    assert st["active"] and st["shape"] == [2, 4] and st["devices"] == 8
    assert st["fallbacks"] == 3 and st["placement"] == pm
    off = topo.mesh_state(None)
    assert not off["active"] and off["devices"] == 0


def test_dist_states_and_the_multi_process_refusal(monkeypatch):
    assert topo.dist_init("0")["mode"] == "off"
    monkeypatch.setenv("CUP3D_DIST_NPROCS", "1")
    st = topo.dist_init("auto")
    assert st["mode"] == "single" and st["processes"] == 1
    assert topo.dist_state() == st
    monkeypatch.setenv("CUP3D_DIST_NPROCS", "2")
    for spec in ("auto", "localhost:1234"):
        with pytest.raises(NotImplementedError, match="A7"):
            topo.dist_init(spec)
    assert topo.dist_init("off")["mode"] == "off"


def test_shard_carry_and_the_collectives():
    mesh = topo.make_mesh2d(lanes=1, x=4, devices=[CPU] * 4)
    carry = {"vel": torch.zeros(8, 4, 4, 3), "time": torch.tensor(0.0)}
    out = topo.shard_carry(carry, mesh)
    assert out["vel"] is carry["vel"] and out["time"] is carry["time"]
    with pytest.raises(ValueError, match="slabs"):
        topo.shard_carry({"p": torch.zeros(6, 4, 4)}, mesh)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 5, generator=gen)
    g = coll.all_gather_tiled(x)
    assert g.shape == (12, 5) and g.data_ptr() == x.data_ptr()
    assert torch.equal(coll.all_gather_tiled(x, axis=1),
                       torch.cat(list(x), dim=1))
    assert torch.equal(coll.pmax_axis(x), torch.amax(x, dim=0))
    assert torch.equal(coll.psum_axis(x), ((x[0] + x[1]) + x[2]) + x[3])
    xb = x.to(torch.bfloat16)
    sb = coll.psum_axis(xb)
    assert sb.dtype == torch.float32
    f = xb.float()
    assert torch.equal(sb, ((f[0] + f[1]) + f[2]) + f[3])


# -- the slab padding and the advection hook ---------------------------------


@pytest.mark.parametrize("bc_x", [BC.periodic, BC.wall])
def test_rk3_on_slabs_is_the_unsharded_rk3_bitwise(bc_x):
    D, n = 4, 16
    grid = UniformGrid((n, n, n), (1.0, 1.0, 1.0),
                       (bc_x, BC.periodic, BC.wall))
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.standard_normal((n, n, n, 3)), dtype=torch.float32)
    uinf = torch.tensor([0.3, -0.1, 0.2])
    dt = torch.tensor(1e-3)
    want = rk3_step(grid, u, dt, 1e-2, uinf)
    got = rk3_step(grid, shard_view(u, D), dt, 1e-2, uinf,
                   pad=lambda v, w: ring.pad_slab_vector(grid, v, w))
    assert got.shape == (D, n // D, n, n, 3)
    assert torch.equal(coll.all_gather_tiled(got), want)


# -- routing -----------------------------------------------------------------


def test_megaloop_mesh_gate_and_the_loud_fallback(tmp_path, monkeypatch):
    assert topo.megaloop_mesh(CPU) is None
    monkeypatch.setenv("CUP3D_MESH_X", "4")
    m = topo.megaloop_mesh(CPU)
    assert m.devices.shape == (1, 4) and m.device == CPU
    before = M.counter(FALLBACKS).value
    for v in ("bogus", "1", "0"):
        monkeypatch.setenv("CUP3D_MESH_X", v)
        assert topo.megaloop_mesh(CPU) is None
    assert M.counter(FALLBACKS).value == before
    # nx = 16 does not cut into 3 slabs, nor into 8 of >= 3 planes: both
    # packages warn, count and run the solo megaloop
    from cup3d_tpu.obs import metrics as JM

    for mx in ("3", "8"):
        monkeypatch.setenv("CUP3D_MESH_X", mx)
        jb = JM.counter(FALLBACKS).value
        j = JSimulation(_tgv(JConfig, tmp_path / "jax", scan_k=8))
        j.init()
        with pytest.warns(UserWarning, match="unsharded"):
            assert j._scan_ready()
        assert j._scan_mesh is None and JM.counter(FALLBACKS).value == jb + 1
        tb = M.counter(FALLBACKS).value
        t = Simulation(_tgv(SimulationConfig, tmp_path / mx, scan_k=8),
                       device="cpu")
        t.init()
        with pytest.warns(UserWarning, match="unsharded"):
            assert t._scan_ready()
        assert t._scan_mesh is None and M.counter(FALLBACKS).value == tb + 1


def test_iterative_solver_routes_to_the_solo_megaloop(tmp_path, monkeypatch):
    """Config #2 as it stands (iterative Poisson) under CUP3D_MESH_X=4
    takes the solo megaloop in both packages, with no warning and no
    counted fallback."""
    monkeypatch.setenv("CUP3D_MESH_X", "4")
    before = M.counter(FALLBACKS).value
    for kind, C, S, kw in (("jax", JConfig, JSimulation, {}),
                           ("port", SimulationConfig, Simulation,
                            {"device": "cpu"})):
        for mk in (_tgv, _fish):
            d = S(mk(C, tmp_path / kind, scan_k=8,
                     poissonSolver="iterative"), **kw)
            d.init()
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                assert d._scan_ready()
            assert d._scan_k == 8 and d._scan_mesh is None, (kind, mk)
    assert M.counter(FALLBACKS).value == before


# -- the sharded megaloops ---------------------------------------------------


def _run(S, cfg, mesh_x, **kw):
    os.environ.pop("CUP3D_MESH_X", None)
    if mesh_x:
        os.environ["CUP3D_MESH_X"] = str(mesh_x)
    try:
        d = S(cfg, **kw)
        d.init()
        d.simulate()
    finally:
        os.environ.pop("CUP3D_MESH_X", None)
    return d


@pytest.mark.parametrize("case", ["tgv", "fish"])
def test_sharded_megaloop_is_the_solo_one_and_matches_jax(tmp_path, case):
    mk = _tgv if case == "tgv" else _fish
    solo = _run(Simulation, mk(SimulationConfig, tmp_path / "solo",
                               scan_k=8), 0, device="cpu")
    shd = _run(Simulation, mk(SimulationConfig, tmp_path / "shd", scan_k=8),
               4, device="cpu")
    assert solo._scan_mesh is None and shd._scan_mesh is not None
    assert shd._scan_mesh.devices.shape == (1, 4)
    assert solo.sim.step == shd.sim.step == shd.cfg.nsteps
    assert all(r["scan"] for r in shd.step_log)
    for k in solo.sim.state:
        assert torch.equal(shd.sim.state[k], solo.sim.state[k]), k
        assert shd.sim.state[k].shape == solo.sim.state[k].shape
    assert _port_rows(shd).tolist() == _port_rows(solo).tolist()
    j = _run(JSimulation, mk(JConfig, tmp_path / "jax", scan_k=8), 4)
    assert j._scan_mesh is not None
    # KE against JAX's: 1e-6 relative for the TGV; the fish's solo
    # megaloop already differs from JAX's solo one by ~3e-6 relative in
    # KE (f32 sums in another order, held at FISH_RTOL by
    # tests/test_torch_megaloop.py), and the sharded one is bitwise the
    # solo one, so the fish is held to that bound
    ke, ke_j = _ke(shd.sim.state["vel"]), _ke(j.sim.state["vel"])
    ke_rtol = KE_RTOL if case == "tgv" else FISH_RTOL
    assert abs(ke - ke_j) <= ke_rtol * abs(ke_j)
    if case == "tgv":
        np.testing.assert_allclose(_port_rows(shd), _jax_rows(j),
                                   rtol=ROW_RTOL)
        return
    np.testing.assert_allclose(_port_rows(shd), _jax_rows(j), rtol=FISH_RTOL)
    jo, to = j.sim.obstacles[0], shd.sim.obstacles[0]
    np.testing.assert_allclose(to.position, jo.position, rtol=0,
                               atol=POS_ATOL)
    for name in ("transVel", "angVel", "quaternion"):
        want = np.asarray(getattr(jo, name), np.float64)
        got = np.asarray(getattr(to, name), np.float64)
        assert np.abs(got - want).max() <= FISH_RTOL * max(
            np.abs(want).max(), 1e-12), name
