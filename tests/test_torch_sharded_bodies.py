"""Bodies on the port's block-sharded forest (``AMRSimulation(cfg,
mesh=...)`` of cup3d_tpu_torch/sim/amr.py) and ``load_checkpoint(path,
mesh=)`` (io/checkpoint.py), against the port's unsharded forest and the
JAX package.

The sphere case: a free sphere (radius 0.1, off the flow's symmetry
points) in the Taylor-Green flow of a bpd-2, levelMax-2 box, Rtol 1e9 and
Ctol -1 (no vorticity-driven regrid): init refines the octant that holds
the sphere, 8 -> 15 blocks (a regrid with a body, re-sharded through
``cached_forest``), padded on 8 shards to nb_pad 16.

- host path and pipelined, 3 steps each, sharded against unsharded:
  positions within 1e-7, transVel within 1e-5, the velocity within 5e-4
  (tests/test_forest.py's driver bounds); the padding rows of every
  field stay 0;
- the mesh branch of create_obstacles against the JAX mesh driver's
  (``AMRSimulation(mesh=make_block_mesh(jax.devices()[:8]))`` on the same
  tree): its padded cell centres, spacing and volumes, and the chi the
  JAX mesh driver's sharded face tables and Towers chi give for the
  port's padded SDF;
- the JAX package's two spheres pipelined (tests/test_torch_jax_twins.py
  "amr_spheres", 8 blocks) against the port on 3 shards (nb_pad 9):
  the bounds of tests/test_torch_amr_pipelined.py;
- checkpoints: a JAX-written forest checkpoint restored sharded (padded
  as a fresh mesh run) and stepped beside its unsharded restore; the
  sphere saved unsharded restored sharded, and saved sharded restored
  unsharded and by the JAX package.

The JAX mesh driver with a body steps in tens of seconds a step on the
CPU (its eager shard_map compiles op by op), so it is held here through
its mesh-branch pieces, and the stepping through the JAX twin.
"""

import jax
import numpy as np
import pytest
import torch

from cup3d_tpu.config import SimulationConfig as JCfg
from cup3d_tpu.grid.octree import Octree as JTree
from cup3d_tpu.grid.octree import TreeConfig as JTreeCfg
from cup3d_tpu.io import checkpoint as jckpt
from cup3d_tpu.ops.chi import towers_chi as jtowers_chi
from cup3d_tpu.parallel.forest import make_block_mesh as jmesh
from cup3d_tpu.sim.amr import AMRSimulation as JSim
from cup3d_tpu_torch.config import SimulationConfig as TCfg
from cup3d_tpu_torch.config import parse_args
from cup3d_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from cup3d_tpu_torch.parallel.forest import make_block_mesh
from cup3d_tpu_torch.sim.amr import AMRSimulation as TSim

import test_torch_jax_twins as twins
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
D = 8
POS_ATOL = 1e-7     # tests/test_forest.py's driver bounds
VEL_ATOL = 1e-5     # (transVel)
FIELD_ATOL = 5e-4
STEPS = 3
SPHERE = "Sphere radius=0.1 xpos=0.3 ypos=0.2 zpos=0.25"


def _cfg(C, out, **kw):
    base = dict(bpdx=2, bpdy=2, bpdz=2, levelMax=2, levelStart=0,
                extent=1.0, CFL=0.4, Rtol=1e9, Ctol=-1.0, nu=1e-3, tend=0.0,
                nsteps=STEPS, rampup=0, dt=1e-3, poissonSolver="iterative",
                poissonTol=1e-5, poissonTolRel=1e-3, initCond="taylorGreen",
                factory_content=SPHERE, verbose=False, freqDiagnostics=0,
                path4serialization=str(out))
    base.update(kw)
    return C(**base)


def _mesh(n=D):
    return make_block_mesh([CPU] * n)


def _port(out, mesh=None, steps=STEPS, **kw):
    d = TSim(_cfg(TCfg, out, **kw), device="cpu", mesh=mesh)
    d.init()
    for _ in range(steps):
        d.advance(d.calc_max_timestep())
    if d.cfg.pipelined:
        d.flush_packs()
    return d


def _vel(d):
    return d._unpad(d.state["vel"]).numpy()


def _assert_padding_zero(d):
    for k, v in d.state.items():
        assert not v[d.grid.nb:].any(), k
    for ob in d.obstacles:
        for name in ("sdf", "chi", "udef"):
            assert not getattr(ob, name)[d.grid.nb:].any(), name


def _assert_same_run(a, b, field_atol=FIELD_ATOL):
    assert a.grid.keys == b.grid.keys and a.step_idx == b.step_idx
    for oa, ob in zip(a.obstacles, b.obstacles):
        np.testing.assert_allclose(oa.position, ob.position, rtol=0,
                                   atol=POS_ATOL)
        np.testing.assert_allclose(oa.transVel, ob.transVel, rtol=0,
                                   atol=VEL_ATOL)
    np.testing.assert_allclose(_vel(a), _vel(b), rtol=0, atol=field_atol)


@pytest.mark.parametrize("pipelined", [False, True])
def test_sphere_on_the_sharded_forest_matches_unsharded(tmp_path, pipelined):
    ref = _port(tmp_path / "u", pipelined=pipelined)
    sh = _port(tmp_path / "s", mesh=_mesh(), pipelined=pipelined)
    assert sh.grid.nb == 15 and sh.forest.nb_pad == 16
    assert sh.state["vel"].shape[0] == 16 and sh._graph is None
    assert sh._flight_state()["shards"] == D
    # the sphere moves with the flow: its transVel is the flow's push
    assert np.abs(sh.obstacles[0].transVel).max() > 1e-3
    _assert_padding_zero(sh)
    _assert_same_run(sh, ref)
    if pipelined:
        assert sh.obstacles[0]._dev_rigid is not None  # the megastep ran
        assert len(sh.step_log) == STEPS


def test_mesh_branch_of_create_obstacles_is_the_jax_mesh_drivers(tmp_path):
    sh = TSim(_cfg(TCfg, tmp_path / "t"), device="cpu", mesh=_mesh())
    sh.init()
    tree = JTree(JTreeCfg((2, 2, 2), 2, (True,) * 3), 0)
    tree.refine((0, 0, 0, 0))  # the octant init refines about the sphere
    j = JSim(_cfg(JCfg, tmp_path / "j"), tree=tree,
             mesh=jmesh(jax.devices()[:D]))
    assert list(j.grid.keys) == sh.grid.keys
    assert j.forest.nb_pad == sh.forest.nb_pad
    for name in ("_xc", "_h_col", "_vol"):
        np.testing.assert_array_equal(getattr(sh, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    ob = sh.obstacles[0]
    chi = jax.jit(lambda s: jtowers_chi(
        j._tab1.assemble_scalar(s, j.grid.bs), j._h_col))(
            ob.sdf.numpy())
    np.testing.assert_allclose(ob.chi.numpy(), np.asarray(chi), rtol=0,
                               atol=1e-6)
    assert float(ob.chi.sum()) > 0 and not ob.chi[sh.grid.nb:].any()


def test_two_spheres_pipelined_on_shards_match_jax(tmp_path):
    """tests/test_torch_amr_pipelined.py's spheres case: the JAX twin
    against the port on 3 shards (8 blocks, nb_pad 9)."""
    nsteps = 2
    js = twins.jax_driver("amr_spheres", tmp_path / "jax", nsteps)
    js.simulate()
    js.flush_packs()
    cfg = parse_args(twins.argv("amr_spheres", tmp_path / "p", nsteps))
    sh = TSim(cfg, device="cpu", mesh=_mesh(3))
    sh.init()
    sh.simulate()
    assert sh.forest.nb_pad == 9 and sh.grid.nb == 8
    assert sh.grid.keys == list(js.grid.keys)
    _assert_padding_zero(sh)
    for op, oj in zip(sh.obstacles, js.obstacles):
        np.testing.assert_allclose(op.position, oj.position, rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(op.transVel, oj.transVel, rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(op.force, oj.force, rtol=2e-3,
                                   atol=1e-5)
    np.testing.assert_allclose(twins.velocity(sh), twins.velocity(js),
                               atol=5e-5)


def test_jax_checkpoint_restores_sharded(tmp_path):
    """A forest checkpoint the JAX package wrote unsharded: restored on 3
    shards padded as a fresh mesh run (8 blocks, nb_pad 9, zero padding
    rows, the real rows the file's), then 2 steps beside its unsharded
    restore."""
    j = twins.jax_driver("amr", tmp_path / "jax", 2)
    path = jckpt.save_checkpoint(j, str(tmp_path / "jax.pkl"))
    runs = {}
    for name, mesh in (("sh", _mesh(3)), ("u", None)):
        d = load_checkpoint(path, device="cpu", mesh=mesh)
        if mesh is not None:
            fresh = TSim(d.cfg, tree=d.grid.tree, mesh=_mesh(3))
            assert d.forest.nb_pad == fresh.forest.nb_pad == 9
            for k in d.state:
                assert d.state[k].shape == fresh.state[k].shape, k
                assert not d.state[k][d.grid.nb:].any(), k
        np.testing.assert_array_equal(_vel(d), twins.velocity(j))
        for _ in range(2):
            d.advance(1e-3)
        runs[name] = d
    np.testing.assert_allclose(_vel(runs["sh"]), _vel(runs["u"]), rtol=0,
                               atol=FIELD_ATOL)


def test_sphere_checkpoints_cross_the_layouts(tmp_path):
    """The sphere saved unsharded restores sharded and steps with the
    unsharded restore; saved sharded it restores unsharded, and an
    obstacle-free sharded save restores in the JAX package."""
    d = _port(tmp_path / "u", steps=1)
    path = save_checkpoint(d, str(tmp_path / "u.pkl"))
    sh = load_checkpoint(path, device="cpu", mesh=_mesh())
    ref = load_checkpoint(path, device="cpu")
    assert sh.forest.nb_pad == 16 and sh.state["vel"].shape[0] == 16
    np.testing.assert_array_equal(_vel(sh), _vel(d))
    for drv in (sh, ref):
        drv.adapt_enabled = False
        for _ in range(2):
            drv.advance(1e-3)
    _assert_padding_zero(sh)
    _assert_same_run(sh, ref)
    back = load_checkpoint(save_checkpoint(sh, str(tmp_path / "s.pkl")),
                           device="cpu")
    assert back.forest is None
    np.testing.assert_array_equal(_vel(back), _vel(sh))
    for ob_b, ob_s in zip(back.obstacles, sh.obstacles):
        np.testing.assert_array_equal(ob_b.position, ob_s.position)
    free = TSim(_cfg(TCfg, tmp_path / "f", factory_content=""),
                device="cpu", mesh=_mesh())
    free.init()
    free.advance(free.calc_max_timestep())
    jd = jckpt.load_checkpoint(save_checkpoint(free,
                                               str(tmp_path / "f.pkl")))
    np.testing.assert_array_equal(np.asarray(jd.state["vel"])[: jd.grid.nb],
                                  _vel(free))
