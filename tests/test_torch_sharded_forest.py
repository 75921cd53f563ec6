"""The port's block-sharded forest (parallel/forest.py, parallel/faces.py,
the static solver of ops/amr_ops.py and the ``mesh=`` mode of
sim/amr.py) against the JAX package's and against the port's own
unsharded forest.

Forests: tests/test_forest.py's 22-block ``_grid()`` (a 2x2x2 base,
levelMax 3, two octants refined) cut into D = 8 shards of 3 blocks
(nb_pad 24), and its 15-block tree (nb not divisible by D: 2 blocks a
shard, the last shard half padding).  The JAX side runs on the
conftest's 8 virtual CPU devices; the port's shards are a leading axis of
one CPU tensor (``make_block_mesh([cpu] * 8)``).

- the padding (``count_capacity``, nbs, nb_pad) and every exchange
  table (``send_idx`` of the lab, face and flux tables): equal to JAX's;
- lab and face assembly at widths 1 and 3, the refluxed Laplacian, the
  flux apply and one RK3 step: bitwise equal to the port's unsharded
  forest (the padding rows exactly 0) on both forests, and on the
  22-block one within 1e-6 of the max |value| of the JAX sharded
  forest's (1e-5 for the operators: f32 stencils summed in another
  order, the bounds of tests/test_torch_amr_grid.py and
  tests/test_torch_amr_ops.py; ROADMAP ground rule 2); the 15-block
  forest meets JAX through the driver below;
- the ring transport (``CUP3D_RING_HALO=1``) bitwise equal to the axis
  swap;
- the static tile-only solve within 1e-5 of the JAX sharded solve (the
  JAX package's own sharded-vs-single bound), its iterations within the
  range the JAX sharded solve's own count spans under 1e-7 input noise
  (8 draws), widened by one (ground rule 2's tile-only rule), and equal
  to the unsharded static solve's; the sharded Helmholtz solve of
  implicit diffusion (padding rows 0) within 1e-4 of the input's max of
  the unsharded forest's;
- two steps of ``AMRSimulation(mesh=...)`` TGV on the 15-block tree
  against the JAX mesh driver (fields within 5e-4, tests/test_forest.py's
  driver bound), the state round trip unpadded and a recovery restore;
- distinct devices raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.config import SimulationConfig as JCfg
from cup3d_tpu.grid import bucket as jbucket
from cup3d_tpu.grid.blocks import BlockGrid as JGrid
from cup3d_tpu.grid.flux import build_flux_tables as jflux
from cup3d_tpu.grid.octree import Octree as JTree
from cup3d_tpu.grid.octree import TreeConfig as JTreeCfg
from cup3d_tpu.grid.uniform import BC as JBC
from cup3d_tpu.ops import amr_ops as jops
from cup3d_tpu.parallel.forest import ShardedForest as JForest
from cup3d_tpu.parallel.forest import make_block_mesh as jmesh
from cup3d_tpu.sim.amr import AMRSimulation as JSim
from cup3d_tpu_torch.config import SimulationConfig as TCfg
from cup3d_tpu_torch.grid import bucket as tbucket
from cup3d_tpu_torch.grid.blocks import BlockGrid as TGrid
from cup3d_tpu_torch.grid.flux import build_flux_tables as tflux
from cup3d_tpu_torch.grid.octree import Octree as TTree
from cup3d_tpu_torch.grid.octree import TreeConfig as TTreeCfg
from cup3d_tpu_torch.grid.uniform import BC as TBC
from cup3d_tpu_torch.io.checkpoint import build_payload
from cup3d_tpu_torch.ops import amr_ops as tops
from cup3d_tpu_torch.ops import krylov as tk
from cup3d_tpu_torch.parallel.forest import ShardedForest as TForest
from cup3d_tpu_torch.parallel.forest import make_block_mesh
from cup3d_tpu_torch.sim.amr import AMRSimulation as TSim
from cup3d_tpu_torch.sim.amr import load_state_numpy, state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BS = 8
D = 8
CPU = torch.device("cpu")
LAB_RTOL = 1e-6     # assembly, across frameworks
OP_RTOL = 1e-5      # operators, across frameworks
SOLVE_ATOL = 1e-5
DRIVER_ATOL = 5e-4
N_NOISE = 8         # perturbed JAX solves that measure its own range
NOISE = 1e-7        # their rhs perturbation, relative to max |rhs|
NOISE_SEED = 1
WIDTHS = (1, 3)
REFINE22 = ((0, 0, 0, 0), (0, 1, 1, 1))
REFINE15 = ((0, 0, 0, 0),)


def _grids(level_max, refine):
    jt = JTree(JTreeCfg((2, 2, 2), level_max, (True,) * 3), 0)
    tt = TTree(TTreeCfg((2, 2, 2), level_max, (True,) * 3), 0)
    for k in refine:
        jt.refine(k)
        tt.refine(k)
    return (JGrid(jt, (1.0,) * 3, (JBC.periodic,) * 3),
            TGrid(tt, (1.0,) * 3, (TBC.periodic,) * 3))


def _close(got, want, rtol):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


class Pair:
    """One forest in both packages, sharded over D shards, with seeded
    fields and the JAX side's results (one jit)."""

    def __init__(self, level_max, refine, with_jax=False):
        self.jg, self.tg = _grids(level_max, refine)
        self.jfo = JForest(self.jg, jmesh(jax.devices()[:D]))
        self.tfo = TForest(self.tg, make_block_mesh([CPU] * D))
        rng = np.random.default_rng(0)
        nb = self.jg.nb
        self.f = rng.standard_normal((nb, BS, BS, BS)).astype(np.float32)
        self.v = rng.standard_normal((nb, BS, BS, BS, 3)).astype(np.float32)
        self.want = {}
        if with_jax:
            self._run_jax(rng)

    def _run_jax(self, rng):
        jfo = self.jfo
        for w in WIDTHS:  # host tables, built outside the trace
            jfo.lab_tables(w), jfo.face_tables(w)
        jfo.flux_tables

        def run(f, v):
            out = {}
            for w in WIDTHS:
                for kind in ("lab", "face"):
                    t = getattr(jfo, f"{kind}_tables")(w)
                    out[f"{kind}{w}s"] = t.assemble_scalar(f, BS)
                    out[f"{kind}{w}v"] = t.assemble_vector(v, BS)
            out["lap"] = jops.laplacian_blocks(jfo.geom, f,
                                               jfo.face_tables(1),
                                               jfo.flux_tables)
            out["rk3"] = jops.rk3_step_blocks(
                jfo.geom, 0.1 * v, 1e-3, 1e-3, jnp.zeros(3, jnp.float32),
                jfo.face_tables(3), jfo.flux_tables)
            return out

        self.want = {k: np.asarray(jfo.unpad(a)) for k, a in
                     jax.jit(run)(jfo.pad(self.f), jfo.pad(self.v)).items()}
        js = jax.jit(lambda r: jfo.build_poisson_solver()(r, with_stats=True))
        x, st = js(jfo.pad(self.f))
        self.want["x"] = np.asarray(jfo.unpad(x))
        self.want["its"] = int(st[1])
        noise = NOISE * float(np.abs(self.f).max())
        nrng = np.random.default_rng(NOISE_SEED)
        self.want["its_noise"] = [
            int(js(jfo.pad(self.f + noise * nrng.standard_normal(
                self.f.shape).astype(np.float32)))[1][1])
            for _ in range(N_NOISE)]

    def pad(self, a):
        return self.tfo.pad(torch.as_tensor(a))


@pytest.fixture(scope="module")
def p22():
    return Pair(3, REFINE22, with_jax=True)


@pytest.fixture(scope="module")
def p15():
    return Pair(2, REFINE15)


def _pair(request, name):
    return request.getfixturevalue(name)


@pytest.mark.parametrize("name", ["p22", "p15"])
def test_padding_and_exchange_tables_match_jax(request, name):
    P = _pair(request, name)
    jfo, tfo = P.jfo, P.tfo
    for n in (0, 1, 3, 15, 22, 9472, 2368):
        assert tbucket.count_capacity(n, base=1) == jbucket.count_capacity(
            n, base=1)
        assert tbucket.count_capacity(n) == jbucket.count_capacity(n)
    assert (tfo.nbs, tfo.nb_pad) == (jfo.nbs, jfo.nb_pad)
    assert tfo.nb_pad > tfo.grid.nb or name == "p22"
    np.testing.assert_array_equal(tfo.vol.numpy(), np.asarray(jfo.vol))
    np.testing.assert_array_equal(tfo.pmask.numpy(), np.asarray(jfo.pmask))
    for w in WIDTHS:
        np.testing.assert_array_equal(tfo.lab_tables(w).send_idx,
                                      np.asarray(jfo.lab_tables(w).send_idx))
        jt, tt = jfo.face_tables(w), tfo.face_tables(w)
        assert (tt.ns_max, tt.n_local, tt.zero_row) == (
            jt.ns_max, jt.n_local, jt.zero_row)
        jplans = [p for _, _, p in jt.groups] + [jt.final_plan]
        tplans = [p for _, _, p in tt.groups] + [tt.final_plan]
        assert len(jplans) == len(tplans)
        for jp, tp in zip(jplans, tplans):
            assert (tp.M, tp.recv_off) == (jp.M, jp.recv_off)
            assert (tp.send_idx is None) == (jp.send_idx is None)
            if tp.send_idx is not None:
                np.testing.assert_array_equal(tp.send_idx,
                                              np.asarray(jp.send_idx))
        np.testing.assert_array_equal(tt.src_idx, np.asarray(jt.src))
    np.testing.assert_array_equal(tfo.flux_tables.send_idx,
                                  np.asarray(jfo.flux_tables.send_idx))
    # at least one exchange really crosses shards
    assert any(p.send_idx is not None for p in tplans)


@pytest.mark.parametrize("name", ["p22", "p15"])
@pytest.mark.parametrize("kind", ["lab", "face"])
@pytest.mark.parametrize("width", WIDTHS)
def test_assembly_matches_unsharded_and_jax(request, name, kind, width):
    P = _pair(request, name)
    tfo, tg = P.tfo, P.tg
    st = getattr(tfo, f"{kind}_tables")(width)
    ut = getattr(tg, f"{kind}_tables")(width)
    got_s = st.assemble_scalar(P.pad(P.f), BS)
    got_v = st.assemble_vector(P.pad(P.v), BS)
    assert torch.equal(tfo.unpad(got_s),
                       ut.assemble_scalar(torch.as_tensor(P.f), BS))
    assert torch.equal(tfo.unpad(got_v),
                       ut.assemble_vector(torch.as_tensor(P.v), BS))
    assert not got_s[tg.nb:].any() and not got_v[tg.nb:].any()
    if P.want:
        _close(tfo.unpad(got_s), P.want[f"{kind}{width}s"], LAB_RTOL)
        _close(tfo.unpad(got_v), P.want[f"{kind}{width}v"], LAB_RTOL)
    comp = st.assemble_component(P.pad(P.v[..., 1]), BS, 1)
    assert torch.equal(tfo.unpad(comp), ut.assemble_component(
        torch.as_tensor(P.v[..., 1]), BS, 1))


@pytest.mark.parametrize("name", ["p22", "p15"])
def test_refluxed_laplacian_and_rk3_match_unsharded_and_jax(request, name):
    P = _pair(request, name)
    tfo, tg = P.tfo, P.tg
    ft = tflux(tg)
    assert tfo.flux_tables.ncorr == ft.ncorr > 0
    sh = tops.laplacian_blocks(tfo.geom, P.pad(P.f), tfo.face_tables(1),
                               tfo.flux_tables)
    ref = tops.laplacian_blocks(tg, torch.as_tensor(P.f), tg.face_tables(1),
                                ft)
    assert torch.equal(tfo.unpad(sh), ref) and not sh[tg.nb:].any()
    if P.want:
        _close(tfo.unpad(sh), P.want["lap"], OP_RTOL)
    args = (torch.tensor(1e-3), 1e-3, torch.zeros(3))
    sh = tops.rk3_step_blocks(tfo.geom, P.pad(0.1 * P.v), *args,
                              tfo.face_tables(3), tfo.flux_tables)
    ref = tops.rk3_step_blocks(tg, torch.as_tensor(0.1 * P.v), *args,
                               tg.face_tables(3), ft)
    assert torch.equal(tfo.unpad(sh), ref) and not sh[tg.nb:].any()
    if P.want:
        _close(tfo.unpad(sh), P.want["rk3"], OP_RTOL)
    # the flux apply alone, on a field with nonzero padding rows kept
    rng = np.random.default_rng(3)
    out = rng.standard_normal((tg.nb, BS, BS, BS)).astype(np.float32)
    fl = rng.standard_normal((tg.nb, 6, BS, BS)).astype(np.float32)
    got = tfo.flux_tables.apply(P.pad(out), P.pad(fl))
    assert torch.equal(tfo.unpad(got),
                       ft.apply(torch.as_tensor(out), torch.as_tensor(fl)))


@pytest.mark.parametrize("name", ["p22", "p15"])
def test_ring_transport_equals_the_axis_swap(request, name, monkeypatch):
    P = _pair(request, name)
    t3 = P.tfo.face_tables(3)
    monkeypatch.setenv("CUP3D_RING_HALO", "0")
    swap = t3.assemble_vector(P.pad(P.v), BS)
    monkeypatch.setenv("CUP3D_RING_HALO", "1")
    assert torch.equal(t3.assemble_vector(P.pad(P.v), BS), swap)


def test_static_solve_matches_jax_sharded(p22):
    P = p22
    tk.iterations["executed"] = 0
    x, st = P.tfo.build_poisson_solver()(P.pad(P.f), with_stats=True)
    assert not x[P.tg.nb:].any()
    np.testing.assert_allclose(P.tfo.unpad(x).numpy(), P.want["x"],
                               atol=SOLVE_ATOL, rtol=0)
    k = int(st[1])
    ks = P.want["its_noise"] + [P.want["its"]]
    assert min(ks) - 1 <= k <= max(ks) + 1, (k, ks)
    assert tk.iterations["executed"] >= k > 0
    # the sharded solve's geometry has no tree: tile-only, whatever
    # CUP3D_COARSE says; the unsharded static solve with two_level=False
    # is the same composition
    x1, st1 = tops.build_amr_poisson_solver(P.tg, two_level=False)(
        torch.as_tensor(P.f), with_stats=True)
    np.testing.assert_allclose(P.tfo.unpad(x).numpy(), x1.numpy(),
                               atol=SOLVE_ATOL, rtol=0)
    assert int(st1[1]) == k
    # the sharded Helmholtz solve of implicit diffusion: the forest solve
    # over the padded geometry and the duck-typed tables, its padding
    # rows 0, within the stopping target of the unsharded solve's
    from cup3d_tpu_torch.ops.diffusion import build_amr_helmholtz_solver

    nudt = 1e-4
    xs = P.tfo.build_helmholtz_solver()(P.pad(P.v), nudt)
    xu = build_amr_helmholtz_solver(P.tg)(torch.as_tensor(P.v), nudt)
    assert not xs[P.tg.nb:].any()
    np.testing.assert_allclose(P.tfo.unpad(xs).numpy(), xu.numpy(), rtol=0,
                               atol=1e-4 * float(np.abs(P.v).max()))


def _tgv_cfg(cls, out):
    return cls(bpdx=2, bpdy=2, bpdz=2, levelMax=2, levelStart=0, extent=1.0,
               nu=1e-3, nsteps=2, tend=0.0, verbose=False,
               poissonSolver="iterative", poissonTol=1e-3,
               poissonTolRel=1e-2, initCond="taylorGreen", Rtol=1e9,
               Ctol=-1.0, path4serialization=out)


def _tree15(tree_cls, cfg_cls):
    t = tree_cls(cfg_cls((2, 2, 2), 2, (True,) * 3), 0)
    t.refine((0, 0, 0, 0))  # 7 coarse + 8 fine = 15 leaves
    return t


@pytest.fixture(scope="module")
def jax_mesh_driver(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_mesh"))
    sim = JSim(_tgv_cfg(JCfg, out), tree=_tree15(JTree, JTreeCfg),
               mesh=jmesh(jax.devices()[:D]))
    sim.init()
    for _ in range(2):
        sim.advance(sim.calc_max_timestep())
    return {k: np.asarray(sim._unpad(sim.state[k])) for k in ("vel", "p")}


def test_mesh_driver_matches_jax_mesh_driver(jax_mesh_driver, tmp_path,
                                             monkeypatch):
    """The nb-not-divisible config (15 blocks on 8 shards): padding on
    every state-assignment path, _ic included; two steps on the ring
    transport and two on the axis swap, bitwise equal."""
    runs = {}
    for halo in ("1", "0"):
        monkeypatch.setenv("CUP3D_RING_HALO", halo)
        sim = TSim(_tgv_cfg(TCfg, str(tmp_path)),
                   tree=_tree15(TTree, TTreeCfg),
                   mesh=make_block_mesh([CPU] * D))
        sim.init()
        assert sim.grid.nb % D != 0
        assert sim.state["vel"].shape[0] == sim.forest.nb_pad == 16
        for _ in range(2):
            sim.advance(sim.calc_max_timestep())
        assert not sim.state["vel"][sim.grid.nb:].any()
        runs[halo] = state_to_numpy(sim)[0]
    for k in ("vel", "p"):
        np.testing.assert_array_equal(runs["1"][k], runs["0"][k])
        np.testing.assert_allclose(runs["1"][k], jax_mesh_driver[k],
                                   atol=DRIVER_ATOL, rtol=0)
    assert sim._flight_state()["shards"] == D and sim._graph is None

    # the state round trip is unpadded; a restore pads the snapshot's
    # (padded) fields and replays the next step bitwise
    arrays, scalars = state_to_numpy(sim)
    assert arrays["vel"].shape[0] == sim.grid.nb
    payload = build_payload(sim)
    payload["fields"] = {k: v.clone() for k, v in payload["fields"].items()}
    sim.advance(sim.calc_max_timestep())
    after = sim.state["vel"].clone()
    sim._resilience_restore(payload)
    assert sim.state["vel"].shape[0] == sim.forest.nb_pad
    sim.advance(sim.calc_max_timestep())
    assert torch.equal(sim.state["vel"], after)
    load_state_numpy(sim, arrays, scalars)
    assert sim.state["p"].shape[0] == sim.forest.nb_pad
    np.testing.assert_array_equal(state_to_numpy(sim)[0]["vel"],
                                  arrays["vel"])


def test_distinct_devices_raise(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="A7"):
        make_block_mesh([CPU, torch.device("meta")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_block_mesh()
    with pytest.raises(ValueError, match="mesh"):
        TSim(_tgv_cfg(TCfg, str(tmp_path)), device="meta",
             mesh=make_block_mesh([CPU] * 2))
