"""The port's capacity-bucketed forest (grid/bucket.py, the padded tables,
the on-device tags, sim/amr.py's bucketed driver) against the JAX
package's, on the CPU.

- ``capacity``/``count_capacity`` equal the JAX package's for n in
  0..5000;
- the padded face, flux and coarse-graph tables equal the JAX package's
  padded arrays on 8-27-block forests (periodic, closed boundaries with
  fallback rows, a refined corner), and the padded labs the JAX labs;
- ``device_tags`` equal the JAX package's exactly on seeded scores;
- a forced refine -> coarsen -> refine cycle (tests/test_bucketing.py's
  ``_states`` pattern on a bpd-2, levelMax-2 Taylor-Green forest, fixed
  dt): after each pair of steps the padding rows are exactly 0, the
  velocity is within the bound of tests/test_bucketing.py's
  ``test_bucketed_matches_unbucketed`` (1e-5) of the JAX bucketed
  driver's and of the port's own ``CUP3D_BUCKET=0`` driver's, one
  advection-diffusion application within its 1e-6; the ping-pong hits
  the table memo and the operator cache;
- one StefanFish on a small forest (config #4's, bpd 1, levelMax 3),
  bucketed, held to the JAX bucketed driver for two steps.
"""

import os

import numpy as np
import pytest
import torch

import cup3d_tpu.grid.bucket as jbk
from cup3d_tpu.config import SimulationConfig as JConfig
from cup3d_tpu.grid import adapt as jad
from cup3d_tpu.grid.blocks import BlockGrid as JGrid
from cup3d_tpu.grid.faces import pad_face_tables as jpad_faces
from cup3d_tpu.grid.flux import build_flux_tables as jflux
from cup3d_tpu.grid.flux import pad_flux_tables as jpad_flux
from cup3d_tpu.grid.octree import Octree as JOctree
from cup3d_tpu.grid.octree import TreeConfig as JTreeConfig
from cup3d_tpu.grid.uniform import BC as JBC
from cup3d_tpu.ops import krylov as jkrylov
from cup3d_tpu.sim.amr import AMRSimulation as JAMR
from cup3d_tpu_torch.config import SimulationConfig as TConfig
from cup3d_tpu_torch.grid import adapt as tad
from cup3d_tpu_torch.grid import bucket as tbk
from cup3d_tpu_torch.grid.adapt import valid_states
from cup3d_tpu_torch.grid.blocks import BlockGrid
from cup3d_tpu_torch.grid.faces import pad_face_tables
from cup3d_tpu_torch.grid.flux import build_flux_tables, pad_flux_tables
from cup3d_tpu_torch.grid.octree import Octree, TreeConfig
from cup3d_tpu_torch.grid.uniform import BC
from cup3d_tpu_torch.obs import metrics as obs_metrics
from cup3d_tpu_torch.ops import krylov
from cup3d_tpu_torch.sim.amr import AMRSimulation as TAMR
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: tests/test_bucketing.py::test_bucketed_matches_unbucketed's bounds
VEL_ATOL = 1e-5
ADVDIFF_ATOL = 1e-6


def test_capacity_ladder_equals_jax():
    for n in range(0, 5001):
        assert tbk.capacity(n) == jbk.capacity(n), n
        assert tbk.count_capacity(n) == jbk.count_capacity(n), n
        assert tbk.capacity(n) > n


# -- the padded tables --------------------------------------------------------

#: (blocks per dim, BCs, refine the low corner)
FORESTS = {
    "periodic27": ((3, 3, 3), ("periodic",) * 3, False),
    "corner": ((2, 2, 2), ("periodic",) * 3, True),
    "closed": ((2, 2, 2), ("periodic", "wall", "freespace"), True),
}


def _grids(kind):
    bpd, bcs, refine = FORESTS[kind]
    periodic = tuple(b == "periodic" for b in bcs)
    tt = Octree(TreeConfig(bpd, 2, periodic), 0)
    if refine:
        st = {k: "R" if max(k[1:]) == 0 else "L" for k in tt.leaves}
        for key, v in valid_states(tt, st).items():
            if v == "R":
                tt.refine(key)
    jt = JOctree(JTreeConfig(bpd, 2, periodic), 0)
    jt.leaves.clear()
    for key in tt.leaves:
        jt.leaves[key] = None
    ext = tuple(float(n) / max(bpd) for n in bpd)
    tg = BlockGrid(tt, ext, tuple(BC(b) for b in bcs), 8)
    jg = JGrid(jt, ext, tuple(JBC(b) for b in bcs), 8)
    assert tg.keys == list(jg.keys) and 8 <= tg.nb <= 27
    return tg, jg


def _eq(a, b, msg=""):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("kind", sorted(FORESTS))
def test_padded_face_tables_equal_jax(kind, width):
    tg, jg = _grids(kind)
    cap = tbk.capacity(tg.nb)
    t = pad_face_tables(tg.face_tables(width), tg, cap)
    j = jpad_faces(jg.face_tables(width), jg, cap)
    assert (t.nb, t.n_entries) == (j.nb, j.n_entries) == (cap, j.n_entries)
    assert t.shadow_starts == tuple(j.shadow_starts)
    assert len(t.child_idx) == len(j.child_idx)
    for a, b in zip(t.child_idx, j.child_idx):
        _eq(a, b, "child_idx")
    _eq(t.src, j.src, "src")
    _eq(t.bmask, j.bmask, "bmask")
    for f in range(6):
        _eq(t.cf_rows[f], j.cf_rows[f], "cf_rows")
        _eq(t.cf_src[f], j.cf_src[f], "cf_src")
        _eq(t.cf_toff[f], j.cf_toff[f], "cf_toff")
    assert (t.fb_rows is None) == (j.fb_rows is None)
    if kind == "closed":
        assert t.fb_rows is not None  # the fallback rows are padded too
    if t.fb_rows is not None:
        _eq(t.fb_rows, j.fb_rows, "fb_rows")
        for k in ("g_idx", "g_w", "g_sign", "mask_coarse", "s_idx", "s_w",
                  "s_sign"):
            _eq(getattr(t.fb_tables, k), getattr(j.fb_tables, k), k)
    # the padded labs of a padded field: the JAX package's, and 0 on
    # the padding rows
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    f = np.zeros((cap, 8, 8, 8, 3), np.float32)
    f[: tg.nb] = rng.standard_normal((tg.nb, 8, 8, 8, 3))
    lt = t.assemble_vector(torch.as_tensor(f), 8).numpy()
    lj = np.asarray(j.assemble_vector(jnp.asarray(f), 8))
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-6)
    assert not np.any(lt[tg.nb:])


@pytest.mark.parametrize("kind", sorted(FORESTS))
def test_padded_flux_and_graph_tables_equal_jax(kind):
    tg, jg = _grids(kind)
    cap = tbk.capacity(tg.nb)
    t = pad_flux_tables(build_flux_tables(tg), 8, cap)
    j = jpad_flux(jflux(jg), 8, cap)
    assert t.ncorr == j.ncorr
    n = int(build_flux_tables(tg).ncorr)
    if kind != "periodic27":
        assert 0 < n < t.ncorr  # rows padded up the ladder
    _eq(t.tgt_flux, j.tgt_flux, "tgt_flux")
    _eq(t.src_flux, j.src_flux, "src_flux")
    _eq(t.inv_hc, j.inv_hc, "inv_hc")
    if n:
        # the port groups its rows by target cell: each real row's cell
        # is the JAX row's, the padding rows add exactly 0
        cell_of = np.full(t.ncorr + 1, -1, np.int64)
        cells, groups = t.cells.numpy(), t.groups.numpy()
        for c, g in zip(cells, groups):
            for r in g:
                assert cell_of[r] in (-1, c) or r == t.ncorr
                cell_of[r] = c
        np.testing.assert_array_equal(cell_of[:n], np.asarray(j.tgt_cell)[:n])
        assert np.all(cell_of[n:t.ncorr] == -1)
        assert np.all(t.inv_hc.numpy()[n:] == 0.0)
        assert np.all(np.asarray(j.tgt_cell)[n:] == (cap - 1) * 512)
    tgr = krylov.block_graph_tables(tg, cap=cap)
    jgr = jkrylov.block_graph_tables(jg, cap=cap)
    _eq(tgr.idx, jgr.idx, "idx")
    _eq(tgr.w, jgr.w, "w")
    _eq(tgr.deg, jgr.deg, "deg")
    assert not np.any(tgr.deg.numpy()[tg.nb:])


def test_device_tags_equal_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    cap = 40
    vort = (rng.standard_normal(cap) * 2.0).astype(np.float32)
    vort[:4] = [1.8, 0.05, np.nextafter(np.float32(1.8), 2), 0.0]
    near = rng.random(cap) < 0.3
    level = rng.integers(0, 4, cap).astype(np.int32)
    level[-5:] = 0
    vort[-5:] = 0.0
    for chi_inf in (False, True):
        for lmv in (4, 2):
            kw = (1.8, 0.05, 4, lmv, chi_inf)
            t = tad.device_tags(torch.as_tensor(vort), torch.as_tensor(near),
                                torch.as_tensor(level), *kw).numpy()
            j = np.asarray(jad.device_tags(jnp.asarray(vort),
                                           jnp.asarray(near),
                                           jnp.asarray(level), *kw))
            assert t.dtype == np.int8
            np.testing.assert_array_equal(t, j)
    t0 = tad.device_tags(torch.as_tensor(vort), None, torch.as_tensor(level),
                         1.8, 0.05, 4, 4, True).numpy()
    j0 = np.asarray(jad.device_tags(jnp.asarray(vort),
                                    jnp.zeros(cap, bool), jnp.asarray(level),
                                    1.8, 0.05, 4, 4, True))
    np.testing.assert_array_equal(t0, j0)


# -- the bucketed driver: a forced regrid cycle ------------------------------


def _kw(path):
    return dict(bpdx=2, bpdy=2, bpdz=2, levelMax=2, levelStart=0,
                extent=float(2 * np.pi), nu=1e-3, nsteps=8, rampup=0,
                dt=1e-3, tend=-1.0, Rtol=1e9, Ctol=-1.0,
                initCond="taylorGreen", step_2nd_start=0,
                poissonSolver="iterative", poissonTol=1e-6,
                poissonTolRel=1e-4, verbose=False,
                path4serialization=str(path))


def _states(sim, refine=None, coarsen_parent=None):
    """Hand-built tag states: refine one leaf / coarsen one octet (the
    JAX test's)."""
    st = {k: "L" for k in sim.grid.keys}
    if refine is not None:
        st[refine] = "R"
    if coarsen_parent is not None:
        l, i, j, k = coarsen_parent
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    st[(l + 1, 2 * i + di, 2 * j + dj, 2 * k + dk)] = "C"
    return st


def _build(kind, path, bucket):
    prev = os.environ.get("CUP3D_BUCKET")
    os.environ["CUP3D_BUCKET"] = bucket
    try:
        if kind == "jax":
            d = JAMR(JConfig(**_kw(path)))
        else:
            d = TAMR(TConfig(**_kw(path)), device="cpu")
    finally:
        if prev is None:
            os.environ.pop("CUP3D_BUCKET", None)
        else:
            os.environ["CUP3D_BUCKET"] = prev
    d.init()
    d.adapt_enabled = False
    return d


def _vel(d):
    v = d._unpad(d.state["vel"])
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_forced_regrid_cycle_matches_jax_and_unbucketed(tmp_path):
    js = _build("jax", tmp_path / "j", "1")
    tb = _build("torch", tmp_path / "b", "1")
    tu = _build("torch", tmp_path / "u", "0")
    assert js._bucketing and tb._bucketing and not tu._bucketing
    assert tb._cap == js._cap > tb.grid.nb
    tab_a = tb._tab1

    def hits():
        snap = obs_metrics.snapshot()
        return (snap.get("bucket.table_memo_hits", 0),
                snap.get("bucket.exec_cache_hits", 0))

    plan = [None, dict(refine=(0, 0, 0, 0)),
            dict(coarsen_parent=(0, 0, 0, 0)), dict(refine=(0, 0, 0, 0))]
    for i, change in enumerate(plan):
        h0 = hits()
        if change is not None:
            for d in (js, tb, tu):
                assert d._apply_states(_states(d, **change))
        if i >= 2:  # back to a topology seen: the memo and the cache hit
            assert hits()[0] == h0[0] + 1 and hits()[1] == h0[1] + 1
        if i == 2:
            assert tb._tab1 is tab_a
        assert tb.grid.keys == list(js.grid.keys) == tu.grid.keys
        assert tb._cap == js._cap
        for _ in range(2):
            for d in (js, tb, tu):
                d.advance(d.calc_max_timestep())
        nb = tb.grid.nb
        for k, f in tb.state.items():
            assert f.shape[0] == tb._cap
            assert float(f[nb:].abs().max()) == 0.0, (i, k)
        vj, vb, vu = _vel(js), _vel(tb), _vel(tu)
        np.testing.assert_allclose(vb, vj, rtol=0, atol=VEL_ATOL)
        np.testing.assert_allclose(vb, vu, rtol=0, atol=VEL_ATOL)
    assert len(tb._table_memo) == 2 and len(tb._exec_cache) == 2
    fs = tb._flight_state()
    assert fs["bucket_capacity"] == tb._cap and fs["bucketing"]
    assert fs["table_memo_entries"] == 2 and fs["exec_cache_entries"] == 2
    # one advection-diffusion application on the shared state
    dt = torch.tensor(1e-3)
    uinf = torch.zeros(3)
    vu = torch.as_tensor(_vel(tu))
    a_b = tb._advdiff(tb._pad(vu), dt, uinf)[: tb.grid.nb].numpy()
    a_u = tu._advdiff(vu, dt, uinf).numpy()
    np.testing.assert_allclose(a_b, a_u, rtol=0, atol=ADVDIFF_ATOL)


def test_bucketed_tags_decide_as_the_host(tmp_path):
    """The device's decision equals the host tagging of the unpadded
    forest on the same state (both score fields read there), and the
    host reads one byte a slot for it."""
    tb = _build("torch", tmp_path / "b", "1")
    tb.cfg.Rtol, tb.cfg.Ctol = 0.5, 0.01
    tags = tb._device_tags(tb.state["vel"], None).numpy()
    assert tags.dtype == np.int8 and tags.shape == (tb._cap,)
    assert not np.any(tags[tb.grid.nb:])
    vort = tb.scores()[0][: tb.grid.nb].numpy().astype(np.float64)
    host = tad.tag_states(tb.grid, vort, 0.5, 0.01)
    assert tad.states_from_tags(tb.grid, tags[: tb.grid.nb]) == host
