"""The surface-point records (ops/surface.py ``per_point``,
``compact_surface_points``, ``dump_surface_points``) against the JAX
package's, on the CPU, from the same numpy inputs:

- on a sphere's dense window (tests/test_surface.py's), the compacted
  rows' traction sums equal the probe's own reductions and the rows
  equal the JAX package's records (as row sets: the port orders its
  slots by window index, the JAX package by dS);
- ``dump_surface_points`` on the uniform grid (one StefanFish's body at
  32^3 in a seeded flow) and on a two-level forest (a sphere on the
  refined corner) writes the JAX package's file.
"""

import types

import jax.numpy as jnp
import numpy as np
import torch

from cup3d_tpu.grid.blocks import BlockGrid as JGrid
from cup3d_tpu.grid.octree import Octree as JOctree
from cup3d_tpu.grid.octree import TreeConfig as JTreeConfig
from cup3d_tpu.grid.uniform import BC as JBC
from cup3d_tpu.ops import surface as jsf
from cup3d_tpu.ops.chi import heaviside as jheaviside
from cup3d_tpu_torch.grid.blocks import BlockGrid
from cup3d_tpu_torch.grid.octree import Octree, TreeConfig
from cup3d_tpu_torch.grid.uniform import BC
from cup3d_tpu_torch.ops import surface as sf
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

COLS = {k: i for i, k in enumerate(sf.SURFACE_POINT_COLUMNS)}
#: f32 probe arithmetic in two frameworks: rows within this of their
#: column's scale
ROW_RTOL = 1e-5


def _sorted(rows):
    """Rows ordered by their cell centre (exact in both packages)."""
    return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


def _same_rows(got, want):
    assert got.shape == want.shape and got.shape[0] > 0
    g, w = _sorted(got), _sorted(want)
    np.testing.assert_array_equal(g[:, :3], w[:, :3])
    scale = np.maximum(np.abs(w).max(axis=0), 1e-30)
    assert np.all(np.abs(g - w).max(axis=0) <= ROW_RTOL * scale)


def _sphere_window(n=40, r=0.3):
    h = 1.0 / n
    loc = (np.arange(n) + 0.5) * h
    xc = np.stack(np.meshgrid(loc, loc, loc, indexing="ij"),
                  -1).astype(np.float32)
    sdf = (r - np.sqrt(((xc - 0.5) ** 2).sum(-1))).astype(np.float32)
    chi = np.array(jheaviside(jnp.asarray(sdf), h))
    return h, xc, sdf, chi


def test_per_point_rows_sum_to_the_reductions_and_equal_jax():
    h, xc, sdf, chi = _sphere_window()
    rng = np.random.default_rng(1)
    vel = (rng.standard_normal(sdf.shape + (3,)) * 0.1).astype(np.float32)
    p = xc[..., 0].copy()
    udef = (0.05 * vel).astype(np.float32)
    kin = [np.array([0.5, 0.5, 0.5], np.float32),
           np.array([0.1, 0.0, 0.0], np.float32),
           np.array([0.0, 0.2, 0.0], np.float32)]
    args = (vel, p, chi, sdf, udef, np.ones(sdf.shape, bool), xc)
    out = sf.surface_force_window(
        *[torch.as_tensor(a) for a in args], h, 1e-2,
        *[torch.as_tensor(k) for k in kin], per_point=True)
    jout = jsf.surface_force_window(
        *[jnp.asarray(a) for a in args], h, 1e-2,
        *[jnp.asarray(k) for k in kin], per_point=True)
    rows = sf.compact_surface_points(out["points"])
    assert rows.shape == (int(out["n_surf"]), len(sf.SURFACE_POINT_COLUMNS))
    for cols, key in ((("fxP", "fyP", "fzP"), "pres_force"),
                      (("fxV", "fyV", "fzV"), "visc_force")):
        np.testing.assert_allclose(
            rows[:, [COLS[c] for c in cols]].sum(0), out[key].numpy(),
            rtol=1e-4, atol=1e-7)
    area = 4.0 * np.pi * 0.3 ** 2
    assert abs(rows[:, COLS["dS"]].sum() - area) / area < 0.06
    _same_rows(rows, jsf.compact_surface_points(jout["points"]))


def _ob(chi, sdf, udef, position, length, kin, torch_side):
    conv = torch.as_tensor if torch_side else jnp.asarray
    return types.SimpleNamespace(
        chi=conv(chi), sdf=conv(sdf), udef=conv(udef),
        position=np.asarray(position, np.float64), length=length,
        centerOfMass=kin[0], transVel=kin[1], angVel=kin[2])


def test_dump_on_the_uniform_grid_matches_jax(tmp_path):
    import test_torch_jax_twins as twins

    jd = twins.jax_driver("fish", tmp_path, 1)
    s, job = jd.sim, jd.sim.obstacles[0]
    rng = np.random.default_rng(5)
    n = s.grid.shape
    vel = (rng.standard_normal(tuple(n) + (3,)) * 0.1).astype(np.float32)
    p = rng.standard_normal(tuple(n)).astype(np.float32)
    body = [np.asarray(a) for a in (job.chi, job.sdf, job.udef)]
    kin = [np.asarray(job.centerOfMass), np.asarray(job.transVel) + 0.05,
           np.asarray(job.angVel) + 0.1]
    from cup3d_tpu_torch.grid.uniform import UniformGrid

    tgrid = UniformGrid(tuple(int(v) for v in n), s.grid.extent,
                        tuple(BC(b.value) for b in s.grid.bc))
    jpath, tpath = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    nj = jsf.dump_surface_points(
        jpath, s.grid, {"vel": jnp.asarray(vel), "p": jnp.asarray(p)},
        _ob(*body, job.position, job.length, kin, False), s.nu)
    nt = sf.dump_surface_points(
        tpath, tgrid, {"vel": torch.as_tensor(vel), "p": torch.as_tensor(p)},
        _ob(*body, job.position, job.length, kin, True), s.nu)
    assert nt == nj > 100
    _same_rows(np.load(tpath), np.load(jpath))


def test_dump_on_the_forest_matches_jax(tmp_path):
    bpd, periodic = (2, 2, 2), (True,) * 3
    tt = Octree(TreeConfig(bpd, 2, periodic), 0)
    tt.refine((0, 0, 0, 0))
    jt = JOctree(JTreeConfig(bpd, 2, periodic), 0)
    jt.leaves.clear()
    for key in tt.leaves:
        jt.leaves[key] = None
    tg = BlockGrid(tt, (1.0, 1.0, 1.0), (BC.periodic,) * 3, 8)
    jg = JGrid(jt, (1.0, 1.0, 1.0), (JBC.periodic,) * 3, 8)
    assert tg.keys == list(jg.keys)
    # a sphere of radius 0.12 inside the refined octant (h 1/32)
    xc = tg.cell_centers(torch.float64).numpy()
    c, r, hf = np.array([0.25, 0.25, 0.25]), 0.12, 1.0 / 32
    sdf = (r - np.sqrt(((xc - c) ** 2).sum(-1))).astype(np.float32)
    chi = np.array(jheaviside(jnp.asarray(sdf), hf))
    rng = np.random.default_rng(9)
    vel = (rng.standard_normal(sdf.shape + (3,)) * 0.1).astype(np.float32)
    p = rng.standard_normal(sdf.shape).astype(np.float32)
    udef = np.zeros_like(vel)
    kin = [c.astype(np.float32), np.array([0.1, 0, 0], np.float32),
           np.zeros(3, np.float32)]
    jpath, tpath = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    nj = jsf.dump_surface_points(
        jpath, jg, {"vel": jnp.asarray(vel), "p": jnp.asarray(p)},
        _ob(chi, sdf, udef, c, 2 * r, kin, False), 1e-3)
    nt = sf.dump_surface_points(
        tpath, tg, {"vel": torch.as_tensor(vel), "p": torch.as_tensor(p)},
        _ob(chi, sdf, udef, c, 2 * r, kin, True), 1e-3)
    assert nt == nj > 100
    _same_rows(np.load(tpath), np.load(jpath))
