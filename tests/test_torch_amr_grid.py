"""The port's forest grid modules against the JAX package's.

Small forests: a 2x2x2 base with levelMax 2 and one or two refined
octants, periodic, plus one closed-boundary case (wall / periodic /
freespace) whose sign flips and degenerate coarse faces take the
per-cell fallback.  The same seeded numpy fields go through both.

- octree leaf order and BlockGrid geometry: equal;
- face-table assembly at widths 1 and 3 and lab-table assembly (the
  per-cell tables; the refinement prolongation reads them at width 1,
  the closed faces' fallback at the faces' width) on one periodic and
  one closed forest (scalar, vector, one component): within
  1e-6 of the lab's max magnitude (the quadratic interpolation's matmuls
  sum in another order);
- flux correction: within 1e-6 of the output's max magnitude, and a
  rerun is bitwise equal (the grouped scatter has no atomics);
- tag_states / adapt / transfer_field: the states and the new leaf keys
  exactly equal, transferred fields within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from cup3d_tpu.grid import adapt as jad
from cup3d_tpu.grid.blocks import BlockGrid as JGrid
from cup3d_tpu.grid.flux import build_flux_tables as jflux
from cup3d_tpu.grid.octree import Octree as JTree
from cup3d_tpu.grid.octree import TreeConfig as JCfg
from cup3d_tpu.grid.uniform import BC as JBC
from cup3d_tpu_torch.grid import adapt as tad
from cup3d_tpu_torch.grid.blocks import BlockGrid as TGrid
from cup3d_tpu_torch.grid.flux import build_flux_tables as tflux
from cup3d_tpu_torch.grid.octree import Octree as TTree
from cup3d_tpu_torch.grid.octree import TreeConfig as TCfg
from cup3d_tpu_torch.grid.uniform import BC as TBC
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BS = 8
RTOL = 1e-6
PERIODIC = ("periodic",) * 3
CLOSED = ("wall", "periodic", "freespace")
ONE = [(0, 0, 0, 0)]
# two octants touching diagonally: block (0,1,0,0) meets them across two
# perpendicular faces, so its edge cells take two flux corrections
TWO = [(0, 0, 0, 0), (0, 1, 1, 0)]
FORESTS = [(PERIODIC, ONE), (PERIODIC, TWO), (CLOSED, ONE)]


def forests(bcs, refine, extent=1.0):
    """The same forest in both packages: (JAX grid, port grid)."""
    per = tuple(b == "periodic" for b in bcs)
    jt, tt = JTree(JCfg((2, 2, 2), 2, per), 0), TTree(TCfg((2, 2, 2), 2,
                                                           per), 0)
    for leaf in refine:
        jt.refine(leaf)
        tt.refine(leaf)
    ext = (extent,) * 3
    return (JGrid(jt, ext, tuple(JBC(b) for b in bcs), BS),
            TGrid(tt, ext, tuple(TBC(b) for b in bcs), BS))


def fields(nb, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nb, BS, BS, BS)).astype(np.float32),
            rng.standard_normal((nb, BS, BS, BS, 3)).astype(np.float32))


def jit(fn, *args):
    """Run a JAX function jitted (one compile of everything a test needs
    is cheaper on the CPU than the eager first call of every op shape)."""
    return jax.jit(fn)(*args)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("bcs,refine", FORESTS)
def test_leaf_order_and_geometry(bcs, refine):
    jg, tg = forests(bcs, refine, extent=2.0)
    assert tg.keys == jg.keys and tg.nb == jg.nb
    np.testing.assert_array_equal(tg.level, jg.level)
    np.testing.assert_array_equal(tg.ijk, jg.ijk)
    np.testing.assert_array_equal(tg.h, jg.h)
    np.testing.assert_array_equal(tg.origin, jg.origin)
    assert tg.signature == jg.signature
    np.testing.assert_array_equal(tg.cell_centers().numpy(),
                                  jg.cell_centers(np.float32))
    assert tuple(tg.zeros(3).shape) == tuple(jg.zeros(3).shape)


HALOS = ([("faces", w, *fr) for w in (1, 3) for fr in FORESTS]
         + [("lab", 1, PERIODIC, TWO), ("lab", 3, CLOSED, ONE)])


@pytest.mark.parametrize("kind,width,bcs,refine", HALOS)
def test_halo_assembly(kind, width, bcs, refine):
    jg, tg = forests(bcs, refine)
    f, v = fields(jg.nb)
    if kind == "faces":
        jt, tt = jg.face_tables(width), tg.face_tables(width)
        # the closed case exercises the per-cell fallback rows
        assert (tt.fb_rows is not None) == (bcs == CLOSED)
    else:
        jt, tt = jg.lab_tables(width), tg.lab_tables(width)
    want = jit(lambda a, b: (jt.assemble_scalar(a, BS),
                             jt.assemble_vector(b, BS),
                             jt.assemble_component(b[..., 1], BS, 1)), f, v)
    close(tt.assemble_scalar(torch.as_tensor(f), BS), want[0])
    close(tt.assemble_vector(torch.as_tensor(v), BS), want[1])
    close(tt.assemble_component(torch.as_tensor(v[..., 1]), BS, 1), want[2])


@pytest.mark.parametrize("bcs,refine", FORESTS)
def test_flux_correction(bcs, refine):
    jg, tg = forests(bcs, refine)
    jt, tt = jflux(jg), tflux(tg)
    assert tt.ncorr == jt.ncorr > 0
    rng = np.random.default_rng(1)
    out = rng.standard_normal((jg.nb, BS, BS, BS)).astype(np.float32)
    fl = rng.standard_normal((jg.nb, 6, BS, BS)).astype(np.float32)
    got = tt.apply(torch.as_tensor(out), torch.as_tensor(fl))
    close(got, jit(jt.apply, out, fl))
    # edge cells take several corrections, summed in a fixed order
    assert int(tt.groups.shape[1]) == (2 if refine == TWO else 1)
    assert torch.equal(got, tt.apply(torch.as_tensor(out),
                                     torch.as_tensor(fl)))


@pytest.mark.parametrize("bcs", [PERIODIC, CLOSED])
@pytest.mark.parametrize("change", ["refine", "compress"])
def test_tag_adapt_transfer(bcs, change):
    """Refine two coarse blocks, or compress the refined octet, from
    per-block scores (on a 2x2x2 base every block touches every other,
    so one regrid cannot do both: a refining neighbour vetoes)."""
    jg, tg = forests(bcs, ONE)
    rng = np.random.default_rng(2)
    score = rng.uniform(0.1, 1.0, jg.nb)
    if change == "refine":
        score[np.where(jg.level == 0)[0][:2]] = 2.0
    else:
        score[jg.level == 1] = 0.01
    js = jad.tag_states(jg, score, 1.5, 0.05)
    ts = tad.tag_states(tg, score, 1.5, 0.05)
    assert ts == js
    assert tad.valid_states(tg.tree, ts) == jad.valid_states(jg.tree, js)
    jp, tp = jad.adapt(jg, js), tad.adapt(tg, ts)
    assert tp.new_grid.keys == jp.new_grid.keys
    moved = tp.ref_src if change == "refine" else tp.com_src
    assert len(moved) > 0
    f, v = fields(jg.nb, 3)
    want = jit(lambda a, b: (jad.transfer_field(jg, jp, a),
                             jad.transfer_field(jg, jp, b)), f, v)
    for a, w in zip((f, v), want):
        close(tad.transfer_field(tg, tp, torch.as_tensor(a)), w)
    assert tad.adapt(tg, {k: "L" for k in tg.keys}) is None
