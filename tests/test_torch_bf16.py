"""bf16 Krylov storage (``CUP3D_KRYLOV_DTYPE=bf16``): the port against the
JAX package.

Stages: each plain stage of both fused drivers at bf16 storage against
the JAX package's ``_*_math(..., store=jnp.bfloat16)`` on the same bf16
inputs (made from seeded numpy f32 in each package and checked bitwise
equal through their uint16 views first).  A stored bf16 output must be
bitwise JAX's on at least 99.9% of its cells, and each cell within one
bf16 ulp of JAX's; where a value is so near 0 that its ulp is finer than
the f32 arithmetic before the rounding resolves (the tile solve's two
512-term matmuls sum in another order), within the f32 stage's own bound
(tests/test_torch_fused_bicgstab.py: 2e-6 of max |JAX| for the elementwise
stages, 1e-5 for the tile solve).  An f32 output (x, the per-tile
partials) within 2e-5 of the sum of its terms' magnitudes.

Whole solves (uniform two-level and tile-only, the forest's two-level):
the reported residual within 1.01x the f32 stopping target (the JAX
package's test_fused_bf16_storage_meets_residual_quality); iterations in
the range JAX's bf16 solve spans under 1e-7 rhs noise, widened by one
(``_jax_its_range``), and at most JAX's f32 count + 10; x within 1e-2 of
max |x| of JAX's bf16 x.  The tile-only bf16 solve is chaotic at the
scale of its own rounding (TILE_NOISE): its range is taken under 1e-5
noise, over JAX's solves that did not stall (at most one may), with no
f32 cap; x is then also held to each of those solves' x.  The
routing: bf16 without the fused driver raises on the uniform grid and
runs the legacy f32 composition on the forest; mean constraints 1 and 3
and ``CUP3D_GETZ=cg`` run the legacy f32 composition; the Krylov gauges
read as JAX's.  The byte models equal JAX's.  Three bf16 steps of the
twins' fish: KE and max|u| no farther from JAX's bf16 run than twice
JAX's own bf16-to-f32 gap over the same steps, or 1e-6 relative,
whichever is larger.  The bf16 CUDA kernels run on the card only
(tests/test_torch_cuda.py, chip_smoke.py phase 26)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_jax_twins as twins
from cup3d_tpu.grid.flux import build_flux_tables as jflux
from cup3d_tpu.grid.uniform import BC as JBC
from cup3d_tpu.grid.uniform import UniformGrid as JGrid
from cup3d_tpu.ops import amr_ops as jops
from cup3d_tpu.ops import fused_amr_bicgstab as jfa
from cup3d_tpu.ops import fused_bicgstab as jfb
from cup3d_tpu.ops import krylov as jk
from cup3d_tpu.ops import tilesolve as jts
from cup3d_tpu_torch.grid.flux import build_flux_tables as tflux
from cup3d_tpu_torch.grid.uniform import BC as TBC
from cup3d_tpu_torch.grid.uniform import UniformGrid as TGrid
from cup3d_tpu_torch.ops import amr_ops as tops
from cup3d_tpu_torch.ops import fused_amr_bicgstab as tfa
from cup3d_tpu_torch.ops import fused_bicgstab as tfb
from cup3d_tpu_torch.ops import krylov as tk
from test_torch_amr_grid import CLOSED, PERIODIC, TWO, forests
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BS = 8
T = 64
H = 0.25
JB, TB = jnp.bfloat16, torch.bfloat16
BITWISE = 0.999     # stored bf16 cells bitwise JAX's
STAGE_RTOL = 2e-6   # the f32 stages' bounds, of max |JAX| (near 0)
GETZ_RTOL = 1e-5
PART_RTOL = 2e-5    # f32 outputs: of the sum of their terms' magnitudes
X_RTOL = 1e-2       # bf16 solves: x of max|x|
EXTRA_ITS = 10      # bf16 iterations over JAX's f32 count
N_NOISE = 6         # perturbed JAX solves that measure its iteration range
NOISE = 1e-7        # their rhs perturbation, relative to max |rhs|
MAX_STALLS = 1      # of those, how many may stop at maxiter
# A tile-only bf16 solve is chaotic at the scale of its own rounding: the
# tile solve's matmuls summed in another order round ~0.05% of a stage's
# cells to the neighbouring bf16 value, a perturbation ~1e-4 of the
# vector's norm every stage, far above what 1e-7 rhs noise leaves after
# the rhs is rounded to bf16.  Its range is taken under 1e-5 noise, and
# it is not capped at the f32 count + 10: on the walled 16^3 system below
# JAX's own bf16 tile-only counts under such noise spread past it (17 to
# 33 against its f32 15), and a solve may stall at maxiter (left out of
# the range, at most MAX_STALLS of them).  What holds the tile solve
# there is its x: within X_RTOL of JAX's bf16 x on the rhs and on every
# perturbed rhs whose solve converged, and the residual under the target.
TILE_NOISE = 1e-5
MAXITER = 200
KNOBS = ("CUP3D_KRYLOV_DTYPE", "CUP3D_FUSED", "CUP3D_GETZ", "CUP3D_COARSE",
         "CUP3D_FAULT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)


# -- helpers --------------------------------------------------------------


def _pair(a):
    """One seeded f32 numpy array as bf16 in both packages, checked
    bitwise equal: (jax array, torch tensor), same layout."""
    j = jnp.asarray(a).astype(JB)
    t = torch.as_tensor(a).to(TB)
    np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _ordered(bits):
    """bf16 bits (uint16) on a line where neighbouring values are 1 apart."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def hold_bf16(got, want, floor=STAGE_RTOL):
    """A stored bf16 output of the port (torch, JAX's layout) against
    JAX's: >= BITWISE of the cells bitwise, each within one ulp of JAX's
    or within ``floor`` of max |JAX| (see the module docstring)."""
    g = got.contiguous().view(torch.int16).numpy().view(np.uint16)
    w = np.asarray(want).view(np.uint16).reshape(g.shape)
    share = float(np.mean(g == w))
    near = np.abs(_ordered(g) - _ordered(w)) <= 1
    wf = np.asarray(want, np.float32).reshape(g.shape).astype(np.float64)
    err = np.abs(got.float().numpy().astype(np.float64) - wf)
    near |= err <= floor * np.abs(wf).max()
    assert share >= BITWISE and near.all(), (share, int((~near).sum()))


def hold_f32(got, want, terms):
    """An f32 output within PART_RTOL of the sum of its terms' magnitudes
    (``terms``: that sum, broadcast to the output's shape)."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    tol = PART_RTOL * np.asarray(terms, np.float64).reshape(-1)
    assert np.all(np.abs(got - want) <= tol), \
        float(np.max(np.abs(got - want) / np.maximum(tol, 1e-30)))


def _abs_f32(*arrs):
    return [np.abs(np.asarray(a, np.float32).astype(np.float64))
            for a in arrs]


def _tilesum(a):
    """Per-tile sum over a lanes (8,8,8,T) or blocks (n,8,8,8) array."""
    a = np.asarray(a, np.float64)
    return a.sum(axis=(0, 1, 2)) if a.shape[-1] != BS else \
        a.sum(axis=(1, 2, 3))


def _tiles(t):
    return tk.lanes_to_tiles(t)


def _lanes(t):
    return tk.tiles_to_lanes(t)


def _trow(*vals):
    return tfb._scalars(*(torch.tensor(v, dtype=torch.float32)
                          for v in vals))


# -- stages ----------------------------------------------------------------


def test_uniform_stages_match_jax():
    rng = np.random.default_rng(21)

    def vec():
        return _pair(rng.standard_normal((BS, BS, BS, T)).astype(np.float32))

    (rj, rt), (pj, pt), (vj, vt), (hj, ht) = vec(), vec(), vec(), vec()
    for broke in (0.0, 1.0):
        want = jfb._update_math(rj, pj, vj, hj, 0.7, 1.3, broke, JB)
        got = tfb.update(_tiles(rt), _tiles(pt), _tiles(vt), _tiles(ht),
                         _trow(0.7, 1.3, broke))
        assert got[0].dtype == got[1].dtype == TB
        hold_bf16(_lanes(got[0]), want[0])
        hold_bf16(_lanes(got[1]), want[1])
        hold_f32(got[2], want[2], _tilesum(*_abs_f32(want[0].astype(
            jnp.float32))))
    S3, lam3, _ = jts._basis(BS, "float32")
    lam = lam3.reshape(BS ** 3, 1)
    aux = rng.standard_normal((8, T)).astype(np.float32)
    aux[7] = 0.0
    for two in (True, False):
        want = jfb._getz_math(pj, jnp.asarray(aux) if two else None, S3, lam,
                              H * H, BS, two, JB)
        got = (tfb.getz_two(_tiles(pt), torch.as_tensor(aux), H * H) if two
               else tfb.getz_tile(_tiles(pt), H * H))
        assert got.dtype == TB
        hold_bf16(_lanes(got), want, GETZ_RTOL)
    planes = jk.make_lane_planes(JGrid((32, 32, 32), (1.0,) * 3))(pj)
    want = jfb._lap_math(pj, planes, hj, 1.0 / (H * H), JB)
    pl_t = tk.lanes_to_tiles(torch.as_tensor(np.array(
        planes.astype(jnp.float32)))).to(TB)
    got = tfb.lap(_tiles(pt), pl_t, _tiles(ht), 1.0 / (H * H))
    hold_bf16(_lanes(got[0]), want[0])
    aw, a = _abs_f32(want[0].astype(jnp.float32), hj.astype(jnp.float32))
    hold_f32(got[1], want[1], _tilesum(a * aw))
    hold_f32(got[2], want[2], _tilesum(aw * aw))
    want = jfb._axpy_math(rj, vj, 0.37, JB)
    got = tfb.axpy(_tiles(rt), _tiles(vt), _trow(0.37))
    hold_bf16(_lanes(got[0]), want[0])
    hold_f32(got[1], want[1], _tilesum(*_abs_f32(want[0].astype(
        jnp.float32))))
    x = rng.standard_normal((BS, BS, BS, T)).astype(np.float32)
    want = jfb._finish_math(jnp.asarray(x), pj, vj, rj, hj, hj, 0.37, 1.21,
                            JB)
    got = tfb.finish(_tiles(torch.as_tensor(x)), *map(_tiles, (pt, vt, rt,
                                                           ht, ht)),
                     _trow(0.37, 1.21))
    assert got[0].dtype == torch.float32 and got[1].dtype == TB
    ax, ay, az = _abs_f32(x, pj.astype(jnp.float32), vj.astype(jnp.float32))
    hold_f32(_lanes(got[0]), want[0], ax + 0.37 * ay + 1.21 * az)
    hold_bf16(_lanes(got[1]), want[1])
    r2, h2 = _abs_f32(want[1].astype(jnp.float32), hj.astype(jnp.float32))
    hold_f32(got[2], want[2], _tilesum(r2 * r2))
    hold_f32(got[3], want[3], _tilesum(h2 * r2))


def test_forest_stages_match_jax():
    jg, tg = forests(PERIODIC, TWO)
    n = jg.nb
    h = jg.h
    vol, h2 = (h ** 3).astype(np.float32), (h * h).astype(np.float32)
    col = lambda c: jnp.asarray(c.reshape(n, 1, 1, 1))  # noqa: E731
    T_ = torch.as_tensor
    rng = np.random.default_rng(22)

    def vec():
        return _pair(rng.standard_normal((n, BS, BS, BS)).astype(np.float32))

    (rj, rt), (pj, pt), (vj, vt), (hj, ht) = vec(), vec(), vec(), vec()
    for broke in (0.0, 1.0):
        want = jfa._update_math(rj, pj, vj, hj, col(vol), 0.7, 1.3, broke, JB)
        got = tfa.update(rt, pt, vt, ht, T_(vol), _trow(0.7, 1.3, broke))
        hold_bf16(got[0], want[0])
        hold_bf16(got[1], want[1])
        p32, = _abs_f32(want[0].astype(jnp.float32))
        hold_f32(got[2], want[2], _tilesum(p32 * vol.reshape(n, 1, 1, 1)))
    S3, lam3, _ = jts._basis(BS, "float32")
    lam = lam3.reshape(1, BS ** 3)
    azf = rng.standard_normal((n, BS, BS, BS)).astype(np.float32)
    zc = rng.standard_normal(n).astype(np.float32)
    want = jfa._getz_math(pj, jnp.asarray(azf), col(zc), S3, lam, col(h2), BS,
                          True, JB)
    hold_bf16(tfa.getz_two(pt, T_(azf), T_(zc), T_(h2)), want, GETZ_RTOL)
    want = jfa._getz_math(pj, None, None, S3, lam, col(h2), BS, False, JB)
    hold_bf16(tfa.getz_tile(pt, T_(h2)), want, GETZ_RTOL)
    # the lab is assembled in f32 from the stored direction, as the JAX
    # driver's lab_corr does; the reflux increment is f32
    lab_j = jg.face_tables(1).assemble_scalar(pj.astype(jnp.float32), BS)
    lab_t = T_(np.array(lab_j))
    corr = rng.standard_normal((n, BS, BS, BS)).astype(np.float32)
    inv_h2 = (1.0 / h2).astype(np.float32)
    want = jfa._lap_math(lab_j, jnp.asarray(corr), hj, col(inv_h2), BS, JB)
    got = tfa.lap(lab_t, T_(corr), ht, T_(inv_h2))
    hold_bf16(got[0], want[0])
    aw, a = _abs_f32(want[0].astype(jnp.float32), hj.astype(jnp.float32))
    hold_f32(got[1], want[1], _tilesum(a * aw))
    hold_f32(got[2], want[2], _tilesum(aw * aw))
    want = jfa._axpy_math(rj, vj, col(vol), 0.37, JB)
    got = tfa.axpy(rt, vt, T_(vol), _trow(0.37))
    hold_bf16(got[0], want[0])
    s32, = _abs_f32(want[0].astype(jnp.float32))
    hold_f32(got[1], want[1], _tilesum(s32 * vol.reshape(n, 1, 1, 1)))
    x = rng.standard_normal((n, BS, BS, BS)).astype(np.float32)
    want = jfa._finish_math(jnp.asarray(x), pj, vj, rj, hj, hj, 0.37, 1.21,
                            JB)
    got = tfa.finish(T_(x), pt, vt, rt, ht, ht, _trow(0.37, 1.21))
    ax, ay, az = _abs_f32(x, pj.astype(jnp.float32), vj.astype(jnp.float32))
    hold_f32(got[0], want[0], ax + 0.37 * ay + 1.21 * az)
    hold_bf16(got[1], want[1])
    r2, h2_ = _abs_f32(want[1].astype(jnp.float32), hj.astype(jnp.float32))
    hold_f32(got[2], want[2], _tilesum(r2 * r2))
    hold_f32(got[3], want[3], _tilesum(h2_ * r2))


def test_wrappers_take_one_storage_dtype():
    """A stage takes its vectors in one storage dtype and x in f32; on the
    CPU the plain version infers the storage from its vectors; a dtype
    no kernel is built for raises before any launch."""
    r = torch.ones((2, BS, BS, BS), dtype=TB)
    s, ts = tfb.axpy(r, r, _trow(0.5))
    assert s.dtype == TB and ts.dtype == torch.float32
    assert torch.equal(s.float(), torch.full_like(s.float(), 0.5))
    assert set(tfb.STORES) == {torch.float32, TB}
    with pytest.raises(ValueError, match="no kernel for torch.float64"):
        tfb._check_vecs(r.double())
    with pytest.raises(ValueError, match="stage vector"):
        tfb._check_vecs(r, r.float())
    with pytest.raises(ValueError, match="stage vector"):
        tfb._check_vecs(r, dtype=torch.float32)


# -- whole solves -------------------------------------------------------------


def _jax_its_range(solve, rhs, noise=NOISE):
    """JAX's own bf16 iteration counts on this system: (fewest, most)
    over N_NOISE solves of rhs plus seeded noise of ``noise`` relative,
    and the x of each; a solve that stopped at MAXITER (a stall, no
    count) is left out, and at most MAX_STALLS of them may stall."""
    rng = np.random.default_rng(100)
    scale = noise * float(np.abs(rhs).max())
    runs = [solve(rhs + scale * rng.standard_normal(rhs.shape)
                  .astype(np.float32)) for _ in range(N_NOISE)]
    done = [(k, np.asarray(x)) for x, k in runs if k < MAXITER]
    assert len(runs) - len(done) <= MAX_STALLS, [k for _, k in runs]
    ks = [k for k, _ in done]
    return min(ks), max(ks), [x for _, x in done]


def _hold_solve(k_t, rn_t, x_t, jsolve, rhs, target, tile_only=False):
    """The port's bf16 solve against JAX's (see the module docstring);
    ``jsolve(rhs, store) -> (x, k)``.  A tile-only bf16 solve is held to
    JAX's range under TILE_NOISE, without the f32 + EXTRA_ITS cap."""
    x_j, k_j = jsolve(rhs, JB)
    _, k_f = jsolve(rhs, jnp.float32)
    lo, hi, xs = _jax_its_range(lambda b: jsolve(b, JB), rhs,
                                TILE_NOISE if tile_only else NOISE)
    lo, hi = min(lo, k_j) - 1, max(hi, k_j) + 1
    assert lo <= int(k_t) <= hi, (int(k_t), k_j, (lo, hi))
    assert tile_only or int(k_t) <= k_f + EXTRA_ITS, (int(k_t), k_f)
    assert float(rn_t) <= 1.01 * target, (float(rn_t), target)
    # x against JAX's bf16 x on this rhs and on each perturbed rhs whose
    # solve converged (the perturbation moves x by ~noise, far below this)
    x_t = np.asarray(x_t)
    for x in [np.asarray(x_j)] + xs:
        assert np.abs(x_t - x).max() <= X_RTOL * np.abs(x).max()


@pytest.mark.parametrize("bcs,n,two_level", [
    (("periodic",) * 3, 32, True),
    (("wall", "periodic", "freespace"), 16, False)])
def test_uniform_bf16_solve_matches_jax(bcs, n, two_level):
    jg = JGrid((n, n, n), (1.0,) * 3, tuple(JBC(b) for b in bcs))
    tg = TGrid((n, n, n), (1.0,) * 3, tuple(TBC(b) for b in bcs))
    rng = np.random.default_rng(23)
    rhs = rng.standard_normal((n, n, n)).astype(np.float32)
    rhs -= rhs.mean()
    kw = dict(tol_abs=1e-6, tol_rel=1e-4, maxiter=MAXITER,
              two_level=two_level)
    runs = {st: jax.jit(lambda b, st=st: jfb.fused_bicgstab(
        jg, jk.to_lanes(b), kernels=False, store_dtype=st, **kw))
        for st in (JB, jnp.float32)}

    def jsolve(b, store):
        x, _, k = runs[store](jnp.asarray(b))
        return x, int(k)

    bt = tk.to_lanes(torch.as_tensor(rhs))
    x_t, rn_t, k_t = tfb.fused_bicgstab(tg, bt, store_dtype=TB, **kw)
    assert x_t.dtype == torch.float32
    target = max(1e-6, 1e-4 * float(torch.sqrt(torch.sum(bt * bt))))
    _hold_solve(k_t, rn_t, x_t, jsolve, rhs, target, not two_level)


def test_forest_bf16_solve_matches_jax():
    jg, tg = forests(PERIODIC, TWO)
    n = jg.nb
    vol = (jg.h ** 3).astype(np.float32).reshape(-1, 1, 1, 1)
    rng = np.random.default_rng(24)
    rhs = rng.standard_normal((n, BS, BS, BS)).astype(np.float32)
    rhs = (rhs - np.sum(rhs * vol) / (np.sum(vol) * BS ** 3)).astype(
        np.float32)
    ref = float(np.sqrt(np.sum(rhs.astype(np.float64) ** 2)))
    kw = dict(tol_abs=1e-6, tol_rel=1e-4, maxiter=MAXITER)
    jkw = dict(tab=jg.face_tables(1), ftab=jflux(jg), vol=jnp.asarray(vol),
               graph=jk.block_graph_tables(jg), rnorm_ref=jnp.float32(ref))
    runs = {st: jax.jit(lambda b, st=st: jfa.fused_amr_bicgstab(
        jg, b, kernels=False, store_dtype=st, **jkw, **kw))
        for st in (JB, jnp.float32)}

    def jsolve(b, store):
        x, _, k = runs[store](jnp.asarray(b))
        return x, int(k)

    x_t, rn_t, k_t = tfa.fused_amr_bicgstab(
        tg, torch.as_tensor(rhs), tab=tg.face_tables(1), ftab=tflux(tg),
        vol=torch.as_tensor(vol), graph=tk.block_graph_tables(tg),
        rnorm_ref=torch.tensor(ref), store_dtype=TB, **kw)
    _hold_solve(k_t, rn_t, x_t, jsolve, rhs, max(1e-6, 1e-4 * ref))


# -- routing ---------------------------------------------------------------


def _uniform_system(n=16, seed=25):
    jg = JGrid((n,) * 3, (1.0,) * 3)
    tg = TGrid((n,) * 3, (1.0,) * 3)
    rhs = np.random.default_rng(seed).standard_normal((n,) * 3).astype(
        np.float32)
    return jg, tg, rhs


def _routes(solve, rhs):
    """(fused iterations executed, legacy iterations executed) of one
    solve of the port."""
    tfb.reset_launches()
    tfa.reset_launches()
    tk.iterations["executed"] = 0
    solve(rhs)
    return (tfb.iterations["executed"] + tfa.iterations["executed"],
            tk.iterations["executed"])


def test_uniform_routing_follows_jax(monkeypatch):
    """bf16 with CUP3D_FUSED=0 raises the JAX package's ValueError on the
    uniform grid; mean constraints 1 and 3 and CUP3D_GETZ=cg take the
    legacy f32 composition under bf16, as JAX's; mode 2 the fused bf16
    driver."""
    jg, tg, rhs = _uniform_system()
    monkeypatch.setenv("CUP3D_KRYLOV_DTYPE", "bf16")
    monkeypatch.setenv("CUP3D_FUSED", "0")
    for build, grid in ((jk.build_iterative_solver, jg),
                        (tk.build_iterative_solver, tg)):
        with pytest.raises(ValueError, match="requires the fused"):
            build(grid)
    monkeypatch.delenv("CUP3D_FUSED")
    trhs = torch.as_tensor(rhs)
    for mc, getz in ((2, None), (1, None), (3, None), (2, "cg")):
        if getz:
            monkeypatch.setenv("CUP3D_GETZ", getz)
        jk.build_iterative_solver(jg, mean_constraint=mc)  # JAX builds it
        ts = tk.build_iterative_solver(tg, mean_constraint=mc)
        fused, legacy = _routes(ts, trhs)
        if mc == 2 and not getz:
            assert fused > 0 and legacy == 0
        else:  # the legacy composition, on f32 vectors
            assert fused == 0 and legacy > 0, (mc, getz)
            assert ts(trhs).dtype == torch.float32
        monkeypatch.delenv("CUP3D_GETZ", raising=False)


@pytest.mark.parametrize("fused,getz", [("0", None), (None, "cg")])
def test_forest_routing_follows_jax(monkeypatch, fused, getz):
    """On the forest bf16 never raises: CUP3D_FUSED=0 and CUP3D_GETZ=cg
    run the legacy composition at f32, as the JAX package's dynamic
    solver does, with JAX's answer."""
    jg, tg = forests(CLOSED, TWO)
    n = jg.nb
    vol = (jg.h ** 3).astype(np.float32).reshape(-1, 1, 1, 1)
    rhs = np.random.default_rng(26).standard_normal(
        (n, BS, BS, BS)).astype(np.float32)
    monkeypatch.setenv("CUP3D_KRYLOV_DTYPE", "bf16")
    if fused:
        monkeypatch.setenv("CUP3D_FUSED", fused)
    if getz:
        monkeypatch.setenv("CUP3D_GETZ", getz)
    js = jops.build_amr_poisson_solver_dynamic(BS)
    ts = tops.build_amr_poisson_solver_dynamic(BS)
    fused_its, legacy_its = _routes(lambda b: ts(
        b, tab_arg=tg.face_tables(1), flux_arg=tflux(tg), geom=tg,
        vol=torch.as_tensor(vol), graph=tk.block_graph_tables(tg)),
        torch.as_tensor(rhs))
    assert fused_its == 0 and legacy_its > 0
    x_t = ts(torch.as_tensor(rhs), tab_arg=tg.face_tables(1),
             flux_arg=tflux(tg), geom=tg, vol=torch.as_tensor(vol),
             graph=tk.block_graph_tables(tg)).numpy()
    assert x_t.dtype == np.float32
    tabs = (jg.face_tables(1), jflux(jg), jk.block_graph_tables(jg))
    x_j = np.asarray(jax.jit(lambda b: js(
        b, tab_arg=tabs[0], flux_arg=tabs[1], geom=jg, vol=jnp.asarray(vol),
        graph=tabs[2]))(jnp.asarray(rhs)))
    assert np.abs(x_t - x_j).max() <= 1e-3 * np.abs(x_j).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_krylov_gauges_read_as_jax(monkeypatch, dtype):
    from cup3d_tpu.config import parse_args as jparse
    from cup3d_tpu.obs import metrics as jmetrics
    from cup3d_tpu.sim.data import SimulationData as JData
    from cup3d_tpu_torch.config import parse_args as tparse
    from cup3d_tpu_torch.obs import metrics as tmetrics
    from cup3d_tpu_torch.sim.data import SimulationData as TData

    monkeypatch.setenv("CUP3D_KRYLOV_DTYPE", dtype)
    args = twins.UNIFORM.split() + ["-verbose", "0"]
    JData(jparse(args))
    TData(tparse(args), "cpu")
    for name in ("poisson.krylov_bf16", "poisson.fused_iteration"):
        assert tmetrics.gauge(name).value == jmetrics.gauge(name).value
    assert tmetrics.gauge("poisson.krylov_bf16").value == float(
        dtype == "bf16")


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("two_level", [True, False])
def test_bytes_models_equal_jax(store, two_level):
    js, ts = {"f32": (jnp.float32, torch.float32),
              "bf16": (JB, TB)}[store]
    assert tfb.bytes_model(ts, two_level) == jfb.bytes_model(js, two_level)
    assert tfa.bytes_model(ts, two_level) == jfa.bytes_model(js, two_level)
    assert tfb.legacy_bytes_model() == jfb.legacy_bytes_model()
    assert tfa.legacy_bytes_model(two_level) == \
        jfa.legacy_bytes_model(two_level)


# -- the fish under bf16 ------------------------------------------------------


def _ke_umax(d):
    v = twins.velocity(d).astype(np.float64)
    return np.array([np.sum(v * v), np.abs(v).max()])


def test_fish_steps_under_bf16_match_jax(tmp_path, monkeypatch):
    """Three steps of the twins' fish (BASELINE config #2 at 32^3) from one
    swimming state: the port under bf16 against JAX under bf16, within
    twice JAX's own bf16-to-f32 gap (or 1e-6 relative).  JAX's bf16
    solver is swapped in through its own rebuild hook, which reads the
    knobs; the twins' reset puts its f32 solver back."""
    from cup3d_tpu.io.checkpoint import build_payload
    from test_torch_fish_sim import _port_from

    (tmp_path / "jax").mkdir()
    js = twins.jax_driver("fish", tmp_path / "jax", 10)
    for _ in range(2):  # a swimming state: the body bent, the fluid moving
        js.advance(js.calc_max_timestep())
    p = build_payload(js)
    p["fields"] = {k: jnp.copy(v) for k, v in p["fields"].items()}
    p["obstacles"] = pickle.dumps(p["obstacles"])
    monkeypatch.setenv("CUP3D_KRYLOV_DTYPE", "bf16")
    ts = _port_from(js, tmp_path, 10)  # its solver built under bf16
    out = {}
    for tag in ("f32", "bf16"):
        if tag == "bf16":
            js._resilience_restore(p)
            js._resilience_rebuild_poisson()
        for _ in range(3):
            js.advance(js.calc_max_timestep())
        out[tag] = _ke_umax(js)
    for _ in range(3):
        ts.advance(ts.calc_max_timestep())
    assert ts.sim.state["vel"].dtype == torch.float32
    got = _ke_umax(ts)
    gap = np.maximum(2 * np.abs(out["bf16"] - out["f32"]),
                     1e-6 * np.abs(out["bf16"]))
    assert np.all(np.abs(got - out["bf16"]) <= gap), (got, out)


def test_ladder_rebuilds_the_bf16_tile_only_solve(tmp_path, monkeypatch):
    """The recovery ladder under bf16 on the twins' fish: three iteration
    caps at step 2 walk it to the tile-only rung, whose rebuilt solve
    reads the knobs and runs the bf16 tile-only stage (B3's plain
    version here); the flight recorder and step_log see every step's
    [residual, iterations]."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.resilience import faults

    monkeypatch.setenv("CUP3D_KRYLOV_DTYPE", "bf16")
    monkeypatch.setenv(faults.ENV_VAR, "solver.itercap@2:3")
    faults.clear()
    seen = []
    getz_tile = tfb.getz_tile

    def spy(w, h2, kernels=None):
        seen.append(w.dtype)
        return getz_tile(w, h2, kernels)

    monkeypatch.setattr(tfb, "getz_tile", spy)
    try:
        d = build_driver(twins.argv("fish", tmp_path, 4) + ["-device", "cpu"])
        d.init()
        d.simulate()
    finally:
        faults.clear()
    stages = [e["stage"] for e in d.flight.recovery_events if "stage" in e]
    assert stages == ["warm-restart", "zero-guess", "tile-only"]
    assert twins.step_of(d) == 4
    assert seen and set(seen) == {TB}
    assert all(np.isfinite([r["resid"], r["iters"]]).all()
               for r in d.step_log)
    assert d.flight.residuals[-1]["step"] == d.step_log[-1]["step"]
    assert torch.isfinite(d.sim.state["vel"]).all()


def _tgv_rhs(tmp_path):
    """The right-hand side of the 32^3 Taylor-Green run's first pressure
    solve (the port's driver on the CPU, its solver wrapped for a step)."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.sim.operators import PressureProjection

    d = build_driver(("-bpdx 4 -bpdy 4 -bpdz 4 -levelMax 1 -extent "
                      "6.283185307179586 -initCond taylorGreen "
                      "-poissonSolver iterative -nu 1e-3 -dt 1e-3 -tend 0 "
                      f"-nsteps 1 -verbose 0 -path4serialization {tmp_path} "
                      "-device cpu").split())
    d.init()
    s, caught = d.sim, []
    solver = s.poisson_solver

    def spy(rhs, x0=None, with_stats=False):
        caught.append(rhs.numpy().copy())
        return solver(rhs, x0, with_stats=with_stats)

    spy.supports_stats, spy.maxiter = True, solver.maxiter
    s.poisson_solver = spy
    for i, op in enumerate(d.pipeline):
        if isinstance(op, PressureProjection):
            d.pipeline[i] = PressureProjection(s)
    d.advance(1e-3)
    return tuple(s.grid.extent), caught[0]


@pytest.mark.parametrize("system", ["random", "taylor_green"])
def test_bf16_residual_floor_as_jax(tmp_path, system):
    """What bf16 storage reaches, in both packages alike (the JAX
    package's own behaviour, ROADMAP "reference behaviours"): on a
    random 32^3 system both stop on the stored r's norm at the target
    while ||b - A x|| stays between 1e-3 and 1e-2 of |b| (f32: at the
    target); on the Taylor-Green run's first system both stall at
    maxiter short of the target, which f32 meets in under 20
    iterations."""
    n, cap = 32, 100
    if system == "random":
        ext = (1.0,) * 3
        rhs = np.random.default_rng(8).standard_normal((n,) * 3).astype(
            np.float32)
    else:
        ext, rhs = _tgv_rhs(tmp_path)
    rhs = rhs - rhs.mean()
    jg, tg = JGrid((n,) * 3, ext), TGrid((n,) * 3, ext)
    bj, bt = jk.to_lanes(jnp.asarray(rhs)), tk.to_lanes(torch.as_tensor(rhs))
    ref = float(np.sqrt(np.sum(rhs.astype(np.float64) ** 2)))
    target = max(1e-6, 1e-4 * ref)
    kw = dict(tol_abs=1e-6, tol_rel=1e-4, maxiter=cap)
    A = jk.make_laplacian_lanes(jg)
    for jst, tst in ((jnp.float32, torch.float32), (JB, TB)):
        xj, rj, kj = jax.jit(lambda b: jfb.fused_bicgstab(
            jg, b, kernels=False, store_dtype=jst, **kw))(bj)
        xt, rt, kt = tfb.fused_bicgstab(tg, bt, store_dtype=tst, **kw)
        true = [float(jnp.sqrt(jnp.sum((bj - A(jnp.asarray(np.asarray(x))))
                                       ** 2))) / ref for x in (xj, xt)]
        if jst == jnp.float32:
            assert max(int(kj), int(kt)) < 20
            assert max(true) <= 1.01e-4
        elif system == "random":
            assert max(float(rj), float(rt)) <= 1.01 * target
            assert all(1e-3 <= t <= 1e-2 for t in true), true
            assert max(true) <= 2 * min(true), true
        else:
            assert int(kj) == int(kt) == cap, (int(kj), int(kt))
            assert min(float(rj), float(rt)) > target
