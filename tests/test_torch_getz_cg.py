"""The port's CG getZ (``CUP3D_GETZ=cg``, kernel B7's plain version)
against the JAX package.

Per tile batch: the blocks entry ``getz_cg.cg_tiles_blocks`` and the
lanes entry ``getz_cg.cg_tiles_lanes`` (on the CPU both run the plain
version, ``getz_cg.block_cg_tiles_reference``) against the JAX Pallas
kernel in interpret mode and its jnp reference, within 2e-6 absolute
(the bound tests/test_getz_pallas.py holds the Pallas kernel to), for a
scalar shift, a per-block shift and batches that are no multiple of the
kernel's 256-tile chunk.  Whole solves with ``CUP3D_GETZ=cg`` through
both packages' front ends: the uniform legacy composition at 16^3
(two-level: iterations within +-1 of JAX, x within 1e-4 relative;
tile-only, solved to 1e-6 relative: the erratic-convergence rule of
test_torch_fused_bicgstab.py, x within 1e-4 relative) and the forest's
legacy solve on a small refined forest.  The kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.grid.uniform import UniformGrid as JGrid
from cup3d_tpu.ops import getz_pallas as jgp
from cup3d_tpu.ops import krylov as jk
from cup3d_tpu_torch.grid.uniform import UniformGrid as TGrid
from cup3d_tpu_torch.ops import getz_cg
from cup3d_tpu_torch.ops import krylov as tk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 2e-6
N_NOISE = 4     # perturbed JAX solves that measure its own iteration range
NOISE = 1e-7    # their rhs perturbation, relative to max |rhs|



def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n,iters,shift", [
    (22, 12, "block"),     # the forest's per-block h^2-style shift
    (7, 24, 0.0),          # the Poisson getZ at the production sweeps
    (300, 6, 0.5),         # no multiple of the 256-tile chunk
])
def test_blocks_match_pallas_interpret_and_reference(n, iters, shift):
    rng = np.random.default_rng(n)
    b = rng.standard_normal((n, 8, 8, 8)).astype(np.float32)
    if shift == "block":
        shift = (rng.random((n, 1, 1, 1)) + 0.5).astype(np.float32)
        sj, st = jnp.asarray(shift), torch.as_tensor(shift)
    else:
        sj = st = shift
    want = jgp.block_cg_tiles_fast(jnp.asarray(b), iters, shift=sj,
                                   interpret=True)
    got = getz_cg.cg_tiles_blocks(torch.as_tensor(b), iters, shift=st)
    _close(got, want)
    _close(got, jk.block_cg_tiles_reference(jnp.asarray(b), iters, sj))
    assert all(v == 0 for v in getz_cg.launches.values())


def test_lanes_match_and_cpu_dispatch():
    rng = np.random.default_rng(3)
    bt = rng.standard_normal((8, 8, 8, 40)).astype(np.float32)
    want = jgp.cg_tiles_lanes(jnp.asarray(bt), 24)
    got = getz_cg.cg_tiles_lanes(torch.as_tensor(bt), 24)
    _close(got, want)
    assert torch.equal(got, getz_cg.cg_tiles_lanes(torch.as_tensor(bt), 24,
                                                   kernels=False))
    with pytest.raises(ValueError, match="CUDA"):
        getz_cg.cg_tiles_lanes(torch.as_tensor(bt), 24, kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        getz_cg.cg_tiles_blocks(torch.as_tensor(bt).permute(3, 0, 1, 2), 4,
                                kernels=True)


def test_lanes_per_tile_shift_at_ragged_tile_count():
    """The lanes entry at a tile count that is no multiple of the kernel's
    8-tile CTA, with one shift a tile, against the JAX Pallas kernel in
    interpret mode and the JAX lanes entry (its jnp reference here)."""
    rng = np.random.default_rng(13)
    n = 13
    bt = rng.standard_normal((8, 8, 8, n)).astype(np.float32)
    shift = (rng.random(n) + 0.5).astype(np.float32)
    got = getz_cg.cg_tiles_lanes(torch.as_tensor(bt), 24,
                                 torch.as_tensor(shift))
    sj = jnp.asarray(shift.reshape(n, 1, 1, 1))
    want = jgp.block_cg_tiles_fast(jnp.moveaxis(jnp.asarray(bt), -1, 0), 24,
                                   shift=sj, interpret=True)
    _close(got, np.moveaxis(np.asarray(want), 0, -1))
    _close(got, jgp.cg_tiles_lanes(jnp.asarray(bt), 24, sj))
    assert all(v == 0 for v in getz_cg.launches.values())


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / float(
        np.abs(want).max())


@pytest.mark.parametrize("n,two_level", [(16, True), (16, False)])
def test_uniform_cg_solve_matches_jax(monkeypatch, n, two_level):
    """The CLI's legacy composition under CUP3D_GETZ=cg (CUP3D_FUSED=1
    set too: the CG getZ keeps the legacy loop in both packages).  One
    jitted JAX solver serves every JAX solve of a case."""
    monkeypatch.setenv("CUP3D_GETZ", "cg")
    monkeypatch.setenv("CUP3D_FUSED", "1")
    shape = (n, n, n)
    rng = np.random.default_rng(n + two_level)
    rhs = rng.standard_normal(shape).astype(np.float32)
    # tile-only convergence is erratic: solve to 1e-6 relative, so that
    # x is held to 1e-4 whatever the stopping iteration
    kw = dict(maxiter=200, two_level=two_level,
              **({} if two_level else dict(tol_abs=0.0, tol_rel=1e-6)))
    jsolve = jk.build_iterative_solver(JGrid(shape, (1.0,) * 3), **kw)
    js = jax.jit(lambda b: jsolve(b, with_stats=True))
    ts = tk.build_iterative_solver(TGrid(shape, (1.0,) * 3), **kw)
    x_j, st_j = js(jnp.asarray(rhs))
    tk.iterations["executed"] = 0
    x_t, st_t = ts(torch.as_tensor(rhs), with_stats=True)
    k_j, k_t = int(st_j[1]), int(st_t[1])
    assert tk.iterations["executed"] >= k_t > 0
    assert _rel(x_t, x_j) <= 1e-4
    if two_level:
        assert abs(k_t - k_j) <= 1, (k_t, k_j)
        return
    # tile-only: JAX's own count under 1e-7 input noise, widened by one
    noise = NOISE * float(np.abs(rhs).max())
    ks = [int(js(jnp.asarray(rhs + noise * rng.standard_normal(shape)
                             .astype(np.float32)))[1][1])
          for _ in range(N_NOISE)]
    assert min(ks + [k_j]) - 1 <= k_t <= max(ks + [k_j]) + 1, (k_t, k_j, ks)


def test_forest_cg_solve_matches_jax(monkeypatch):
    """The forest's legacy solve with the CG getZ at each block's h^2
    (two-level), on the periodic 2x2x2 forest with two octants refined:
    both packages' dynamic front ends, the JAX one jitted."""
    from test_torch_amr_grid import PERIODIC, TWO, forests

    from cup3d_tpu.ops import amr_ops as jops
    from cup3d_tpu_torch.grid.flux import build_flux_tables
    from cup3d_tpu_torch.ops import amr_ops as tops
    from cup3d_tpu.grid.flux import build_flux_tables as jflux

    monkeypatch.setenv("CUP3D_GETZ", "cg")
    monkeypatch.setenv("CUP3D_FUSED", "1")
    jg, tg = forests(PERIODIC, TWO, extent=2 * np.pi)
    rng = np.random.default_rng(9)
    vol = (tg.h ** 3).reshape(-1, 1, 1, 1)
    rhs = rng.standard_normal((tg.nb, 8, 8, 8)).astype(np.float32)
    kw = dict(maxiter=200)
    js = jops.build_amr_poisson_solver_dynamic(8, **kw)
    jgraph, jt1, jft = jk.block_graph_tables(jg), jg.face_tables(1), jflux(jg)
    x_j, st_j = jax.jit(lambda r: js(
        r, tab_arg=jt1, flux_arg=jft, geom=jg,
        vol=jnp.asarray(vol, jnp.float32), graph=jgraph,
        with_stats=True))(jnp.asarray(rhs))
    ts = tops.build_amr_poisson_solver_dynamic(8, **kw)
    tk.iterations["executed"] = 0
    x_t, st_t = ts(torch.as_tensor(rhs), tab_arg=tg.face_tables(1),
                   flux_arg=build_flux_tables(tg), geom=tg,
                   vol=torch.as_tensor(vol, dtype=torch.float32),
                   graph=tk.block_graph_tables(tg), with_stats=True)
    assert tk.iterations["executed"] >= int(st_t[1]) > 0
    assert abs(int(st_t[1]) - int(st_j[1])) <= 1, (st_t, st_j)
    assert _rel(x_t, x_j) <= 1e-4
