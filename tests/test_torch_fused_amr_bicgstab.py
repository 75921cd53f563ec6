"""The port's fused forest BiCGSTAB against the JAX package's.

Per stage (update with its breakdown branch, getz, lap on labs assembled
from real face tables, axpy, finish): the plain PyTorch version against
the JAX Pallas kernel in interpret mode (``_Stages(kernels=True,
interpret=True)``) on the same unpadded forest and seeded inputs, within
2e-6 of the reference's max magnitude (1e-5 for getz, whose two 512-term
matmuls sum in another order) — the bounds the JAX package holds its own
kernels to.  Whole solve: the plain fused driver against the JAX fused
twin at the production tolerance (iterations within +-1, x within 1e-4
relative), and the port's fused solve against its own legacy
composition within 1e-4 relative at matched residual targets (the JAX
package's bound, tests/test_fused_amr.py).  The CUDA kernels themselves
run only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.grid.flux import build_flux_tables as jflux
from cup3d_tpu.ops import fused_amr_bicgstab as jfa
from cup3d_tpu.ops import krylov as jk
from cup3d_tpu.ops import tilesolve as jts
from cup3d_tpu.ops.fused_bicgstab import _scalars as jrow
from cup3d_tpu_torch.grid.flux import build_flux_tables as tflux
from cup3d_tpu_torch.ops import amr_ops as tops
from cup3d_tpu_torch.ops import fused_amr_bicgstab as tfa
from cup3d_tpu_torch.ops import fused_bicgstab as tfb
from cup3d_tpu_torch.ops import krylov as tk
from test_torch_amr_grid import CLOSED, ONE, PERIODIC, TWO, forests
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BS = 8
STAGE_RTOL = 2e-6
GETZ_RTOL = 1e-5


def close(got, want, rtol=STAGE_RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=0,
                               atol=rtol * scale)


def trow(*vals):
    return tfb._scalars(*(torch.tensor(v, dtype=torch.float32)
                          for v in vals))


class Forest:
    def __init__(self, bcs, refine):
        self.jg, self.tg = forests(bcs, refine)
        self.nb = self.jg.nb
        h = self.jg.h
        self.vol = (h ** 3).astype(np.float32)
        self.h2 = (h * h).astype(np.float32)
        self.inv_h2 = (1.0 / self.h2).astype(np.float32)


def test_stages_match_interpret_kernels():
    F = Forest(PERIODIC, TWO)
    n = F.nb
    st = jfa._Stages(bs=BS, npad=n, C=n, store=jnp.float32, kernels=True,
                     interpret=True)
    rng = np.random.default_rng(3)

    def vec():
        return rng.standard_normal((n, BS, BS, BS)).astype(np.float32)

    def col(a):
        return jnp.asarray(a.reshape(n, 1, 1, 1))

    T = torch.as_tensor
    r, p, v, rhat = vec(), vec(), vec(), vec()
    for vals in ((0.7, 1.3, 0.0), (0.0, 1.3, 1.0)):  # normal, breakdown
        want = st.update(*map(jnp.asarray, (r, p, v, rhat)), col(F.vol),
                         jrow(*vals))
        got = tfa.update(T(r), T(p), T(v), T(rhat), T(F.vol), trow(*vals))
        for g_, w_ in zip(got, want):
            close(g_, w_)
    azf, zc = vec(), rng.standard_normal(n).astype(np.float32)
    S3, lam3, _ = jts._basis(BS, "float32")
    want = st.getz(jnp.asarray(p), jnp.asarray(azf), col(zc), col(F.h2), S3,
                   lam3.reshape(1, BS ** 3))
    close(tfa.getz_two(T(p), T(azf), T(zc), T(F.h2)), want, GETZ_RTOL)
    # tile-only: the plain version only (B10 is not ported)
    want = st.getz(jnp.asarray(p), None, None, col(F.h2), S3,
                   lam3.reshape(1, BS ** 3))
    close(tfa.getz_tile(T(p), T(F.h2)), want, GETZ_RTOL)
    lab = F.jg.face_tables(1).assemble_scalar(jnp.asarray(p), BS)
    corr = vec()
    want = st.lap(lab, jnp.asarray(corr), jnp.asarray(rhat), col(F.inv_h2))
    got = tfa.lap(F.tg.face_tables(1).assemble_scalar(T(p), BS), T(corr),
                  T(rhat), T(F.inv_h2))
    for g_, w_ in zip(got, want):
        close(g_, w_)
    want = st.axpy(jnp.asarray(r), jnp.asarray(v), col(F.vol), jrow(0.3))
    got = tfa.axpy(T(r), T(v), T(F.vol), trow(0.3))
    for g_, w_ in zip(got, want):
        close(g_, w_)
    x = vec()
    want = st.finish(*map(jnp.asarray, (x, p, v, r, rhat, rhat)),
                     jrow(0.3, 0.8))
    got = tfa.finish(*map(T, (x, p, v, r, rhat, rhat)), trow(0.3, 0.8))
    for g_, w_ in zip(got, want):
        close(g_, w_)


def test_stage_dispatch_rules():
    """CPU tensors take the plain versions; kernels=True there raises, and
    no launch is counted for a plain run."""
    tfa.reset_launches()
    r = torch.ones((2, BS, BS, BS))
    vol = torch.ones(2)
    s_auto, _ = tfa.axpy(r, r, vol, trow(0.5))
    s_plain, _ = tfa.axpy(r, r, vol, trow(0.5), kernels=False)
    assert torch.equal(s_auto, s_plain)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.axpy(r, r, vol, trow(0.5), kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.getz_tile(r, vol, kernels=True)
    assert all(n == 0 for n in tfa.launches.values())


def _system(F, seed):
    """Volume-mean-free seeded rhs (the solver front-end's mode 2 b)."""
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal((F.nb, BS, BS, BS)).astype(np.float32)
    vol = F.vol.reshape(-1, 1, 1, 1)
    return (rhs - np.sum(rhs * vol) / (np.sum(vol) * BS ** 3)).astype(
        np.float32)


@pytest.mark.parametrize("bcs,refine", [(PERIODIC, TWO), (CLOSED, ONE)])
def test_fused_driver_matches_jax_twin(bcs, refine):
    F = Forest(bcs, refine)
    b = _system(F, 7)
    ref = float(np.sqrt(np.sum(b.astype(np.float64) ** 2)))
    kw = dict(tol_abs=1e-6, tol_rel=1e-4, maxiter=200)
    x_j, _, k_j = jfa.fused_amr_bicgstab(
        F.jg, jnp.asarray(b), tab=F.jg.face_tables(1), ftab=jflux(F.jg),
        vol=jnp.asarray(F.vol.reshape(-1, 1, 1, 1)),
        graph=jk.block_graph_tables(F.jg), rnorm_ref=jnp.float32(ref),
        kernels=False, store_dtype=jnp.float32, **kw)
    x_t, rn_t, k_t = tfa.fused_amr_bicgstab(
        F.tg, torch.as_tensor(b), tab=F.tg.face_tables(1),
        ftab=tflux(F.tg), vol=torch.as_tensor(F.vol.reshape(-1, 1, 1, 1)),
        graph=tk.block_graph_tables(F.tg), rnorm_ref=torch.tensor(ref),
        **kw)
    assert abs(int(k_t) - int(k_j)) <= 1
    assert float(rn_t) <= max(1e-6, 1e-4 * ref)
    x_j = np.asarray(x_j)
    assert np.abs(x_t.numpy() - x_j).max() <= 1e-4 * np.abs(x_j).max()


@pytest.mark.parametrize("two_level", [True, False])
def test_fused_matches_legacy(monkeypatch, two_level):
    """The port's dynamic front-end, fused vs legacy, at matched residual
    targets on the mixed forest (the JAX package's 1e-4 bound)."""
    F = Forest(PERIODIC, TWO)
    rhs = torch.as_tensor(_system(F, 5))
    kw = dict(tab_arg=F.tg.face_tables(1), flux_arg=tflux(F.tg), geom=F.tg,
              vol=torch.as_tensor(F.vol.reshape(-1, 1, 1, 1)),
              graph=tk.block_graph_tables(F.tg) if two_level else None)
    xs = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("CUP3D_FUSED", fused)
        solve = tops.build_amr_poisson_solver_dynamic(
            BS, tol_abs=1e-8, tol_rel=1e-6, maxiter=200)
        xs[fused], st = solve(rhs, with_stats=True, **kw)
        assert 0 < int(st[1]) < 200
    rel = float(torch.max(torch.abs(xs["1"] - xs["0"])) /
                torch.max(torch.abs(xs["0"])))
    assert rel <= 1e-4, rel


def test_maxiter_cap_and_chunked_count():
    F = Forest(PERIODIC, ONE)
    b = torch.as_tensor(_system(F, 2))
    tfa.reset_launches()
    _, _, k = tfa.fused_amr_bicgstab(
        F.tg, b, tab=F.tg.face_tables(1), ftab=tflux(F.tg),
        vol=torch.as_tensor(F.vol.reshape(-1, 1, 1, 1)),
        graph=tk.block_graph_tables(F.tg), tol_abs=0.0, tol_rel=0.0,
        maxiter=3)
    assert int(k) == 3
    # chunked loop: a whole chunk runs, the count stops at maxiter
    assert tfa.iterations["executed"] == tk.ITER_CHUNK
    with pytest.raises(ValueError, match="width-1"):
        tfa.fused_amr_bicgstab(F.tg, b, tab=F.tg.face_tables(3),
                               vol=torch.ones(F.nb, 1, 1, 1))
