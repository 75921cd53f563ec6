"""The forest Helmholtz solve of implicit diffusion (ops/diffusion.py)
against the JAX package's, on the two forests of
tests/test_torch_amr_grid.py (their BC sign ghosts, coarse-fine faces
and reflux), the same seeded numpy inputs through both:

- the operator ``helmholtz_comp_blocks``, each component within 1e-6 of
  its max;
- the solve (the exact getZ, and the CG getZ with its per-block shift
  column, kernel B7's plain version here) within 1e-4 relative,
  iterations +-1 a component;
- the explicit Euler advection ``advect_euler_blocks`` within 1e-5 and
  the implicit step ``implicit_step_blocks`` within 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_amr_ops import CASES, close, pair
from test_torch_amr_physics import _plain_env  # noqa: F401 (autouse)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUDT = 2e-3  # nu dt: several iterations a component at h ~ 0.2


@pytest.mark.parametrize("case", CASES, ids=["periodic", "closed"])
def test_helmholtz_operator_matches_jax(case):
    from cup3d_tpu.ops import diffusion as jdif
    from cup3d_tpu_torch.ops import diffusion as tdif

    p = pair(*case)
    x = p.vector(11)
    for c in range(3):
        want = jax.jit(lambda v, c=c: jdif.helmholtz_comp_blocks(
            p.jg, v, p.j1, NUDT, c, p.jf))(jnp.asarray(x[..., c]))
        got = tdif.helmholtz_comp_blocks(p.tg, torch.tensor(x[..., c]), p.t1,
                                         NUDT, c, p.tf)
        close(got, want, rtol=1e-6)


def _jax_helmholtz(p, u, getz):
    """The JAX solve's per-component (x, iterations), its operator and
    shifted getZ as build_amr_helmholtz_solver composes them."""
    from cup3d_tpu.ops import diffusion as jdif
    from cup3d_tpu.ops import krylov as jk

    h2 = jnp.asarray((p.jg.h ** 2).reshape(p.jg.nb, 1, 1, 1), jnp.float32)
    shift = h2 / NUDT

    @functools.partial(jax.jit, static_argnums=1)
    def comp(b, c):
        def A(x):
            return jdif.helmholtz_comp_blocks(p.jg, x, p.j1, NUDT, c, p.jf,
                                              1.0 / jnp.sqrt(h2))

        def M(r):
            return jk.getz_blocks(shift * r, shift=shift, cg_iters=24)

        x, _, k = jk.bicgstab(A, b, M=M, x0=b, tol_abs=1e-6, tol_rel=1e-4,
                              maxiter=1000,
                              rnorm_ref=jnp.sqrt(jnp.sum(b * b)))
        return x, k

    return [comp(jnp.asarray(u[..., c]), c) for c in range(3)]


@pytest.mark.parametrize("case,getz", [(CASES[0], ""), (CASES[1], ""),
                                       (CASES[1], "cg")],
                         ids=["periodic", "closed", "closed-cg"])
def test_helmholtz_solve_matches_jax(case, getz, monkeypatch):
    from cup3d_tpu_torch.ops import diffusion as tdif

    if getz:
        monkeypatch.setenv("CUP3D_GETZ", getz)
    p = pair(*case)
    u = p.vector(12)
    want = _jax_helmholtz(p, u, getz)
    solve = tdif.build_amr_helmholtz_solver(p.tg, tab=p.t1, flux_tab=p.tf)
    got = solve(torch.tensor(u), NUDT)
    iters = [int(s[1]) for s in solve.last_stats]
    for c in range(3):
        close(got[..., c], want[c][0], rtol=1e-4)
        assert abs(iters[c] - int(want[c][1])) <= 1, (iters, c)
    assert min(iters) >= 2  # the solve does work at this nu dt


def test_implicit_step_blocks_matches_jax():
    from cup3d_tpu.ops import diffusion as jdif
    from cup3d_tpu_torch.ops import diffusion as tdif

    p = pair(*CASES[1])
    vel = p.vector(13, amp=0.5)
    uinf = np.float32([0.1, 0.0, -0.05])
    dt, nu = 0.01, 0.2
    jsolve = jdif.build_amr_helmholtz_solver(p.jg, tab=p.j1, flux_tab=p.jf)
    want = jax.jit(lambda v: jdif.implicit_step_blocks(
        p.jg, v, dt, nu, jnp.asarray(uinf), p.j3, jsolve))(jnp.asarray(vel))
    tsolve = tdif.build_amr_helmholtz_solver(p.tg, tab=p.t1, flux_tab=p.tf)
    got = tdif.implicit_step_blocks(p.tg, torch.tensor(vel), dt, nu,
                                    torch.tensor(uinf), p.t3, tsolve)
    close(got, want, rtol=1e-4)
    ustar = jax.jit(lambda v: jdif.advect_euler_blocks(
        p.jg, v, dt, jnp.asarray(uinf), p.j3))(jnp.asarray(vel))
    close(tdif.advect_euler_blocks(p.tg, torch.tensor(vel), dt,
                                   torch.tensor(uinf), p.t3), ustar)
