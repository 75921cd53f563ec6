"""Implicit diffusion of the port (ops/diffusion.py and
AdvectionDiffusionImplicit) against the JAX package on the same numpy
inputs: the DST-II basis, the spectral Helmholtz solve on periodic, wall
and mixed 16^3 grids, the explicit Euler advection, one implicit step,
3 driver steps with -implicitDiffusion 1, and the whole timestep as one
function (sim/fused.make_step, with and without bodies).

Tolerance: 1e-5 relative to the reference's max magnitude (f32 with a
different summation order, tests/test_torch_grid_ops.py's bound); the
drivers, whose spectral projection is direct, to the same bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.grid import uniform as ju
from cup3d_tpu.ops import diffusion as jdif
from cup3d_tpu_torch.grid import uniform as tu
from cup3d_tpu_torch.ops import diffusion as tdif
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5
BCS = {"periodic": ("periodic",) * 3, "wall": ("wall",) * 3,
       "mixed": ("periodic", "wall", "freespace")}


def _grids(bcs, n=16):
    return (ju.UniformGrid((n,) * 3, (1.0,) * 3, bcs),
            tu.UniformGrid((n,) * 3, (1.0,) * 3, bcs))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _field(seed, n=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n, n, 3)).astype(np.float32)


def test_dst2_matrix_is_the_reference_basis():
    for n in (1, 8, 16):
        np.testing.assert_array_equal(tdif.dst2_matrix(n),
                                      jdif.dst2_matrix(n))


@pytest.mark.parametrize("bc", list(BCS))
def test_spectral_helmholtz_matches_jax(bc):
    jg, tg = _grids(BCS[bc])
    u = _field(1)
    nudt = np.float32(0.7 * jg.h * jg.h)
    want = jdif.build_spectral_helmholtz(jg)(jnp.asarray(u), nudt)
    got = tdif.build_spectral_helmholtz(tg)(torch.as_tensor(u),
                                            torch.tensor(nudt))
    _close(got, want)


@pytest.mark.parametrize("bc", list(BCS))
def test_advect_euler_and_implicit_step_match_jax(bc):
    jg, tg = _grids(BCS[bc])
    u = 0.5 * _field(2)
    uinf = np.array([0.1, -0.05, 0.0], np.float32)
    dt, nu = np.float32(2e-3), 1e-3
    want = jdif.advect_euler(jg, jnp.asarray(u), dt, jnp.asarray(uinf))
    got = tdif.advect_euler(tg, torch.as_tensor(u), torch.tensor(dt),
                            torch.as_tensor(uinf))
    _close(got, want)
    jh = jdif.build_spectral_helmholtz(jg)
    th = tdif.build_spectral_helmholtz(tg)
    want = jdif.implicit_step(jg, jnp.asarray(u), dt, nu, jnp.asarray(uinf),
                              jh)
    got = tdif.implicit_step(tg, torch.as_tensor(u), torch.tensor(dt), nu,
                             torch.as_tensor(uinf), th)
    _close(got, want)


def test_implicit_diffusion_driver_matches_jax(tmp_path):
    from cup3d_tpu.__main__ import build_driver as jax_build_driver

    from cup3d_tpu_torch.__main__ import build_driver

    argv = ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 1 -extent 6.283185307179586 "
            "-initCond taylorGreen -implicitDiffusion 1 -nu 0.05 -CFL 0.4 "
            "-rampup 0 -tend 0 -nsteps 3 -verbose 0 -BC_y wall "
            f"-path4serialization {tmp_path}").split()
    js = jax_build_driver(argv)
    ts = build_driver(argv + ["-device", "cpu"])
    js.init()
    ts.init()
    assert [op.name for op in ts.pipeline][0] == "AdvectionDiffusionImplicit"
    for _ in range(3):
        dt_j = js.calc_max_timestep()
        dt_t = ts.calc_max_timestep()
        assert abs(dt_t - dt_j) <= 1e-6 * dt_j
        js.advance(dt_j)
        ts.advance(dt_t)
    _close(ts.sim.state["vel"], js.sim.state["vel"])


@pytest.mark.parametrize("with_bodies", [False, True])
def test_fused_step_matches_jax(with_bodies):
    """sim/fused.make_step (RK3 -> penalization -> projection, the
    spectral solve) against the JAX package's, same inputs."""
    from cup3d_tpu.ops.poisson import build_spectral_solver as jsolver
    from cup3d_tpu.sim.fused import make_step as jmake

    from cup3d_tpu_torch.ops.poisson import build_spectral_solver
    from cup3d_tpu_torch.sim.fused import make_step

    jg, tg = _grids(BCS["periodic"])
    u = 0.5 * _field(3)
    uinf = np.array([0.1, 0.0, 0.0], np.float32)
    dt = np.float32(1e-3)
    jstep = jmake(jg, 1e-3, jsolver(jg), with_bodies, donate=False)
    tstep = make_step(tg, 1e-3, build_spectral_solver(tg), with_bodies)
    args = [u, dt, uinf]
    if with_bodies:
        x = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
        r = np.sqrt(sum(np.meshgrid(x * x, x * x, x * x, indexing="ij")))
        chi = np.clip(2.0 - 4.0 * r, 0.0, 1.0).astype(np.float32)
        args += [chi, 0.1 * _field(4), 0.05 * _field(5), np.float32(1e3)]
    want = jstep(*map(jnp.asarray, args))
    got = tstep(*map(torch.as_tensor, args))
    for g, w in zip(got, want):
        _close(g, w)
