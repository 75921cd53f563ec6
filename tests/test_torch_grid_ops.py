"""Building blocks of the PyTorch port against the JAX package, on the
same numpy inputs: ghost padding for all three BCs (scalar and every
velocity component), stencils, RK3, the lanes/tiles layouts, face
planes, face deltas, the coarse core, the tile solve, the two-level
preconditioner, the spectral solve and the diagnostics.

Tolerance: 1e-5 relative to the reference's max magnitude (f32 with a
different summation order); padding and layouts are copies and must be
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.grid import uniform as ju
from cup3d_tpu.ops import advection as jadv
from cup3d_tpu.ops import diagnostics as jdiag
from cup3d_tpu.ops import krylov as jk
from cup3d_tpu.ops import poisson as jpo
from cup3d_tpu.ops import stencils as jst
from cup3d_tpu.ops import tilesolve as jts
from cup3d_tpu.utils import flows as jflows
from cup3d_tpu_torch.grid import uniform as tu
from cup3d_tpu_torch.ops import advection as tadv
from cup3d_tpu_torch.ops import diagnostics as tdiag
from cup3d_tpu_torch.ops import krylov as tk
from cup3d_tpu_torch.ops import poisson as tpo
from cup3d_tpu_torch.ops import stencils as tst
from cup3d_tpu_torch.ops import tilesolve as tts
from cup3d_tpu_torch.utils import flows as tflows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5
BCS = ["periodic", "wall", "freespace"]
# cubic and non-cubic (isotropic spacing: extent follows the shape)
SHAPES = [((16, 16, 16), (1.0, 1.0, 1.0)), ((16, 32, 16), (1.0, 2.0, 1.0))]


def _grids(bc, shape, extent):
    bcs = (bc,) * 3
    return (ju.UniformGrid(shape, extent, bcs),
            tu.UniformGrid(shape, extent, bcs))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("shape,extent", SHAPES)
def test_pad_scalar_and_vector_components(bc, shape, extent):
    jg, tg = _grids(bc, shape, extent)
    rng = np.random.default_rng(0)
    f = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal(shape + (3,)).astype(np.float32)
    np.testing.assert_array_equal(tg.pad_scalar(_t(f), 3).numpy(),
                                  np.asarray(jg.pad_scalar(jnp.asarray(f), 3)))
    np.testing.assert_array_equal(tg.pad_vector(_t(u), 3).numpy(),
                                  np.asarray(jg.pad_vector(jnp.asarray(u), 3)))


@pytest.mark.parametrize("bc", ["periodic", "wall"])
def test_stencils(bc):
    jg, tg = _grids(bc, (16, 32, 16), (1.0, 2.0, 1.0))
    rng = np.random.default_rng(1)
    u = rng.standard_normal(jg.shape + (3,)).astype(np.float32)
    vel = rng.standard_normal(jg.shape).astype(np.float32)
    vel[::3] = 0.0  # vel > 0 is strict: zero picks the minus stencil
    up_j, up_t = jg.pad_vector(jnp.asarray(u), 3), tg.pad_vector(_t(u), 3)
    h = jg.h
    for ax in range(3):
        _close(tst.d1_upwind5(up_t[..., 0], 3, ax, _t(vel), h),
               jst.d1_upwind5(up_j[..., 0], 3, ax, jnp.asarray(vel), h))
        _close(tst.d1_central(up_t[..., 1], 3, ax, h),
               jst.d1_central(up_j[..., 1], 3, ax, h))
    _close(tst.laplacian(up_t[..., 2], 3, h), jst.laplacian(up_j[..., 2], 3, h))
    _close(tst.grad(up_t[..., 0], 3, h), jst.grad(up_j[..., 0], 3, h))
    _close(tst.divergence(up_t, 3, h), jst.divergence(up_j, 3, h))
    _close(tst.curl(up_t, 3, h), jst.curl(up_j, 3, h))
    _close(tst.vector_laplacian(up_t, 3, h), jst.vector_laplacian(up_j, 3, h))


@pytest.mark.parametrize("bc", ["periodic", "wall"])
def test_rk3_step_and_diagnostics(bc):
    jg, tg = _grids(bc, (16, 32, 16), (1.0, 2.0, 1.0))
    rng = np.random.default_rng(2)
    u = rng.standard_normal(jg.shape + (3,)).astype(np.float32)
    uinf = np.asarray([0.1, -0.2, 0.0], np.float32)
    want = jadv.rk3_step(jg, jnp.asarray(u), jnp.float32(1e-3), 1e-2,
                         jnp.asarray(uinf))
    got = tadv.rk3_step(tg, _t(u), torch.tensor(1e-3), 1e-2, _t(uinf))
    _close(got, want)
    assert jadv.RK3_A == tadv.RK3_A and jadv.RK3_B == tadv.RK3_B
    d_j = jdiag.dissipation(jg, jnp.asarray(u), 1e-2)
    d_t = tdiag.dissipation(tg, _t(u), 1e-2)
    for key in d_j:
        _close(d_t[key], d_j[key])
    for a, b in zip(tdiag.divergence_norms(tg, _t(u)),
                    jdiag.divergence_norms(jg, jnp.asarray(u))):
        _close(a, b)
    _close(tdiag.vorticity(tg, _t(u)), jdiag.vorticity(jg, jnp.asarray(u)))
    _close(tdiag.max_velocity(_t(u), _t(uinf)),
           jdiag.max_velocity(jnp.asarray(u), jnp.asarray(uinf)))


def test_taylor_green_fields():
    jg, tg = _grids("periodic", (16, 16, 16), (2 * np.pi,) * 3)
    _close(tflows.taylor_green_3d(tg), jflows.taylor_green_3d(jg))
    _close(tflows.taylor_green_2d(tg, 0.3, 0.1),
           jflows.taylor_green_2d(jg, 0.3, 0.1))


def test_lanes_and_tiles_layouts():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 32, 24)).astype(np.float32)
    lanes_j = np.asarray(jk.to_lanes(jnp.asarray(x)))
    lanes_t = tk.to_lanes(_t(x))
    np.testing.assert_array_equal(lanes_t.numpy(), lanes_j)
    np.testing.assert_array_equal(tk.from_lanes(lanes_t, x.shape).numpy(), x)
    tiles = tk.to_tiles(_t(x))
    assert tiles.is_contiguous() and tiles.shape == (2 * 4 * 3, 8, 8, 8)
    np.testing.assert_array_equal(tk.lanes_to_tiles(lanes_t).numpy(),
                                  tiles.numpy())
    np.testing.assert_array_equal(tk.tiles_to_lanes(tiles).numpy(), lanes_j)
    np.testing.assert_array_equal(tk.from_tiles(tiles, x.shape).numpy(), x)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("shape,extent", SHAPES)
def test_planes_deltas_and_laplacian_lanes(bc, shape, extent):
    jg, tg = _grids(bc, shape, extent)
    T = int(np.prod([s // 8 for s in shape]))
    rng = np.random.default_rng(4)
    t = rng.standard_normal((8, 8, 8, T)).astype(np.float32)
    np.testing.assert_array_equal(
        tk.make_lane_planes(tg)(_t(t)).numpy(),
        np.asarray(jk.make_lane_planes(jg)(jnp.asarray(t))))
    _close(tk.make_laplacian_lanes(tg)(_t(t)),
           jk.make_laplacian_lanes(jg)(jnp.asarray(t)))
    # the tile-major Laplacian the fused driver uses is the same operator
    _close(tk.tiles_to_lanes(
        tk.make_laplacian_tiles(tg)(tk.lanes_to_tiles(_t(t)))),
        jk.make_laplacian_lanes(jg)(jnp.asarray(t)))
    zc = rng.standard_normal(T).astype(np.float32)
    _close(tk.make_face_deltas(tg)(_t(zc)),
           jk.make_face_deltas(jg)(jnp.asarray(zc)))
    _close(tk._make_coarse_core(tg)(_t(zc)),
           jk._make_coarse_core(jg)(jnp.asarray(zc)))
    _close(tk.make_twolevel_preconditioner_lanes(tg, tg.h ** 2)(_t(t)),
           jk.make_twolevel_preconditioner_lanes(jg, jg.h ** 2)(
               jnp.asarray(t)))


def test_tile_solve_and_basis():
    rng = np.random.default_rng(5)
    b = rng.standard_normal((8, 8, 8, 24)).astype(np.float32)
    _close(tts.tile_solve_lanes(_t(b)), jts.tile_solve_lanes(jnp.asarray(b)))
    for got, want in zip(tts._basis_np(8, "float32"),
                         jts._basis_np(8, "float32")):
        np.testing.assert_array_equal(got, want)
    S3, lam3, S1 = tts.basis(8, torch.float32, "cpu")
    # S3 = S1 (x) S1 (x) S1: what the CUDA getZ kernel factorizes
    kron = torch.einsum("ai,bj,ck->abcijk", S1, S1, S1).reshape(512, 512)
    _close(kron, S3.numpy())


@pytest.mark.parametrize("bc", ["periodic", "wall"])
def test_spectral_solver(bc):
    jg, tg = _grids(bc, (16, 32, 16), (1.0, 2.0, 1.0))
    rng = np.random.default_rng(6)
    rhs = rng.standard_normal(jg.shape).astype(np.float32)
    rhs -= rhs.mean()
    for op in ("consistent", "compact"):
        _close(tpo.build_spectral_solver(tg, operator=op)(_t(rhs)),
               jpo.build_spectral_solver(jg, operator=op)(jnp.asarray(rhs)))
    _close(tpo.make_poisson_solver(tg, "spectral")(_t(rhs)),
           jpo.make_poisson_solver(jg, "spectral")(jnp.asarray(rhs)))
