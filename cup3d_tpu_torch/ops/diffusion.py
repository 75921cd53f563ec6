"""Implicit diffusion on the uniform grid (port of the uniform part of
``cup3d_tpu/ops/diffusion.py``; the reference's DiffusionSolver +
AdvectionDiffusionImplicit, main.cpp:6719-7147, 9849-10118).

The reference advances advection with an explicit Euler kernel
(``KernelAdvect``) and then solves, per velocity component, the
Helmholtz system

    (I - nu dt lap) u = u*            (u* = post-advection velocity)

On the uniform grid the 7-point Helmholtz operator with periodic /
copy-edge / sign-flip ghosts is diagonalized exactly by per-axis
orthonormal bases: real Fourier (periodic), DCT-II (copy-edge ghosts)
and DST-II (sign-flip ghosts: a wall face, or a freespace face on its
normal component), the choice per (axis, component) mirroring
``UniformGrid`` padding.  The solve is six dense per-axis products and
one elementwise scale, in true f32 (``precision.check_fp32_matmul``:
never TF32).

On the AMR forest there is no such basis: the Helmholtz system is solved
per component by BiCGSTAB (the reference DiffusionSolver,
main.cpp:6896-7146) with the BC sign ghosts and diffusive-flux
refluxing in its operator, preconditioned by the shifted getZ (the tile
solve of -lap + h^2/(nu dt) on every block; kernel B7 with a per-block
shift column under CUP3D_GETZ=cg).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cup3d_tpu_torch.grid.uniform import BC, UniformGrid
from cup3d_tpu_torch.ops import precision
from cup3d_tpu_torch.ops import stencils as st
from cup3d_tpu_torch.ops.krylov import DeviceConsts
from cup3d_tpu_torch.ops.poisson import _apply_mat, dct2_matrix, rfourier_matrix


def dst2_matrix(n: int, dtype=np.float64) -> np.ndarray:
    """Orthonormal DST-II basis S with X = S @ x, x = S.T @ X: rows
    sin(theta_k (j + 1/2)), theta_k = pi (k+1) / n, the eigenbasis of the
    1-D Laplacian with antisymmetric ghosts (ghost = -edge); eigenvalues
    2 cos(theta_k) - 2."""
    k = np.arange(1, n + 1)[:, None]
    j = np.arange(n)[None, :]
    s = np.sin(np.pi * k * (2 * j + 1) / (2 * n)) * np.sqrt(2.0 / n)
    s[-1] *= np.sqrt(0.5)  # k = n row is the alternating +-1 row
    return s.astype(dtype)


def _axis_basis(n: int, bc: BC, comp: int, axis: int):
    """(basis, eigenvalues 2 cos theta - 2) for one axis of one velocity
    component, matching the ghost convention of the grid's padding."""
    if bc == BC.periodic:
        mat, freqs = rfourier_matrix(n)
        theta = 2.0 * np.pi * freqs / n
    else:
        flip = bc == BC.wall or comp == axis
        if flip:
            mat = dst2_matrix(n)
            theta = np.pi * np.arange(1, n + 1) / n
        else:
            mat = dct2_matrix(n)
            theta = np.pi * np.arange(n) / n
    return mat, 2.0 * np.cos(theta) - 2.0


def build_spectral_helmholtz(grid: UniformGrid,
                             dtype=torch.float32) -> Callable:
    """solve(u, nudt) -> (I - nudt lap)^{-1} u for a (nx,ny,nz,3)
    velocity field, exact per-component diagonalization.  ``nudt`` may be
    a 0-dim device tensor (the step's dt times nu): the eigenvalue scale
    is applied elementwise per call."""
    h2 = grid.h * grid.h
    np_dtype = str(dtype).replace("torch.", "")
    arrays = {}
    for c in range(3):
        lam3 = 0.0
        for a, (n, bc) in enumerate(zip(grid.shape, grid.bc)):
            mat, lam = _axis_basis(n, BC(bc), c, a)
            arrays[f"m{c}{a}"] = mat.astype(np_dtype)
            sh = [1, 1, 1]
            sh[a] = n
            lam3 = lam3 + lam.reshape(sh)
        arrays[f"lam{c}"] = (lam3 / h2).astype(np_dtype)
    consts = DeviceConsts(**arrays)

    def solve(u: torch.Tensor, nudt) -> torch.Tensor:
        k = consts.on(u.device)
        if u.is_cuda:
            precision.check_fp32_matmul()
        outs = []
        for c in range(3):
            f = u[..., c].to(dtype)
            for a in range(3):
                f = _apply_mat(k[f"m{c}{a}"], f, a)
            f = f / (1.0 - nudt * k[f"lam{c}"])
            for a in range(3):
                f = _apply_mat(k[f"m{c}{a}"].T, f, a)
            outs.append(f.to(u.dtype))
        return torch.stack(outs, dim=-1)

    return solve


def advect_euler(grid: UniformGrid, u: torch.Tensor, dt,
                 uinf: torch.Tensor) -> torch.Tensor:
    """Explicit advection-only Euler stage (reference KernelAdvect,
    main.cpp:9849-10029): u* = u - dt (u + uinf) . grad u, upwind5."""
    from cup3d_tpu_torch.ops.advection import GHOSTS

    h = grid.h
    up = grid.pad_vector(u, GHOSTS)
    uadv = [u[..., c] + uinf[c] for c in range(3)]
    out = []
    for c in range(3):
        comp = up[..., c]
        adv = sum(uadv[a] * st.d1_upwind5(comp, GHOSTS, a, uadv[a], h)
                  for a in range(3))
        out.append(u[..., c] - dt * adv)
    return torch.stack(out, dim=-1)


def implicit_step(grid: UniformGrid, u: torch.Tensor, dt, nu: float,
                  uinf: torch.Tensor, helmholtz: Callable) -> torch.Tensor:
    """One AdvectionDiffusionImplicit Euler step (main.cpp:10030-10118):
    explicit advection, then the exact implicit diffusion solve."""
    ustar = advect_euler(grid, u, dt, uinf)
    return helmholtz(ustar, nu * dt)


# ---------------------------------------------------------------------------
# AMR forest: Helmholtz BiCGSTAB with the shifted getZ
# ---------------------------------------------------------------------------


def helmholtz_comp_blocks(grid, x: torch.Tensor, tab, nudt, comp: int,
                          flux_tab=None, inv_h=None) -> torch.Tensor:
    """(I - nudt lap) x on one velocity component of the forest, with the
    component's BC sign ghosts and diffusive-flux refluxing (reference
    DiffusionSolver LHS, main.cpp:6726-6801).  ``grid``: a BlockGrid or
    the sharded forest's padded geometry, with its tables."""
    from cup3d_tpu_torch.ops.amr_ops import _hcol, face_fluxes, stencil7

    bs, w = grid.bs, tab.width
    if inv_h is None:
        inv_h = 1.0 / _hcol(grid, x)
    lab = tab.assemble_component(x, bs, comp)
    lap = stencil7(lab, w, bs) * inv_h * inv_h
    if flux_tab is not None and flux_tab.ncorr:
        lap = flux_tab.apply(lap, face_fluxes(lab, w, bs, inv_h))
    return x - nudt * lap


def build_amr_helmholtz_solver(grid, tol_abs: float = 1e-6,
                               tol_rel: float = 1e-4, maxiter: int = 1000,
                               precond_iters: int = 24, tab=None,
                               flux_tab=None, device="cpu") -> Callable:
    """solve(u, nudt) -> (I - nudt lap)^{-1} u per component on the forest:
    BiCGSTAB from x0 = u, its relative tolerance against the cold RHS
    norm, preconditioned by the shifted getZ with shift = h^2/(nu dt) per
    block.  ``tab``/``flux_tab`` may be pre-built or the sharded forest's
    duck-typed tables (default: the grid's width-1 face tables and flux
    tables on ``device``).  The last call's per-component [residual,
    iterations] device vectors stay in ``solve.last_stats``.  A call may
    pass the tables (``tab_arg``, ``flux_arg``) and a geometry ``geom``
    of its own: the bucketed forest binds one solve to every topology of
    a capacity bucket (its h^2 then squares the f32 spacing, as the JAX
    package's bucketed solve does)."""
    from cup3d_tpu_torch.grid.flux import build_flux_tables
    from cup3d_tpu_torch.ops import krylov

    if tab is None:
        tab = grid.face_tables(1, device)
    if flux_tab is None:
        flux_tab = build_flux_tables(grid, device)
    # h^2 in f64 rounded to f32, as the JAX package's
    h2 = torch.as_tensor((np.asarray(grid.h, np.float64) ** 2).reshape(
        grid.nb, 1, 1, 1), dtype=torch.float32, device=device)
    inv_h = 1.0 / torch.sqrt(h2)

    def solve(u: torch.Tensor, nudt, tab_arg=None, flux_arg=None,
              geom=None) -> torch.Tensor:
        t = tab if tab_arg is None else tab_arg
        ft = flux_tab if flux_arg is None else flux_arg
        if geom is None:
            g_, h2_, inv_h_ = grid, h2, inv_h
        else:
            g_ = geom
            h2_ = geom.h_column(u.dtype, u.device) ** 2
            inv_h_ = 1.0 / torch.sqrt(h2_)
        shift = h2_ / nudt  # the reference's coefficient -6 - h^2/(nu dt)
        outs, stats = [], []
        for c in range(3):
            b = u[..., c]

            def A(x, _c=c):
                return helmholtz_comp_blocks(g_, x, t, nudt, _c, ft,
                                             inv_h_)

            def M(r):
                return krylov.getz_blocks(shift * r, precond_iters,
                                          shift=shift)

            # x0 = b is a warm start: the relative tolerance stays on the
            # cold RHS norm
            x, rnorm, k = krylov.bicgstab(
                A, b, M=M, x0=b, tol_abs=tol_abs, tol_rel=tol_rel,
                maxiter=maxiter,
                rnorm_ref=torch.sqrt(torch.sum(b * b, dtype=torch.float32)))
            outs.append(x)
            stats.append(krylov.solver_stats(rnorm, k))
        solve.last_stats = stats
        return torch.stack(outs, dim=-1)

    solve.last_stats = []
    return solve


def advect_euler_blocks(grid, vel: torch.Tensor, dt, uinf: torch.Tensor,
                        tab) -> torch.Tensor:
    """Explicit advection-only Euler stage on the forest (KernelAdvect):
    u* = u - dt (u + uinf) . grad u, upwind5 on the face labs."""
    from cup3d_tpu_torch.ops.amr_ops import _hcol, _sh, _upwind_d1

    bs, w = grid.bs, tab.width
    vlab = tab.assemble_vector(vel, bs)
    inv_h = 1.0 / _hcol(grid, vel)
    adv_u = _sh(vlab, w, bs) + uinf
    out = []
    for c in range(3):
        lab_c = vlab[..., c]
        conv = 0.0
        for a in range(3):
            conv = conv + adv_u[..., a] * _upwind_d1(
                lab_c, w, bs, a, adv_u[..., a], inv_h)
        out.append(vel[..., c] - dt * conv)
    return torch.stack(out, dim=-1)


def implicit_step_blocks(grid, vel: torch.Tensor, dt, nu: float,
                         uinf: torch.Tensor, tab,
                         solver: Callable) -> torch.Tensor:
    """AdvectionDiffusionImplicit on the forest (main.cpp:10030-10118):
    explicit Euler advection on ``tab`` (width 3), then ``solver(u*, nu
    dt)``."""
    ustar = advect_euler_blocks(grid, vel, dt, uinf, tab)
    return solver(ustar, nu * dt)
