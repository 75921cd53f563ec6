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
never TF32).  The forest's Helmholtz BiCGSTAB is not ported (ROADMAP
A6).
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
