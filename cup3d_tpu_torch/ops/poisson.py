"""Pressure Poisson solvers (port of ``cup3d_tpu/ops/poisson.py``).

``spectral``: the uniform-grid Laplacian with periodic / zero-gradient
boundaries is diagonalized exactly by per-axis orthonormal transforms
(real Fourier rows on periodic axes, DCT-II on Neumann axes), applied as
dense f32 basis products.  ``iterative``: getZ-preconditioned BiCGSTAB
(ops/krylov.py), the path whose fused iteration runs the CUDA kernels.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cup3d_tpu_torch.grid.uniform import BC, UniformGrid
from cup3d_tpu_torch.ops import precision
from cup3d_tpu_torch.ops.krylov import DeviceConsts


def dct2_matrix(n: int, dtype=np.float64) -> np.ndarray:
    """Orthonormal DCT-II basis matrix C with X = C @ x, x = C.T @ X."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    c = np.cos(np.pi * k * (2 * j + 1) / (2 * n)) * np.sqrt(2.0 / n)
    c[0] *= np.sqrt(0.5)
    return c.astype(dtype)


def rfourier_matrix(n: int, dtype=np.float64):
    """Orthonormal *real* Fourier basis R (n x n) and per-row frequencies:
    DC, (cos, sin) pairs for k = 1..ceil(n/2)-1, Nyquist when n is even."""
    j = np.arange(n)
    rows = [np.full(n, 1.0 / np.sqrt(n))]
    freqs = [0]
    for k in range(1, (n + 1) // 2):
        rows.append(np.sqrt(2.0 / n) * np.cos(2 * np.pi * k * j / n))
        freqs.append(k)
        rows.append(np.sqrt(2.0 / n) * np.sin(2 * np.pi * k * j / n))
        freqs.append(k)
    if n % 2 == 0:
        rows.append(((-1.0) ** j) / np.sqrt(n))
        freqs.append(n // 2)
    return np.stack(rows).astype(dtype), np.asarray(freqs)


def _axis_spectrum(n: int, periodic: bool, operator: str):
    """(basis matrix, eigenvalues*h^2) for one axis; f64 construction."""
    if periodic:
        mat, freqs = rfourier_matrix(n)
        theta = 2.0 * np.pi * freqs / n
    else:
        mat = dct2_matrix(n)
        theta = np.pi * np.arange(n) / n
    if operator == "compact":
        lam = 2.0 * np.cos(theta) - 2.0
    elif operator == "consistent":
        lam = -np.sin(theta) ** 2
    else:
        raise ValueError(operator)
    return mat, lam


def _apply_mat(mat, f, axis):
    out = torch.tensordot(mat, f, dims=([1], [axis]))
    return torch.movedim(out, 0, axis)


def make_poisson_solver(grid: UniformGrid, kind: str = "spectral",
                        dtype=torch.float32, tol_abs: float = 1e-6,
                        tol_rel: float = 1e-4, maxiter: int = 1000,
                        mean_constraint: int = 2,
                        two_level=None) -> Callable:
    """The reference's makePoissonSolver (main.cpp:14747-14758):
    "spectral" = exact uniform-grid diagonalization, "iterative" =
    getZ-preconditioned BiCGSTAB (CUP3D_FUSED / CUP3D_KRYLOV_DTYPE as in
    ops/precision.py)."""
    if kind == "spectral":
        return build_spectral_solver(grid, dtype)
    if kind == "iterative":
        from cup3d_tpu_torch.ops.krylov import build_iterative_solver

        return build_iterative_solver(
            grid, tol_abs=tol_abs, tol_rel=tol_rel, maxiter=maxiter,
            mean_constraint=mean_constraint, two_level=two_level,
        )
    raise ValueError(f"unknown poissonSolver {kind!r}")


def build_spectral_solver(grid: UniformGrid, dtype=torch.float32,
                          operator: str = "consistent") -> Callable:
    """solve(rhs, x0=None) -> p with mean(p) = 0; zero-gradient pressure
    on wall/freespace faces.  ``operator="consistent"`` (default) makes
    projection remove the centered divergence exactly; "compact" solves
    the literal 7-point system.  ``x0`` is accepted for interface parity
    and ignored (a direct solve)."""
    periodic = [b == BC.periodic for b in grid.bc]
    h = grid.h
    np_dtype = str(dtype).replace("torch.", "")

    mats = {}
    lams = []
    for a, (n, p) in enumerate(zip(grid.shape, periodic)):
        mat, lam = _axis_spectrum(n, p, operator)
        mats[f"m{a}"] = mat.astype(np_dtype)
        lams.append(lam)

    lam = (
        lams[0][:, None, None] + lams[1][None, :, None] + lams[2][None, None, :]
    ) / (h * h)
    lam_flat = lam.reshape(-1)
    inv = np.zeros_like(lam_flat)
    nz = np.abs(lam_flat) > 1e-12 * np.max(np.abs(lam_flat))
    inv[nz] = 1.0 / lam_flat[nz]
    consts = DeviceConsts(inv=inv.reshape(lam.shape).astype(np_dtype), **mats)

    def solve(rhs: torch.Tensor, x0=None) -> torch.Tensor:
        c = consts.on(rhs.device)
        if rhs.is_cuda:
            precision.check_fp32_matmul()
        f = rhs.to(dtype)
        for a in range(3):
            f = _apply_mat(c[f"m{a}"], f, a)
        f = f * c["inv"]
        for a in range(3):
            f = _apply_mat(c[f"m{a}"].T, f, a)
        p = f.to(rhs.dtype)
        return p - torch.mean(p)

    return solve
