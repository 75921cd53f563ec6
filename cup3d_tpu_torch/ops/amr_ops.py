"""Differential operators on block-structured AMR fields (port of
``cup3d_tpu/ops/amr_ops.py``; reference KernelLHSPoisson main.cpp:9197-
9269, KernelAdvectDiffuse 9461-9639, KernelPressureRHS 14761-14948,
KernelGradP 14957-15056, ComputeVorticity 8624-8745).

Fields are ``(nb, bs, bs, bs[, 3])`` block batches; halo'd labs come from
the face tables (grid/faces.py), spatial derivatives are slices of the
lab, and each block scales by its own spacing ``h``.  Conservative
operators emit outward per-unit-area face fluxes for coarse-fine
refluxing (grid/flux.py).  ``grid`` is a BlockGrid, or the block-sharded
forest's padded geometry (parallel/forest.py) with its duck-typed tables:
the operators call only the assembly protocol (``assemble_*``,
``apply``) and the grid's ``nb``, ``bs`` and ``h_column``.

Not ported: ``force_integrals_blocks``, the chi-band force measure,
which no driver of the JAX package calls (its forest's ComputeForces is
the surface probe, ops/surface.py ``force_integrals_probe_blocks``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cup3d_tpu_torch.ops.advection import RK3_A, RK3_B


def _sh(lab: torch.Tensor, w: int, bs: int, ox=0, oy=0, oz=0) -> torch.Tensor:
    """Interior view of a (nb, L,L,L, ...) lab shifted by (ox,oy,oz)."""
    return lab[:, w + ox:w + ox + bs, w + oy:w + oy + bs, w + oz:w + oz + bs]


def _off(axis, k):
    o = [0, 0, 0]
    o[axis] = k
    return tuple(o)


def _hcol(grid, like: torch.Tensor, extra: int = 0) -> torch.Tensor:
    """(nb, 1, 1, 1[, 1]) per-block spacing in ``like``'s dtype/device."""
    h = grid.h_column(like.dtype, like.device)
    return h.reshape(h.shape + (1,) * extra)


def face_fluxes(lab: torch.Tensor, w: int, bs: int,
                inv_h: torch.Tensor) -> torch.Tensor:
    """Outward per-unit-area gradient fluxes (lab_nb - c)/h on the 6 faces:
    (nb, 6, bs, bs) in the grid/flux.py convention."""
    c = _sh(lab, w, bs)
    ih = inv_h[:, 0, 0, 0][:, None, None]  # (nb,1,1)
    fl = []
    for ax in range(3):
        lo = _sh(lab, w, bs, *_off(ax, -1))
        hi = _sh(lab, w, bs, *_off(ax, 1))
        fl.append((lo - c).select(ax + 1, 0) * ih)
        fl.append((hi - c).select(ax + 1, bs - 1) * ih)
    return torch.stack(fl, dim=1)


def stencil7(lab: torch.Tensor, w: int, bs: int) -> torch.Tensor:
    """-6 c + the six axis neighbours, summed in the JAX package's order."""
    s = -6.0 * _sh(lab, w, bs)
    for ax in range(3):
        s = s + _sh(lab, w, bs, *_off(ax, 1)) + _sh(lab, w, bs, *_off(ax, -1))
    return s


def laplacian_blocks(grid, field: torch.Tensor, tab,
                     flux_tab=None) -> torch.Tensor:
    """Refluxed 7-point Laplacian (the AMR ComputeLHS, main.cpp:9196-9328,
    in physical 1/h^2 units)."""
    bs = grid.bs
    w = tab.width
    lab = tab.assemble_scalar(field, bs)
    inv_h = 1.0 / _hcol(grid, field)
    out = stencil7(lab, w, bs) * inv_h * inv_h
    if flux_tab is not None and flux_tab.ncorr:
        out = flux_tab.apply(out, face_fluxes(lab, w, bs, inv_h))
    return out


def grad_blocks(grid, lab: torch.Tensor, w: int) -> torch.Tensor:
    """(nb,bs,bs,bs,3) centered gradient from a scalar lab."""
    bs = grid.bs
    inv2h = 0.5 / _hcol(grid, lab)
    return torch.stack(
        [(_sh(lab, w, bs, *_off(a, 1)) - _sh(lab, w, bs, *_off(a, -1)))
         * inv2h for a in range(3)], dim=-1)


def div_blocks(grid, vlab: torch.Tensor, w: int) -> torch.Tensor:
    """Centered divergence from a vector lab (nb, L,L,L, 3)."""
    bs = grid.bs
    inv2h = 0.5 / _hcol(grid, vlab)
    out = 0.0
    for a in range(3):
        out = out + (_sh(vlab[..., a], w, bs, *_off(a, 1))
                     - _sh(vlab[..., a], w, bs, *_off(a, -1)))
    return out * inv2h


def curl_blocks(grid, vlab: torch.Tensor, w: int) -> torch.Tensor:
    bs = grid.bs
    inv2h = 0.5 / _hcol(grid, vlab)

    def d(c, a):
        return (_sh(vlab[..., c], w, bs, *_off(a, 1))
                - _sh(vlab[..., c], w, bs, *_off(a, -1))) * inv2h

    return torch.stack(
        [d(2, 1) - d(1, 2), d(0, 2) - d(2, 0), d(1, 0) - d(0, 1)], dim=-1)


# ---------------------------------------------------------------------------
# advection-diffusion (explicit RK3) on blocks
# ---------------------------------------------------------------------------


def _upwind_d1(lab_c: torch.Tensor, w: int, bs: int, axis: int, vel, inv_h):
    """5th-order biased upwind derivative (KernelAdvectDiffuse,
    main.cpp:9474-9483) on a batched lab component."""
    q = [_sh(lab_c, w, bs, *_off(axis, k)) for k in range(-3, 4)]
    inv60h = inv_h / 60.0
    dplus = (
        -2.0 * q[0] + 15.0 * q[1] - 60.0 * q[2] + 20.0 * q[3] + 30.0 * q[4]
        - 3.0 * q[5]
    ) * inv60h
    dminus = (
        2.0 * q[6] - 15.0 * q[5] + 60.0 * q[4] - 20.0 * q[3] - 30.0 * q[2]
        + 3.0 * q[1]
    ) * inv60h
    return torch.where(vel > 0, dplus, dminus)


def advdiff_rhs_blocks(grid, vel: torch.Tensor, tab, nu: float,
                       uinf: torch.Tensor, flux_tab=None) -> torch.Tensor:
    """du/dt = -(u+uinf).grad(u) + nu lap(u), refluxing diffusive fluxes
    (reference AdvectionDiffusion, main.cpp:9640-9728)."""
    bs = grid.bs
    w = tab.width
    vlab = tab.assemble_vector(vel, bs)
    inv_h = 1.0 / _hcol(grid, vel)
    adv_u = _sh(vlab, w, bs) + uinf  # (nb,bs,bs,bs,3)

    rhs = []
    for c in range(3):
        lab_c = vlab[..., c]
        conv = 0.0
        for a in range(3):
            conv = conv + adv_u[..., a] * _upwind_d1(
                lab_c, w, bs, a, adv_u[..., a], inv_h)
        diff = nu * stencil7(lab_c, w, bs) * inv_h * inv_h
        out_c = diff - conv
        if flux_tab is not None and flux_tab.ncorr:
            fluxes = nu * face_fluxes(lab_c, w, bs, inv_h)
            out_c = flux_tab.apply(out_c, fluxes)
        rhs.append(out_c)
    return torch.stack(rhs, dim=-1)


def rk3_step_blocks(grid, vel: torch.Tensor, dt, nu: float,
                    uinf: torch.Tensor, tab, flux_tab=None) -> torch.Tensor:
    """Low-storage RK3 (Williamson; the reference's coefficients) —
    identical staging to the uniform path (ops/advection.rk3_step)."""
    k = torch.zeros_like(vel)
    u = vel
    for a, b in zip(RK3_A, RK3_B):
        k = a * k + dt * advdiff_rhs_blocks(grid, u, tab, nu, uinf, flux_tab)
        u = u + b * k
    return u


# ---------------------------------------------------------------------------
# AMR Poisson front-end
# ---------------------------------------------------------------------------


def forest_operator(geom, tab, flux_tab, vol: torch.Tensor,
                    mean_constraint: int = 2, slot0: int = 0):
    """The solver's A: the refluxed Laplacian, with the equation row of
    cell (0,0,0) of block ``slot0`` replaced by the volume-weighted mean
    times the total volume (mode 1) or by the cell's own value (mode 3)."""
    vol_total = torch.sum(vol) * geom.bs**3

    def A(x):
        out = laplacian_blocks(geom, x, tab, flux_tab)
        if mean_constraint == 1:
            out[slot0, 0, 0, 0] = torch.sum(x * vol) / vol_total * vol_total
        elif mean_constraint == 3:
            out[slot0, 0, 0, 0] = x[slot0, 0, 0, 0]
        return out

    return A


def build_amr_poisson_solver(grid, tol_abs: float = 1e-6,
                             tol_rel: float = 1e-4, maxiter: int = 1000,
                             precond_iters: int = 24, tab=None,
                             flux_tab=None,
                             vol: Optional[torch.Tensor] = None,
                             pmask: Optional[torch.Tensor] = None,
                             mean_constraint: int = 2,
                             two_level: Optional[bool] = None,
                             device="cpu"):
    """The static solver front-end (the JAX package's
    ``build_amr_poisson_solver``): the legacy composition of
    :func:`build_amr_poisson_solver_dynamic` (never the fused driver,
    whatever CUP3D_FUSED says) bound to one forest.  The block-sharded
    forest (parallel/forest.py) solves through it.

    ``tab``/``flux_tab`` may be pre-built or the sharded forest's
    duck-typed tables (default: the grid's faces-only tables of width 1
    and its flux tables on ``device``); ``vol`` overrides the per-block
    cell volume (the sharded forest passes zeros on padding) and
    ``pmask`` zeroes padding blocks after the mean shifts, so they never
    re-enter the iteration.  ``two_level`` overrides the CUP3D_COARSE
    default; the block-graph coarse level needs the grid's tree (the
    sharded forest's padded geometry has none, so its getZ is tile-only)
    and is off for the pinned-row modes.  Call contract: ``solve(rhs,
    x0=None, tab_arg=None, flux_arg=None, rnorm_ref=None,
    with_stats=False)``."""
    from cup3d_tpu_torch.grid.flux import build_flux_tables
    from cup3d_tpu_torch.ops import krylov

    if tab is None:
        tab = grid.face_tables(1, device)
    if flux_tab is None:
        flux_tab = build_flux_tables(grid, device)
    if vol is None:
        vol = torch.as_tensor((grid.h ** 3).reshape(grid.nb, 1, 1, 1),
                              dtype=torch.float32, device=device)
    # corner block: the leaf covering the domain corner in Hilbert order
    slot0 = int(np.lexsort((grid.ijk[:, 2], grid.ijk[:, 1],
                            grid.ijk[:, 0]))[0]) \
        if mean_constraint in (1, 3) else 0
    use_two = (krylov.use_coarse_correction() if two_level is None
               else bool(two_level))
    graph = None
    if (use_two and mean_constraint not in (1, 3)
            and hasattr(grid, "tree")):
        graph = krylov.block_graph_tables(grid, vol.device)
    core = build_amr_poisson_solver_dynamic(
        grid.bs, tol_abs=tol_abs, tol_rel=tol_rel, maxiter=maxiter,
        precond_iters=precond_iters, mean_constraint=mean_constraint,
        fused=False)

    def solve(rhs, x0=None, tab_arg=None, flux_arg=None, rnorm_ref=None,
              with_stats=False):
        return core(rhs, x0, tab_arg=tab if tab_arg is None else tab_arg,
                    flux_arg=flux_tab if flux_arg is None else flux_arg,
                    rnorm_ref=rnorm_ref, geom=grid, vol=vol, pmask=pmask,
                    graph=graph, slot0=slot0, with_stats=with_stats)

    solve.supports_stats = True
    solve.maxiter = maxiter
    return solve


def build_amr_poisson_solver_dynamic(bs: int, tol_abs: float = 1e-6,
                                     tol_rel: float = 1e-4,
                                     maxiter: int = 1000,
                                     precond_iters: int = 24,
                                     mean_constraint: int = 2,
                                     kernels: Optional[bool] = None,
                                     fused: Optional[bool] = None):
    """getZ-preconditioned BiCGSTAB on the AMR forest (the analogue of
    PoissonSolverAMR, main.cpp:14363-14616), with the JAX package's call
    contract: ``solve(rhs, x0=None, tab_arg, flux_arg, rnorm_ref, geom,
    vol, pmask, graph, slot0, with_stats)`` where ``geom`` is the
    BlockGrid, ``vol`` the (nb,1,1,1) cell volume, ``graph`` an optional
    krylov.BlockGraph (two-level preconditioner) and ``slot0`` the corner
    block of the pinned-row modes (an int, or a 0-dim long device tensor:
    the bucketed forest's pin slot moves across regrids without a read);
    ``pmask`` zeroes padding blocks (0 on padding, 1 on real blocks).

    ``mean_constraint``: 0 none, 1 the corner row is the volume-weighted
    mean, 2 (default) mean removal, 3 Dirichlet pin of the corner cell.
    ``CUP3D_FUSED=1`` (or ``auto`` under ``CUP3D_KRYLOV_DTYPE=bf16``)
    with mean removal and the exact getZ runs the fused driver
    (ops/fused_amr_bicgstab.py: the CUDA kernels on CUDA tensors) with
    Krylov vectors stored in ``precision.krylov_dtype()``; otherwise the
    legacy composition over krylov.bicgstab at f32,
    whose getZ is ``precond_iters`` CG sweeps per block under
    CUP3D_GETZ=cg (kernel B7 on CUDA tensors), with the block's own h^2
    folded into the rhs.  ``kernels`` is passed to every kernel wrapper
    (False: the plain versions on any device); ``fused=False`` keeps the
    legacy composition whatever CUP3D_FUSED says (the static front-end,
    :func:`build_amr_poisson_solver`)."""
    from cup3d_tpu_torch.ops import krylov, precision

    # the knobs are read here, when the solver is built; unlike the
    # uniform solver the forest's does not refuse bf16 without the fused
    # driver: its legacy composition then runs at f32, as the JAX
    # package's does
    fused_on = ((precision.use_fused() if fused is None else fused)
                and mean_constraint == 2 and krylov.use_exact_getz())
    store = precision.krylov_dtype()

    def solve(rhs, x0=None, tab_arg=None, flux_arg=None, rnorm_ref=None,
              geom=None, vol=None, pmask=None, graph=None, slot0=None,
              with_stats=False, lanes=False, live=None):
        if lanes:
            return solve_lanes(rhs, x0, tab_arg, flux_arg, rnorm_ref, geom,
                               vol, pmask, graph, with_stats, live)
        t, ft = tab_arg, flux_arg
        h_col = _hcol(geom, rhs)
        h2 = h_col * h_col
        vol_total = torch.sum(vol) * bs**3

        def wmean(x):
            return torch.sum(x * vol) / vol_total

        # the bucketed forest passes the pin slot as a device index (no
        # read); an int otherwise
        s0 = 0 if slot0 is None else (
            slot0 if isinstance(slot0, torch.Tensor) else int(slot0))
        A = forest_operator(geom, t, ft, vol, mean_constraint, s0)

        if graph is not None and mean_constraint not in (1, 3):
            def M(r):
                zc = krylov.coarse_correct_blocks(r, vol, graph)
                zf = zc[:, None, None, None].expand(r.shape).to(r.dtype)
                r2 = r - laplacian_blocks(geom, zf, t, ft)
                return krylov.getz_blocks(-h2 * r2, precond_iters,
                                          kernels) + zf
        else:
            def M(r):
                return krylov.getz_blocks(-h2 * r, precond_iters, kernels)

        if mean_constraint == 2:
            b = rhs - wmean(rhs)
        elif mean_constraint in (1, 3):
            b = rhs.clone()
            b[s0, 0, 0, 0] = 0.0
        else:
            b = rhs
        b = b * pmask if pmask is not None else b
        if rnorm_ref is None:
            rnorm_ref = torch.sqrt(torch.sum(b * b, dtype=torch.float32))
        if fused_on:
            from cup3d_tpu_torch.ops import fused_amr_bicgstab as _fused

            x, rnorm, k = _fused.fused_amr_bicgstab(
                geom, b, tab=t, ftab=ft, vol=vol, graph=graph,
                tol_abs=tol_abs, tol_rel=tol_rel, maxiter=maxiter,
                rnorm_ref=rnorm_ref, x0=x0, store_dtype=store,
                kernels=kernels)
        else:
            x, rnorm, k = krylov.bicgstab(
                A, b, M=M, x0=x0, tol_abs=tol_abs, tol_rel=tol_rel,
                maxiter=maxiter, rnorm_ref=rnorm_ref)
        if mean_constraint == 2:
            x = x - wmean(x)
        x = x * pmask if pmask is not None else x
        if with_stats:
            return x, krylov.solver_stats(rnorm, k)
        return x

    def solve_lanes(rhs, x0, t, ft, rnorm_ref, geom, vol, pmask, graph,
                    with_stats, live):
        """L independent systems on one topology, ``rhs`` (L, nb, bs, bs,
        bs), ``x0`` likewise or None, ``rnorm_ref`` (L,): mean removal and
        the masks per lane, the solve lane-batched (the fused driver's
        ``lanes``, or the legacy BiCGSTAB's).  ``live`` ((L,) bool or
        None): the lanes that solve at all; the others come back
        unsolved.  Mean removal only (the fleet's lanes)."""
        if mean_constraint != 2:
            raise ValueError("lane-batched forest solves remove the mean "
                             "(mean_constraint 2)")
        L, nb = rhs.shape[0], rhs.shape[1]
        vol_total = torch.sum(vol) * bs**3

        def wmean(x):
            return (torch.sum((x * vol).reshape(L, -1), dim=1)
                    / vol_total).reshape(L, 1, 1, 1, 1)

        b = rhs - wmean(rhs)
        b = b * pmask if pmask is not None else b
        if rnorm_ref is None:
            rnorm_ref = torch.sqrt(torch.sum((b * b).reshape(L, -1), dim=1,
                                             dtype=torch.float32))
        if fused_on:
            from cup3d_tpu_torch.ops import fused_amr_bicgstab as _fused

            flat = (L * nb,) + tuple(rhs.shape[2:])
            x, rnorm, k = _fused.fused_amr_bicgstab(
                geom, b.reshape(flat), tab=t, ftab=ft, vol=vol, graph=graph,
                tol_abs=tol_abs, tol_rel=tol_rel, maxiter=maxiter,
                rnorm_ref=rnorm_ref,
                x0=None if x0 is None else x0.reshape(flat),
                store_dtype=store, kernels=kernels, lanes=L, live=live)
            x = x.reshape(rhs.shape)
        else:
            h2 = _hcol(geom, rhs[0]) ** 2

            def A(x):
                return torch.func.vmap(
                    lambda u: laplacian_blocks(geom, u, t, ft))(x)

            def coarse(r):
                zc = krylov.coarse_correct_blocks(r, vol, graph)
                zf = zc[:, None, None, None].expand(r.shape).to(r.dtype)
                return zf, r - laplacian_blocks(geom, zf, t, ft)

            def M(r):
                # the tile solves see every lane's blocks at once
                if graph is not None:
                    zf, r2 = torch.func.vmap(coarse)(r)
                    return krylov.getz_blocks(-h2 * r2, precond_iters,
                                              kernels) + zf
                return krylov.getz_blocks(-h2 * r, precond_iters, kernels)

            x, rnorm, k = krylov.bicgstab(
                A, b, M=M, x0=x0, tol_abs=tol_abs, tol_rel=tol_rel,
                maxiter=maxiter, rnorm_ref=rnorm_ref, lanes=True, live=live)
        x = x - wmean(x)
        x = x * pmask if pmask is not None else x
        if with_stats:
            return x, krylov.solver_stats(rnorm, k)
        return x

    solve.supports_stats = True
    solve.maxiter = maxiter
    return solve


# ---------------------------------------------------------------------------
# pressure projection on blocks (reference PressureProjection,
# main.cpp:15061-15160, kernels 14761-15056)
# ---------------------------------------------------------------------------


def div_fluxes(vlab: torch.Tensor, w: int, bs: int) -> torch.Tensor:
    """Outward per-unit-area *velocity* fluxes of the centered divergence:
    F(+a) = +(u_c + u_hi)/2 . e_a, F(-a) = -(u_c + u_lo)/2 . e_a, so that
    div = (1/h) sum_f F — the flux form the reflux tables expect."""
    fl = []
    for ax in range(3):
        u = vlab[..., ax]
        c = _sh(u, w, bs)
        lo = _sh(u, w, bs, *_off(ax, -1))
        hi = _sh(u, w, bs, *_off(ax, 1))
        fl.append((-0.5 * (c + lo)).select(ax + 1, 0))
        fl.append((0.5 * (c + hi)).select(ax + 1, bs - 1))
    return torch.stack(fl, dim=1)


def pressure_rhs_blocks(grid, vel: torch.Tensor, dt, tab, flux_tab=None,
                        chi: Optional[torch.Tensor] = None,
                        udef: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rhs = div(u)/dt - chi div(u_def)/dt with conservative refluxing of
    the velocity fluxes (KernelPressureRHS, main.cpp:14761-14948)."""
    bs = grid.bs
    w = tab.width
    vlab = tab.assemble_vector(vel, bs)
    rhs = div_blocks(grid, vlab, w)
    if flux_tab is not None and flux_tab.ncorr:
        rhs = flux_tab.apply(rhs, div_fluxes(vlab, w, bs))
    if chi is not None and udef is not None:
        dlab = tab.assemble_vector(udef, bs)
        rhs = rhs - chi * div_blocks(grid, dlab, w)
    return rhs / dt


def project_blocks(grid, vel: torch.Tensor, dt, solver, tab, flux_tab=None,
                   chi=None, udef=None, p_init: Optional[torch.Tensor] = None,
                   second_order: bool = False, with_stats: bool = False):
    """Solve lap p = rhs and correct u -= dt grad p.  Returns (u, p) or,
    with ``with_stats``, (u, p, [residual, iterations]).

    ``p_init`` warm-starts the solve from the previous pressure; with
    ``second_order`` the reference's increment form (main.cpp:15087-
    15100): subtract lap(p_old) from the RHS, solve for the increment,
    add p_old back.  Both stop relative to the cold RHS norm."""
    bs = grid.bs
    rhs = pressure_rhs_blocks(grid, vel, dt, tab, flux_tab, chi, udef)
    ref = torch.sqrt(torch.sum(rhs * rhs, dtype=torch.float32))
    stats_kw = ({"with_stats": True}
                if with_stats and getattr(solver, "supports_stats", False)
                else {})
    if second_order and p_init is not None:
        rhs = rhs - laplacian_blocks(grid, p_init, tab, flux_tab)
        out = solver(rhs, None, tab_arg=tab, flux_arg=flux_tab,
                     rnorm_ref=ref, **stats_kw)
        p, stats = out if stats_kw else (out, None)
        p = p_init + p
    else:
        out = solver(rhs, p_init, tab_arg=tab, flux_arg=flux_tab,
                     rnorm_ref=ref, **stats_kw)
        p, stats = out if stats_kw else (out, None)
    plab = tab.assemble_scalar(p, bs)
    gp = grad_blocks(grid, plab, tab.width)
    if with_stats:
        if stats is None:
            stats = torch.zeros(2, dtype=torch.float32, device=vel.device)
        return vel - dt * gp, p, stats
    return vel - dt * gp, p


# ---------------------------------------------------------------------------
# refinement scores (ComputeVorticity + GradChiOnTmp tagging,
# main.cpp:8624-8745, 8540-8602)
# ---------------------------------------------------------------------------


def vorticity_score(grid, vel: torch.Tensor, tab) -> torch.Tensor:
    """(nb,) max |curl u| per block — the reference's tag magnitude."""
    vlab = tab.assemble_vector(vel, grid.bs)
    om = curl_blocks(grid, vlab, tab.width)
    mag = torch.sqrt(torch.sum(om * om, dim=-1))
    return torch.amax(mag.reshape(grid.nb, -1), dim=-1)


def gradchi_mask(grid, chi: torch.Tensor, tab) -> torch.Tensor:
    """(nb,) bool: block touches a body interface (grad chi != 0)."""
    clab = tab.assemble_scalar(chi, grid.bs)
    g = grad_blocks(grid, clab, tab.width)
    return torch.amax(torch.sum(g * g, dim=-1).reshape(grid.nb, -1),
                      dim=-1) > 0


# ---------------------------------------------------------------------------
# diagnostics on blocks (ComputeDissipation main.cpp:10347-10447,
# ComputeDivergence 8789-8919)
# ---------------------------------------------------------------------------


def _vel_gradients(grid, vlab: torch.Tensor, w: int):
    """g[c][a] = d u_c / d x_a as (nb,bs,bs,bs) tensors."""
    bs = grid.bs
    inv2h = 0.5 / _hcol(grid, vlab)
    return [[(_sh(vlab[..., c], w, bs, *_off(a, 1))
              - _sh(vlab[..., c], w, bs, *_off(a, -1))) * inv2h
             for a in range(3)] for c in range(3)]


def divergence_norms_blocks(grid, vel: torch.Tensor, tab):
    """(sum |div u| h^3, max |div u|) over the forest."""
    vlab = tab.assemble_vector(vel, grid.bs)
    d = div_blocks(grid, vlab, tab.width)
    vol = _hcol(grid, vel) ** 3
    return torch.sum(torch.abs(d) * vol), torch.max(torch.abs(d))


def dissipation_blocks(grid, vel: torch.Tensor, nu: float, tab) -> dict:
    """Energy-budget integrals with per-block cell volume (KernelDissipation
    semantics, main.cpp:10347-10435)."""
    bs = grid.bs
    w = tab.width
    vol = _hcol(grid, vel) ** 3
    vlab = tab.assemble_vector(vel, bs)
    g = _vel_gradients(grid, vlab, w)
    ss = 0.0
    for c in range(3):
        for a in range(3):
            s = 0.5 * (g[c][a] + g[a][c])
            ss = ss + s * s
    om = curl_blocks(grid, vlab, w)
    return {
        "kinetic_energy": 0.5 * torch.sum(torch.sum(vel * vel, dim=-1) * vol),
        "enstrophy": 0.5 * torch.sum(torch.sum(om * om, dim=-1) * vol),
        "dissipation_rate": 2.0 * nu * torch.sum(ss * vol),
    }
