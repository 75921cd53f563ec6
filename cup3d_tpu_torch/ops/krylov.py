"""Matrix-free Krylov machinery for the pressure solves (port of
``cup3d_tpu/ops/krylov.py``: the lane-layout part of the uniform grid,
and the blocks-layout getZ and block-graph coarse level of the AMR
forest).

Public functions keep the JAX package's lanes layout ``(bs, bs, bs, T)``
with tile index t = (tx*NBy + ty)*NBz + tz.  The fused driver
(ops/fused_bicgstab.py) works tile-major ``(T, bs, bs, bs)`` (one tile
contiguous), the same tile order; ``to_tiles``/``from_tiles`` convert
from/to the dense field in one permute, as ``to_lanes`` does.

The BiCGSTAB loops (here and in the fused driver) mirror the JAX
``lax.while_loop`` with a device predicate: iterations run in chunks of
:data:`ITER_CHUNK` with ONE host read of the predicate per chunk; inside a
chunk the iteration count, residual norm and best iterate only change
while the predicate holds, so results equal the JAX loop's.

``CUP3D_GETZ=cg`` selects the fixed-sweep CG getZ (kernel B7,
ops/getz_cg.py) in place of the exact tile solve; it runs the legacy
composition, as in the JAX package.  Still raising
NotImplementedError: the dense fallback for grids the tile size does not
divide (``_build_iterative_solver_dense``), whose reference crashes on
every grid that reaches it (ROADMAP queue C).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import sanctioned_transfer, upload
from cup3d_tpu_torch.grid.uniform import BC, UniformGrid
from cup3d_tpu_torch.ops import precision
from cup3d_tpu_torch.ops.stencils import laplacian_faces, laplacian_lanes_chunk

#: BiCGSTAB iterations between two host reads of the loop predicate
ITER_CHUNK = 4
#: iterations the legacy :func:`bicgstab` executed, chunk tails included:
#: each applies the preconditioner twice
iterations = {"executed": 0}


def _dot(a, b):
    """Global dot product accumulated in at least f32."""
    return torch.sum(a * b, dtype=precision.accum_dtype(a.dtype))


def _safe(d):
    """Floor |d| at 1e-30 (the JAX package's breakdown guard)."""
    return torch.where(torch.abs(d) > 1e-30, d,
                       torch.full_like(d, 1e-30))


class DeviceConsts:
    """numpy constants of a built operator, uploaded once per device."""

    def __init__(self, **arrays):
        self._np = arrays
        self._dev = {}

    def on(self, device) -> dict:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {k: upload(v, None, device, tag="table-upload")
                              for k, v in self._np.items()}
        return self._dev[key]


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def to_lanes(x: torch.Tensor, bs: int = 8) -> torch.Tensor:
    """(nx,ny,nz) -> (bs,bs,bs,T), T = (nx/bs)(ny/bs)(nz/bs)."""
    nx, ny, nz = x.shape
    t = x.reshape(nx // bs, bs, ny // bs, bs, nz // bs, bs)
    return t.permute(1, 3, 5, 0, 2, 4).reshape(bs, bs, bs, -1)


def from_lanes(t: torch.Tensor, shape) -> torch.Tensor:
    bs = t.shape[0]
    nbx, nby, nbz = (s // bs for s in shape)
    t = t.reshape(bs, bs, bs, nbx, nby, nbz)
    return t.permute(3, 0, 4, 1, 5, 2).reshape(shape)


def to_tiles(x: torch.Tensor, bs: int = 8) -> torch.Tensor:
    """(nx,ny,nz) -> tile-major (T,bs,bs,bs), contiguous, lanes' tile order."""
    nx, ny, nz = x.shape
    t = x.reshape(nx // bs, bs, ny // bs, bs, nz // bs, bs)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(-1, bs, bs, bs).contiguous()


def from_tiles(t: torch.Tensor, shape) -> torch.Tensor:
    bs = t.shape[-1]
    nbx, nby, nbz = (s // bs for s in shape)
    t = t.reshape(nbx, nby, nbz, bs, bs, bs)
    return t.permute(0, 3, 1, 4, 2, 5).reshape(shape)


def lanes_to_tiles(t: torch.Tensor) -> torch.Tensor:
    return t.permute(3, 0, 1, 2).contiguous()


def tiles_to_lanes(t: torch.Tensor) -> torch.Tensor:
    return t.permute(1, 2, 3, 0).contiguous()


# ---------------------------------------------------------------------------
# cross-tile neighbours: face planes, Laplacian, coarse face deltas
# ---------------------------------------------------------------------------


def _neighbour_tables(grid: UniformGrid, bs: int) -> DeviceConsts:
    """Per axis: the lane of the next/previous tile (periodic wrap at the
    domain edge) and the domain-edge masks — the gather form of the JAX
    package's lane rolls."""
    nb = tuple(s // bs for s in grid.shape)
    strides = (nb[1] * nb[2], nb[2], 1)
    lanes = np.arange(nb[0] * nb[1] * nb[2])
    tab = {}
    for ax in range(3):
        st, n = strides[ax], nb[ax]
        tco = lanes // st % n
        tab[f"nxt{ax}"] = np.where(tco == n - 1, lanes - (n - 1) * st,
                                   lanes + st)
        tab[f"prv{ax}"] = np.where(tco == 0, lanes + (n - 1) * st,
                                   lanes - st)
        tab[f"ehi{ax}"] = tco == n - 1
        tab[f"elo{ax}"] = tco == 0
    return DeviceConsts(**tab)


def make_tile_planes(grid: UniformGrid, bs: int = 8) -> Callable:
    """w (T,bs,bs,bs) tile-major -> (T,6,bs,bs) cross-tile neighbour face
    planes, rows [lo0, hi0, lo1, hi1, lo2, hi2] (see make_lane_planes)."""
    tabs = _neighbour_tables(grid, bs)
    periodic = [grid.bc[ax] == BC.periodic for ax in range(3)]

    def planes(t: torch.Tensor) -> torch.Tensor:
        c = tabs.on(t.device)
        rows = []
        for ax in range(3):
            p0 = t.select(ax + 1, 0)        # own low plane
            p1 = t.select(ax + 1, bs - 1)   # own high plane
            hi = p0.index_select(0, c[f"nxt{ax}"])  # next tile's low plane
            lo = p1.index_select(0, c[f"prv{ax}"])  # previous tile's high
            if not periodic[ax]:  # zero-gradient: clamp to own plane
                hi = torch.where(c[f"ehi{ax}"][:, None, None], p1, hi)
                lo = torch.where(c[f"elo{ax}"][:, None, None], p0, lo)
            rows += [lo, hi]
        return torch.stack(rows, dim=1)

    return planes


def make_lane_planes(grid: UniformGrid, bs: int = 8) -> Callable:
    """w (bs,bs,bs,T) -> (6,bs,bs,T) cross-tile neighbour face planes,
    rows [lo0, hi0, lo1, hi1, lo2, hi2]: row 2*ax+1 holds the +1
    neighbour of each tile's cells at local index bs-1 along ``ax``, row
    2*ax the -1 neighbour of the cells at index 0, with periodic wrap or
    zero-gradient clamp at the domain edge."""
    tile_planes = make_tile_planes(grid, bs)

    def planes(t: torch.Tensor) -> torch.Tensor:
        return tile_planes(lanes_to_tiles(t)).permute(1, 2, 3, 0)

    return planes


def make_laplacian_tiles(grid: UniformGrid, bs: int = 8) -> Callable:
    """The 7-point Laplacian / h^2 with the grid's BCs on tile-major fields."""
    planes_fn = make_tile_planes(grid, bs)
    inv_h2 = 1.0 / (grid.h * grid.h)

    def apply(t: torch.Tensor) -> torch.Tensor:
        pl = planes_fn(t)
        return laplacian_faces(t, [pl[:, k] for k in range(6)], inv_h2,
                               first=1)

    return apply


def make_laplacian_lanes(grid: UniformGrid, bs: int = 8) -> Callable:
    """The 7-point Laplacian / h^2 with the grid's BCs (periodic wrap /
    zero-gradient) on the lanes layout."""
    planes_fn = make_lane_planes(grid, bs)
    inv_h2 = 1.0 / (grid.h * grid.h)

    def apply(t: torch.Tensor) -> torch.Tensor:
        return laplacian_lanes_chunk(t, planes_fn(t), inv_h2)

    return apply


def make_face_deltas(grid: UniformGrid, bs: int = 8) -> Callable:
    """zc (T,) coarse tile values -> (6, T) face deltas of A zc, rows
    [lo0, hi0, lo1, hi1, lo2, hi2]: (neighbour - self)/h^2 across each
    tile face, with the BC's wrap or clamp (a wall face gives 0)."""
    tabs = _neighbour_tables(grid, bs)
    periodic = [grid.bc[ax] == BC.periodic for ax in range(3)]
    inv_h2 = 1.0 / (grid.h * grid.h)

    def deltas(zc: torch.Tensor) -> torch.Tensor:
        c = tabs.on(zc.device)
        rows = []
        for ax in range(3):
            nxt = zc.index_select(0, c[f"nxt{ax}"])
            prv = zc.index_select(0, c[f"prv{ax}"])
            if not periodic[ax]:
                nxt = torch.where(c[f"ehi{ax}"], zc, nxt)
                prv = torch.where(c[f"elo{ax}"], zc, prv)
            rows.append((prv - zc) * inv_h2)
            rows.append((nxt - zc) * inv_h2)
        return torch.stack(rows, dim=0)

    return deltas


# ---------------------------------------------------------------------------
# getZ and the two-level preconditioner
# ---------------------------------------------------------------------------


def use_exact_getz() -> bool:
    """The exact tile solve is the default; CUP3D_GETZ=cg selects the
    fixed-sweep CG getZ (kernel B7)."""
    return os.environ.get("CUP3D_GETZ", "") != "cg"


def getz_lanes(bt_scaled: torch.Tensor, shift=None, cg_iters: int = 24,
               kernels: Optional[bool] = None) -> torch.Tensor:
    """getZ in the lanes layout (bs, bs, bs, T): the exact DST tile solve,
    or ``cg_iters`` CG sweeps under CUP3D_GETZ=cg."""
    from cup3d_tpu_torch.ops import getz_cg, tilesolve

    if use_exact_getz():
        return tilesolve.tile_solve_lanes(bt_scaled, shift)
    return getz_cg.cg_tiles_lanes(bt_scaled, cg_iters,
                                  0.0 if shift is None else shift, kernels)


def getz_blocks(b_scaled: torch.Tensor, cg_iters: int = 24,
                kernels: Optional[bool] = None, shift=None) -> torch.Tensor:
    """getZ in the blocks layout (..., bs, bs, bs): (-lap_tile + shift) z
    = b_scaled on every block, by the exact tile solve or (CUP3D_GETZ=cg)
    ``cg_iters`` CG sweeps.  ``shift``: None (the Poisson getZ), a scalar
    or a per-block column (the forest Helmholtz's h^2/(nu dt))."""
    from cup3d_tpu_torch.ops import getz_cg, tilesolve

    if use_exact_getz():
        return tilesolve.tile_solve_blocks(b_scaled, shift)
    return getz_cg.cg_tiles_blocks(b_scaled, cg_iters,
                                   0.0 if shift is None else shift,
                                   kernels=kernels)


def use_coarse_correction() -> bool:
    """Two-level (tile + coarse) preconditioner unless CUP3D_COARSE=0."""
    return os.environ.get("CUP3D_COARSE", "1") != "0"


def _make_coarse_core(grid: UniformGrid, bs: int = 8) -> Callable:
    """(T,) tile sums (R = P^T r) -> (T,) coarse correction values: exact
    Galerkin coarse solve by per-axis eigendecomposition (pseudo-inverse
    on the constant mode), einsums in true f32."""
    nb = tuple(s // bs for s in grid.shape)
    Vs, lams = [], []
    for ax in range(3):
        n = nb[ax]
        if n == 1:
            L = np.zeros((1, 1))
        else:
            L = 2.0 * np.eye(n) - np.diag(np.ones(n - 1), 1) - np.diag(
                np.ones(n - 1), -1
            )
            if grid.bc[ax] == BC.periodic:
                L[0, -1] -= 1.0
                L[-1, 0] -= 1.0
            else:  # zero-gradient: no coupling through the wall
                L[0, 0] = 1.0
                L[-1, -1] = 1.0
        w, V = np.linalg.eigh(L)
        Vs.append(V)
        lams.append(w)
    scale = bs * bs / (grid.h * grid.h)
    lam3 = scale * (
        lams[0][:, None, None] + lams[1][None, :, None]
        + lams[2][None, None, :]
    )
    inv3 = np.where(lam3 > 1e-8 * scale, 1.0 / np.maximum(lam3, 1e-300), 0.0)
    f32 = np.float32
    consts = DeviceConsts(Vx=Vs[0].astype(f32), Vy=Vs[1].astype(f32),
                          Vz=Vs[2].astype(f32), inv3=inv3.astype(f32))
    T = nb[0] * nb[1] * nb[2]

    def core(rc_flat: torch.Tensor) -> torch.Tensor:
        c = consts.on(rc_flat.device)
        Vx, Vy, Vz = c["Vx"], c["Vy"], c["Vz"]
        if rc_flat.is_cuda:
            precision.check_fp32_matmul()
        rc = rc_flat.reshape(nb)
        t = torch.einsum("ia,abc->ibc", Vx.T, rc)
        t = torch.einsum("jb,ibc->ijc", Vy.T, t)
        t = torch.einsum("kc,ijc->ijk", Vz.T, t)
        t = -t * c["inv3"]  # A is the negative of the positive graph form
        t = torch.einsum("ai,ijk->ajk", Vx, t)
        t = torch.einsum("bj,ajk->abk", Vy, t)
        zc = torch.einsum("ck,abk->abc", Vz, t)
        return zc.reshape(T)

    return core


def _make_coarse_solve_vec(grid: UniformGrid, bs: int = 8) -> Callable:
    """(bs,bs,bs,T) residual -> (T,) coarse correction values."""
    core = _make_coarse_core(grid, bs)

    def solve_vec(rt: torch.Tensor) -> torch.Tensor:
        return core(torch.sum(rt, dim=(0, 1, 2)).reshape(-1))

    return solve_vec


def make_twolevel_preconditioner_lanes(grid: UniformGrid, h2: float,
                                       bs: int = 8,
                                       precond_iters: int = 24,
                                       kernels: Optional[bool] = None
                                       ) -> Callable:
    """Multiplicative two-level preconditioner on the lanes layout:
    zc = P (P^T A P)^+ P^T r, z = zc + getZ(r - A zc), with A zc (nonzero
    only on tile faces, zc being constant per tile) from the face deltas."""
    coarse_vec = _make_coarse_solve_vec(grid, bs)
    nb = tuple(s // bs for s in grid.shape)
    T = nb[0] * nb[1] * nb[2]
    deltas_fn = make_face_deltas(grid, bs)

    def lap_tileconst(zc: torch.Tensor) -> torch.Tensor:
        d = deltas_fn(zc)
        out = torch.zeros((bs, bs, bs, T), dtype=zc.dtype, device=zc.device)
        for ax in range(3):
            out.select(ax, bs - 1).add_(d[2 * ax + 1])
            out.select(ax, 0).add_(d[2 * ax])
        return out

    def M(r: torch.Tensor) -> torch.Tensor:
        zc = coarse_vec(r)
        z = getz_lanes(-h2 * (r - lap_tileconst(zc)),
                       cg_iters=precond_iters, kernels=kernels)
        return z + zc[None, None, None, :]

    return M


# ---------------------------------------------------------------------------
# AMR coarse level: one DOF per block over the forest's face graph
# ---------------------------------------------------------------------------

#: max face-neighbor entries per block under 26-neighbor 2:1 balance:
#: 6 faces x up to 4 finer blocks per face
GRAPH_K = 24


class BlockGraph(NamedTuple):
    """Face-adjacency graph of one forest topology, the coarse space of
    the AMR two-level preconditioner.  ``idx``/``w``: (nb, K) neighbor
    slots and couplings (w = 0 on unused entries); ``deg``: (nb,) row
    sums.  The coarse operator is the graph Laplacian C z = deg*z - W z,
    whose nullspace is the constant."""

    idx: torch.Tensor
    w: torch.Tensor
    deg: torch.Tensor


def block_graph_tables(grid, device="cpu", dtype=torch.float32,
                       cap: Optional[int] = None) -> BlockGraph:
    """Host-build the face graph of ``grid`` (a BlockGrid) — the JAX
    package's numpy build.  Couplings are the finite-volume face
    conductances A/d: w = bs^2 h for same-level faces (the exact Galerkin
    P^T A P of the uniform limit) and shared area over the 1.5 h_f center
    distance for coarse-fine faces (a symmetric, positive semidefinite
    approximation of the interpolated rows).  ``cap``: the bucket
    capacity to pad to (padding rows: idx 0, w 0, deg 0; the coarse CG's
    deflation mask keeps them exactly 0, and nothing divides by deg)."""
    tree = grid.tree
    bs = grid.bs
    nb = grid.nb
    idx = np.zeros((nb, GRAPH_K), np.int64)
    w = np.zeros((nb, GRAPH_K), np.float64)
    fill = np.zeros(nb, np.int64)

    def add(i, j, wij):
        k = fill[i]
        idx[i, k] = j
        w[i, k] = wij
        fill[i] = k + 1

    offs2 = [(0, 0), (0, 1), (1, 0), (1, 1)]
    for s, (l, bi, bj, bk) in enumerate(grid.keys):
        h = float(grid.h[s])
        for ax in range(3):
            t1, t2 = [a for a in range(3) if a != ax]
            for side in (-1, 1):
                npos = [bi, bj, bk]
                npos[ax] += side
                wp = tree.wrap(l, npos)
                if wp is None:
                    continue  # closed face: no coupling (zero-gradient)
                own = tree.owner_level(l, wp)
                if own == l:
                    add(s, grid.slot[(l, *wp)], bs * bs * h)
                elif own == l - 1:
                    parent = (l - 1, wp[0] // 2, wp[1] // 2, wp[2] // 2)
                    # fine side of a coarse-fine face: A = (bs h)^2,
                    # d = (h + 2h)/2 -> w = bs^2 h / 1.5
                    add(s, grid.slot[parent], bs * bs * h / 1.5)
                else:  # own == l + 1: 4 finer blocks, h_f = h/2
                    hf = 0.5 * h
                    for o1, o2 in offs2:
                        fpos = [0, 0, 0]
                        fpos[ax] = 2 * wp[ax] + (1 if side < 0 else 0)
                        fpos[t1] = 2 * wp[t1] + o1
                        fpos[t2] = 2 * wp[t2] + o2
                        fslot = grid._slot_maps[l + 1][tuple(fpos)]
                        if fslot < 0:
                            raise KeyError("fine neighbor missing: "
                                           "unbalanced tree")
                        add(s, int(fslot), bs * bs * hf / 1.5)
    deg = w.sum(axis=1)
    if cap is not None:
        from cup3d_tpu_torch.grid import bucket as bk

        idx = bk.pad_rows(idx, cap)
        w = bk.pad_rows(w, cap)
        deg = bk.pad_rows(deg, cap)
    return BlockGraph(
        idx=torch.as_tensor(idx, device=device),
        w=torch.as_tensor(w, device=device).to(dtype),
        deg=torch.as_tensor(deg, device=device).to(dtype),
    )


def _cg_graph(Cfun: Callable, b: torch.Tensor, iters: int,
              rtol: float = 1e-6) -> torch.Tensor:
    """Fixed-iteration CG on the (small) coarse system — fixed so the
    preconditioner is a FIXED linear operator.  Updates freeze once the
    relative residual drops below ``rtol``, and non-positive curvature
    directions (noise / the nullspace of the PSD C) are skipped.  Every
    scalar stays on the device: no host read."""
    acc = precision.accum_dtype(b.dtype)

    def dot(a, c):
        return torch.sum(a * c, dtype=acc)

    rs0 = dot(b, b)
    z = torch.zeros_like(b)
    r, p, rs = b, b, rs0
    for _ in range(iters):
        live = rs > (rtol * rtol) * rs0
        ap = Cfun(p)
        denom = dot(p, ap)
        ok = live & (denom > 0.0)
        alpha = torch.where(ok, rs / torch.where(ok, denom, 1.0), 0.0)
        z = z + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        beta = torch.where(ok, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        p = r + beta * p
        rs = rs_new
    return z


def coarse_solve_graph(rc: torch.Tensor, graph: BlockGraph,
                       iters: int = 32) -> torch.Tensor:
    """(nb,) restricted residual -> (nb,) per-block coarse correction:
    deflate the constant nullspace, fixed-sweep CG on the graph
    Laplacian, deflate again, and flip the sign (the fine A is the
    NEGATIVE of the positive graph form)."""
    rc = rc.to(graph.w.dtype)
    # an isolated block (deg 0: one block between closed walls) is no
    # coarse unknown and stays 0
    m = (graph.deg > 0).to(rc.dtype)
    nreal = torch.clamp(torch.sum(m), min=1.0)

    def deflate(v):
        return (v - torch.sum(v * m) / nreal) * m

    def C(z):
        return graph.deg * z - torch.sum(z[graph.idx] * graph.w, dim=-1)

    return -deflate(_cg_graph(C, deflate(rc), iters))


def coarse_correct_blocks(r: torch.Tensor, vol: torch.Tensor,
                          graph: BlockGraph, iters: int = 32) -> torch.Tensor:
    """Coarse correction over the block graph: volume-weighted restriction
    R r = sum_cells r h^3 to one value per block, then
    :func:`coarse_solve_graph`; the caller prolongs by constant
    injection."""
    rc = torch.sum(r * vol, dim=(1, 2, 3))
    return coarse_solve_graph(rc, graph, iters).to(r.dtype)


# ---------------------------------------------------------------------------
# restarted preconditioned BiCGSTAB
# ---------------------------------------------------------------------------


def iterate(state: dict, step: Callable, maxiter: int, target,
            live=None) -> tuple:
    """``while k < maxiter and rnorm > target: state = step(state)`` with
    one host read of the predicate per ITER_CHUNK iterations.  Inside a
    chunk ``step(state, active)`` runs unconditionally and must leave k,
    rnorm and the best iterate untouched where ``active`` (a 0-dim bool
    device tensor, or (L,) for L lane-batched systems: the loop runs while
    any lane is active) is False; once False it stays False, so tail
    iterations change nothing that is returned.  ``live`` (an (L,) bool
    device tensor, or None) leaves the lanes it marks False inactive from
    the start: their state is returned as it came in, and they hold no
    lane to their iteration count.  Returns (state, iterations executed,
    tail included)."""
    executed = 0

    def active_of(s):
        act = (s["k"] < maxiter) & (s["rnorm"] > target)
        return act if live is None else act & live

    while True:
        # the loop's one designed host read, once a chunk
        with sanctioned_transfer("krylov-chunk-read"):
            go = bool(active_of(state).any())
        if not go:
            break
        for _ in range(ITER_CHUNK):
            state = step(state, active_of(state))
            executed += 1
    return state, executed


def bicgstab(
    apply_A: Callable,
    b: torch.Tensor,
    M: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    tol_abs: float = 1e-6,
    tol_rel: float = 1e-4,
    maxiter: int = 1000,
    rnorm_ref=None,
    lanes: bool = False,
    live=None,
):
    """Preconditioned BiCGSTAB with breakdown re-seeding and best-x
    tracking (the reference's solve loop, main.cpp:14449-14604).  Returns
    (x_best, best residual norm, iterations) — the last two as 0-dim
    device tensors.  Stops when ||r|| <= max(tol_abs, tol_rel * ref),
    ref = ``rnorm_ref`` or ||r0||.

    ``lanes``: ``b`` is (L, ...), L independent systems solved at once
    (``apply_A`` and ``M`` act on the whole (L, ...) stack, lane by
    lane); every scalar is (L,), dots reduce per lane, and every lane
    iterates until the last one stops, a stopped lane frozen.  ``live``
    ((L,) bool) marks the lanes that solve at all (:func:`iterate`)."""
    if M is None:
        M = lambda r: r
    if x0 is None:
        x0 = torch.zeros_like(b)
    acc = precision.accum_dtype(b.dtype)
    eps = torch.full((), 1e-30, dtype=acc, device=b.device)
    if lanes:
        L = b.shape[0]
        shp = (L,)

        def dot(a, c):
            return torch.sum((a * c).reshape(L, -1), dim=1, dtype=acc)

        def C(v):
            return v.reshape((L,) + (1,) * (b.dim() - 1))
    else:
        shp = ()
        dot = _dot

        def C(v):
            return v

    r0 = b - apply_A(x0)
    rnorm0 = torch.sqrt(dot(r0, r0))
    ref = rnorm0 if rnorm_ref is None else rnorm_ref
    target = torch.clamp(tol_rel * ref, min=tol_abs)
    one = torch.ones(shp, dtype=b.dtype, device=b.device)

    init = dict(k=torch.zeros(shp, dtype=torch.int32, device=b.device),
                x=x0, r=r0, rhat=r0, p=torch.zeros_like(b),
                v=torch.zeros_like(b), rho=one, alpha=one, omega=one,
                rnorm=rnorm0, x_best=x0, rnorm_best=rnorm0)

    def step(s, active):
        rho_new = dot(s["rhat"], s["r"])
        rn2 = s["rnorm"] * s["rnorm"]
        broke = torch.abs(rho_new) < eps * torch.clamp(rn2, min=1.0)
        rhat = torch.where(C(broke), s["r"], s["rhat"])
        rho_new = torch.where(broke, rn2, rho_new)
        p_prev = torch.where(C(broke), 0.0, s["p"])
        v_prev = torch.where(C(broke), 0.0, s["v"])
        beta = (rho_new / _safe(s["rho"])) * (s["alpha"] / _safe(s["omega"]))
        beta = torch.where(broke, 0.0, beta)
        p = s["r"] + C(beta) * (p_prev - C(s["omega"]) * v_prev)
        y = M(p)
        v = apply_A(y)
        alpha = rho_new / _safe(dot(rhat, v))
        svec = s["r"] - C(alpha) * v
        z = M(svec)
        t = apply_A(z)
        omega = dot(t, svec) / _safe(dot(t, t))
        x = s["x"] + C(alpha) * y + C(omega) * z
        r = svec - C(omega) * t
        rnorm = torch.sqrt(dot(r, r))
        better = rnorm < s["rnorm_best"]
        return dict(
            k=s["k"] + active.to(torch.int32), x=x, r=r, rhat=rhat, p=p, v=v,
            rho=rho_new, alpha=alpha, omega=omega,
            rnorm=torch.where(active, rnorm, s["rnorm"]),
            x_best=torch.where(C(active & better), x, s["x_best"]),
            rnorm_best=torch.where(
                active, torch.minimum(rnorm, s["rnorm_best"]),
                s["rnorm_best"]),
        )

    out, executed = iterate(init, step, maxiter, target, live)
    iterations["executed"] += executed
    return out["x_best"], out["rnorm_best"], out["k"]


# ---------------------------------------------------------------------------
# Poisson front-end
# ---------------------------------------------------------------------------


def build_iterative_solver(
    grid: UniformGrid,
    tol_abs: float = 1e-6,
    tol_rel: float = 1e-4,
    maxiter: int = 1000,
    precond_bs: int = 8,
    precond_iters: int = 24,
    mean_constraint: int = 2,
    two_level: Optional[bool] = None,
    kernels: Optional[bool] = None,
) -> Callable:
    """solve(rhs, x0=None, with_stats=False) -> p via getZ-preconditioned
    BiCGSTAB, with the JAX package's contract: ``mean_constraint`` 0 =
    none, 1 = row (0,0,0) is the volume-weighted mean, 2 = mean removal
    (default), 3 = Dirichlet pin of cell (0,0,0); the relative tolerance
    references the cold RHS norm; ``with_stats`` also returns the (2,)
    f32 device vector [residual, iterations].

    CUP3D_FUSED=1 (or ``auto`` under CUP3D_KRYLOV_DTYPE=bf16) with mean
    removal and the exact getZ runs the fused driver (the CUDA kernels on
    a CUDA tensor) with Krylov vectors stored in
    ``precision.krylov_dtype()``; otherwise the legacy composition at f32
    (kernel B7 on a CUDA tensor under CUP3D_GETZ=cg).  bf16 under
    CUP3D_FUSED=0 raises ValueError (precision.check_policy).  The knobs
    are read here, when the solver is built.
    ``kernels`` is passed to every kernel wrapper (False: the plain
    versions on any device)."""
    if any(s % precond_bs for s in grid.shape):
        raise NotImplementedError(
            f"grid {grid.shape} is not divisible by the tile size "
            f"{precond_bs}: the dense-layout fallback is not ported, "
            "because the reference's crashes on every grid that reaches it "
            "(its block-CG preconditioner tiles the same grid by the same "
            "tile size; ROADMAP queue C)")
    precision.check_policy(mean_constraint)
    A0 = make_laplacian_lanes(grid, precond_bs)
    h2 = grid.h * grid.h
    h3 = grid.h ** 3
    # the replaced row is rescaled to the Laplacian's diagonal magnitude
    # (6/h^2); its RHS entry is zeroed, so the solution is unchanged
    pin = 6.0 / h2
    if mean_constraint == 1:
        def A(t):
            out = A0(t)
            out[0, 0, 0, 0] = torch.sum(t) * h3 * pin
            return out
    elif mean_constraint == 3:
        def A(t):
            out = A0(t)
            out[0, 0, 0, 0] = t[0, 0, 0, 0] * pin
            return out
    else:
        A = A0

    use_two = (use_coarse_correction() if two_level is None
               else bool(two_level))
    if use_two and mean_constraint not in (1, 3):
        M = make_twolevel_preconditioner_lanes(grid, h2, precond_bs,
                                               precond_iters, kernels)
    else:
        # the pinned rows make A nonsingular, which the coarse level's
        # pseudo-inverse would undo: tile-only getZ there
        def M(r):
            return getz_lanes(-h2 * r, cg_iters=precond_iters,
                              kernels=kernels)

    # the fused driver runs the exact getZ only: CUP3D_GETZ=cg keeps the
    # legacy composition, as in the JAX package
    if precision.use_fused() and mean_constraint == 2 and use_exact_getz():
        from cup3d_tpu_torch.ops import fused_bicgstab as _fused

        store = precision.krylov_dtype()

        def solve(rhs: torch.Tensor, x0: Optional[torch.Tensor] = None,
                  with_stats: bool = False):
            b = rhs - torch.mean(rhs)
            bt = to_tiles(b, precond_bs)
            x0t = None if x0 is None else to_tiles(x0, precond_bs)
            xt, rnorm, k = _fused.fused_bicgstab_tiles(
                grid, bt, tol_abs=tol_abs, tol_rel=tol_rel,
                maxiter=maxiter, rnorm_ref=torch.sqrt(_dot(bt, bt)),
                x0=x0t, two_level=use_two, store_dtype=store,
                kernels=kernels,
            )
            x = from_tiles(xt, rhs.shape)
            x = x - torch.mean(x)
            if with_stats:
                return x, solver_stats(rnorm, k)
            return x

        solve.supports_stats = True
        solve.maxiter = maxiter
        return solve

    def solve(rhs: torch.Tensor, x0: Optional[torch.Tensor] = None,
              with_stats: bool = False):
        b = rhs - torch.mean(rhs) if mean_constraint == 2 else rhs
        bt = to_lanes(b, precond_bs)
        if mean_constraint in (1, 3):
            bt = bt.clone()
            bt[0, 0, 0, 0] = 0.0
        x0t = None if x0 is None else to_lanes(x0, precond_bs)
        xt, rnorm, k = bicgstab(
            A, bt, M=M, x0=x0t, tol_abs=tol_abs, tol_rel=tol_rel,
            maxiter=maxiter, rnorm_ref=torch.sqrt(_dot(bt, bt)),
        )
        x = from_lanes(xt, rhs.shape)
        x = x - torch.mean(x) if mean_constraint == 2 else x
        if with_stats:
            return x, solver_stats(rnorm, k)
        return x

    solve.supports_stats = True
    solve.maxiter = maxiter
    return solve


def solver_stats(rnorm, k) -> torch.Tensor:
    """(2,) f32 device vector [residual norm, iterations]; (L, 2) for the
    (L,) residuals and counts of L lane-batched systems."""
    return torch.stack([torch.as_tensor(rnorm).to(torch.float32),
                        torch.as_tensor(k).to(torch.float32)], dim=-1)
