"""Fused-iteration BiCGSTAB for the uniform pressure solve (port of
``cup3d_tpu/ops/fused_bicgstab.py``).

Each iteration runs five stages; on a CUDA tensor each is a hand-written
kernel (csrc/fused_bicgstab.cu), beside it sits a plain PyTorch version
of the same function (a port of the JAX package's ``*_math`` helpers):

- ``update``  (B1) p/rhat recurrence + breakdown select + per-tile sum p
- ``getz_two`` (B2) exact DST tile solve + the two-level coarse/face terms
- ``getz_tile`` (B3) the same tile solve without the coarse level
  (``two_level=False``: ``CUP3D_COARSE=0`` and the recovery ladder's
  tile-only rung)
- ``lap``     (B4) cross-tile Laplacian apply + the iteration's dot partials
  (the kernel reads its neighbour faces from w itself: :class:`LapGeom`)
- ``axpy``    (B5) s = r - alpha v + per-tile sum s
- ``finish``  (B6) x/r updates + the residual/rho dot partials

Layout: the stages take TILE-MAJOR vectors ``(T, 8, 8, 8)`` (one tile
contiguous, the JAX lane index as tile index); the public driver
:func:`fused_bicgstab` takes and returns the JAX lanes layout and converts
once at entry and exit.

Storage (``CUP3D_KRYLOV_DTYPE``, ops/precision.py): the Krylov vectors
r, rhat, p, v, y, z, s, t are stored in f32 or bf16, x always in f32.
Each stage computes in f32 and rounds to the storage dtype only at its
store, and sums its partials over the stored (rounded) values, as the
JAX package's ``*_math`` helpers do; a stage takes its storage dtype from
its vectors and launches that dtype's kernel (``cup3d_<stage>`` or
``cup3d_<stage>_bf16``; a dtype without a kernel raises).  The driver
starts from the f32 residual (its norm and rho) and iterates on its
stored copy.

Partials are per tile, ``(T,)`` f32, combined by
one ``torch.sum`` (:func:`_combine`) — no float atomics, so reruns are
bitwise equal.  Iteration scalars stay on the device: stages read them
from an 8-float device row (:func:`_scalars`).

Dispatch (the JAX ``kernels=`` argument): ``kernels=None`` launches the
kernel for a CUDA tensor and runs the plain version for a CPU tensor;
``kernels=False`` runs the plain version on any device (tests and the
card comparisons); ``kernels=True`` on a CPU tensor raises.  A CUDA
tensor never falls back to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from cup3d_tpu_torch.analysis import runtime
from cup3d_tpu_torch.grid.uniform import BC
from cup3d_tpu_torch.ops import cuda_lib, krylov, tilesolve
from cup3d_tpu_torch.ops.stencils import laplacian_faces

_F32 = torch.float32
BS = 8

#: kernel launches per stage, counted by the wrappers where they launch:
#: the f32 kernels' here, the bf16 kernels' in ``launches_bf16``
launches = {"update": 0, "getz_two": 0, "getz_tile": 0, "lap": 0,
            "axpy": 0, "finish": 0}
launches_bf16 = dict.fromkeys(launches, 0)
#: B4 launches without partials (``lap(x, None, ...)``: the warm start's
#: residual r0 = b - A x0, one a warm-started solve), counted apart so
#: that the per-stage counts above stay per iteration
residual_launches = {"lap": 0}
#: iterations the fused driver executed, chunk tails included: each runs
#: update/axpy/finish once and getz (two-level or tile-only) and lap twice
iterations = {"executed": 0}


def reset_launches() -> None:
    for counts in (launches, launches_bf16, residual_launches):
        for name in counts:
            counts[name] = 0
    iterations["executed"] = 0


#: the kernel table's names of the stages
KERNEL_IDS = {"update": "B1", "getz_two": "B2", "getz_tile": "B3",
              "lap": "B4", "axpy": "B5", "finish": "B6"}


def _count(stage: str, dtype, *outs) -> None:
    """One launch of ``stage``'s kernel for storage ``dtype``; under
    ``analysis.runtime.debug_nans`` its outputs ``outs`` are checked."""
    (launches_bf16 if dtype == torch.bfloat16 else launches)[stage] += 1
    if runtime.NAN_CHECKS[0]:
        runtime.check_kernel_outputs(
            f"{KERNEL_IDS.get(stage, stage)} (cup3d_{stage})", *outs)


# ---------------------------------------------------------------------------
# plain versions (ports of the JAX *_math helpers), tile-major
# ---------------------------------------------------------------------------


def _cellsum(a: torch.Tensor) -> torch.Tensor:
    """Per-tile partial: reduce the 512 cells of each tile -> (T,)."""
    return torch.sum(a.to(_F32), dim=(1, 2, 3))


def _azc_from_aux(aux: torch.Tensor, bs: int = BS) -> torch.Tensor:
    """(8, T) coarse aux rows -> A zc tile-major (T, bs, bs, bs): rows
    0..5 are the face deltas (lo0, hi0, lo1, hi1, lo2, hi2), row 6 zc.
    Per axis (face, zeros, face) concatenation, summed over the axes."""
    T = aux.shape[-1]
    total = None
    for ax in range(3):
        shp_face = [T, bs, bs, bs]
        shp_face[ax + 1] = 1
        shp_mid = [T, bs, bs, bs]
        shp_mid[ax + 1] = bs - 2
        lo = aux[2 * ax][:, None, None, None].expand(shp_face)
        hi = aux[2 * ax + 1][:, None, None, None].expand(shp_face)
        mid = torch.zeros(shp_mid, dtype=aux.dtype, device=aux.device)
        part = torch.cat([lo, mid, hi], dim=ax + 1)
        total = part if total is None else total + part
    return total


def _f32(*vecs):
    return tuple(a.to(_F32) for a in vecs)


def _update_math(r, p, v, rhat, beta, omega, broke, store=_F32):
    """p/rhat recurrence with the breakdown re-seed folded in: on breakdown
    p and v are selected to zero (not scaled by beta = 0, so a
    non-finite p or v cannot leak through 0 * inf) and rhat = r.  f32
    arithmetic, rounded to ``store`` at the store; the partial sums the
    stored p."""
    r32, p32, v32, rh32 = _f32(r, p, v, rhat)
    b = broke > 0.5
    p_eff = torch.where(b, 0.0, p32)
    v_eff = torch.where(b, 0.0, v32)
    p_st = (r32 + beta * (p_eff - omega * v_eff)).to(store)
    rh_st = torch.where(b, r32, rh32).to(store)
    return p_st, rh_st, _cellsum(p_st)


def _getz_math(w, aux, S3, lam, h2, two_level, store=_F32):
    """y = zc + tilesolve(-h2 (w - A zc)) (two-level) or
    y = tilesolve(-h2 w) (tile-only); two (512, 512) f32 matmuls, y
    rounded to ``store``."""
    w32 = w.to(_F32)
    if two_level:
        b = -h2 * (w32 - _azc_from_aux(aux))
    else:
        b = -h2 * w32
    T = b.shape[0]
    if b.is_cuda:
        from cup3d_tpu_torch.ops import precision

        precision.check_fp32_matmul()
    # tile-major rows: b2 (T, 512); S3 symmetric, so rows @ S3 == S3 @ cols
    t = b.reshape(T, -1) @ S3
    t = t / lam
    y = (t @ S3).reshape(b.shape)
    if two_level:
        y = y + aux[6][:, None, None, None]
    return y.to(store)


def _lap_math(w, planes, a, inv_h2, store=_F32):
    """Cross-tile Laplacian + per-tile partials of a . Aw and Aw . Aw
    over the stored Aw; ``planes`` (T, 6, bs, bs) from
    krylov.make_tile_planes.  ``a`` None: Aw alone (partials None)."""
    w32, pl32 = _f32(w, planes)
    aw = laplacian_faces(w32, [pl32[:, k] for k in range(6)], inv_h2,
                         first=1).to(store)
    if a is None:
        return aw, None, None
    aw32 = aw.to(_F32)
    return aw, _cellsum(a.to(_F32) * aw32), _cellsum(aw32 * aw32)


def _axpy_math(r, v, alpha, store=_F32):
    r32, v32 = _f32(r, v)
    s = (r32 - alpha * v32).to(store)
    return s, _cellsum(s)


def _finish_math(x, y, z, s, t, rhat, alpha, omega, store=_F32):
    """x (f32, the wide accumulator over the narrow stored directions)
    and r updates + the residual / next-rho partials over the stored r."""
    y32, z32, s32, t32, rh32 = _f32(y, z, s, t, rhat)
    x_new = x + alpha * y32 + omega * z32
    r_st = (s32 - omega * t32).to(store)
    r32 = r_st.to(_F32)
    return x_new, r_st, _cellsum(r32 * r32), _cellsum(rh32 * r32)


# ---------------------------------------------------------------------------
# stage wrappers: CUDA kernel for a CUDA tensor, plain version otherwise
# ---------------------------------------------------------------------------


def _use_kernel(t: torch.Tensor, kernels: Optional[bool]) -> bool:
    if kernels is False:
        return False
    if t.is_cuda:
        return True
    if kernels:
        raise ValueError("kernels=True needs CUDA tensors; the CUDA "
                         "kernels do not run on the CPU")
    return False


#: storage dtypes the kernels are built for -> the suffix of their entry
#: points (csrc/fused_bicgstab.cu: cup3d_update, cup3d_update_bf16, ...)
STORES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _entry(name: str, dtype) -> str:
    """The C entry point of stage ``name`` for storage ``dtype`` (checked
    by :func:`_check_vecs`)."""
    return name + STORES[dtype]


def _check_vecs(*vecs: torch.Tensor, dtype=None) -> int:
    """Stage vectors: CUDA, one storage dtype (``dtype``, else the first
    vector's), contiguous, 16-byte aligned, (T,8,8,8) on one device.
    Returns T.  A dtype no kernel is built for raises: nothing is cast
    quietly."""
    T = vecs[0].shape[0]
    dev = vecs[0].device
    dtype = vecs[0].dtype if dtype is None else dtype
    if dtype not in STORES:
        raise ValueError(f"no kernel for {dtype} storage: the kernels take "
                         f"f32 or bf16 vectors")
    for v in vecs:
        if (v.device != dev or v.dtype != dtype or not v.is_contiguous()
                or tuple(v.shape) != (T, BS, BS, BS)
                or v.data_ptr() % 16):
            raise ValueError(
                f"stage vector must be contiguous 16-byte aligned {dtype} "
                f"(T,8,8,8) on {dev}; got {tuple(v.shape)} {v.dtype} "
                f"{v.device} contiguous={v.is_contiguous()}")
    if T < 1:
        raise ValueError("empty vector")
    return T


def _check_small(t: torch.Tensor, shape, dev, aligned=False) -> None:
    """A contiguous f32 ``shape`` on ``dev``; 16-byte aligned where the
    kernel reads it in 16-byte vectors (``aligned``)."""
    if (t.device != dev or t.dtype != _F32 or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)
            or (aligned and t.data_ptr() % 16)):
        raise ValueError(f"expected contiguous {_F32} {tuple(shape)} on "
                         f"{dev}{', 16-byte aligned' if aligned else ''}, "
                         f"got {tuple(t.shape)} {t.dtype} {t.device} at "
                         f"{t.data_ptr() % 16} bytes past 16")


def _lib():
    return cuda_lib.load()


def update(r, p, v, rhat, scal, kernels=None):
    """B1: (p_new, rhat_new, per-tile sum p_new); scal = (beta, omega,
    broke, ...); the vectors in their storage dtype (f32 or bf16).  The
    kernel updates p and rhat in place (returned)."""
    if not _use_kernel(r, kernels):
        return _update_math(r, p, v, rhat, scal[0], scal[1], scal[2],
                            p.dtype)
    T = _check_vecs(r, p, v, rhat)
    _check_small(scal, (8,), r.device)
    if len({r.data_ptr(), p.data_ptr(), v.data_ptr(), rhat.data_ptr()}) < 4:
        raise ValueError("update: r, p, v and rhat must not share memory")
    ts = torch.empty(T, dtype=_F32, device=r.device)
    _lib().call(_entry("cup3d_update", r.dtype), r.data_ptr(), p.data_ptr(),
                v.data_ptr(), rhat.data_ptr(), scal.data_ptr(), None,
                ts.data_ptr(), T, T, cuda_lib.stream(r.device))
    _count("update", r.dtype, p, rhat, ts)
    return p, rhat, ts


def getz_two(w, aux, h2, kernels=None):
    """B2: y = zc + tilesolve(-h2 (w - A zc)) in w's storage dtype; aux
    (8, T) f32 = six face deltas, zc, zero row."""
    S3, lam, S1 = tilesolve.basis(BS, _F32, str(w.device))
    if not _use_kernel(w, kernels):
        return _getz_math(w, aux, S3, lam, h2, True, w.dtype)
    T = _check_vecs(w)
    _check_small(aux, (8, T), w.device)
    y = torch.empty_like(w)
    _lib().call(_entry("cup3d_getz_two", w.dtype), w.data_ptr(),
                S1.data_ptr(), lam.data_ptr(), aux.data_ptr(), y.data_ptr(),
                float(h2), T, cuda_lib.stream(w.device))
    _count("getz_two", w.dtype, y)
    return y


def getz_tile(w, h2, kernels=None):
    """B3: tile-only getZ, y = tilesolve(-h2 w), one h2 for every tile."""
    S3, lam, S1 = tilesolve.basis(BS, _F32, str(w.device))
    if not _use_kernel(w, kernels):
        return _getz_math(w, None, S3, lam, h2, False, w.dtype)
    T = _check_vecs(w)
    y = torch.empty_like(w)
    _lib().call(_entry("cup3d_getz_tile", w.dtype), w.data_ptr(),
                S1.data_ptr(), lam.data_ptr(), None, float(h2), y.data_ptr(),
                T, cuda_lib.stream(w.device))
    _count("getz_tile", w.dtype, y)
    return y


class LapGeom:
    """What B4 needs of a uniform grid, built once per grid: its tiles a
    side ``nb`` (the tile index is (tx NBy + ty) NBz + tz), a periodic
    bit an axis (``periodic``: 1 x, 2 y, 4 z; a clear bit is the
    zero-gradient clamp of wall and freespace) and, for the plain version
    alone, the neighbour face planes (krylov.make_tile_planes, built at
    its first use: the kernel path builds no table)."""

    def __init__(self, grid, bs: int = BS):
        if bs != BS:
            raise ValueError(f"B4 is built for {BS}^3 tiles")
        self.grid = grid
        self.nb = tuple(int(s) // bs for s in grid.shape)
        self.tiles = self.nb[0] * self.nb[1] * self.nb[2]
        self.periodic = sum(1 << ax for ax in range(3)
                            if grid.bc[ax] == BC.periodic)
        self._planes = None

    def planes(self, w: torch.Tensor) -> torch.Tensor:
        """(T, 6, 8, 8) face planes of ``w`` (the plain version's input)."""
        if self._planes is None:
            self._planes = krylov.make_tile_planes(self.grid, BS)
        return self._planes(w)


def lap(w, a, inv_h2, geom: LapGeom, kernels=None):
    """B4: (Aw, per-tile a . Aw, per-tile Aw . Aw) on the grid of ``geom``;
    w, a and Aw in one storage dtype.  ``a`` None: (Aw, None, None), the
    kernel skipping the partials (the warm start's residual).  The kernel
    reads the cross-tile neighbours from w; the plain version builds the
    face planes and applies laplacian_faces."""
    if not _use_kernel(w, kernels):
        return _lap_math(w, geom.planes(w), a, inv_h2, w.dtype)
    T = _check_vecs(w) if a is None else _check_vecs(w, a)
    if T != geom.tiles:
        raise ValueError(f"lap: {T} tiles, the grid has {geom.nb}")
    aw = torch.empty_like(w)
    pa = ps = None
    if a is not None:
        pa = torch.empty(T, dtype=_F32, device=w.device)
        ps = torch.empty(T, dtype=_F32, device=w.device)
    _lib().call(_entry("cup3d_lap", w.dtype), w.data_ptr(),
                None if a is None else a.data_ptr(), aw.data_ptr(),
                None if pa is None else pa.data_ptr(),
                None if ps is None else ps.data_ptr(), float(inv_h2),
                *geom.nb, geom.periodic, cuda_lib.stream(w.device))
    if a is None:
        residual_launches["lap"] += 1
        if runtime.NAN_CHECKS[0]:
            runtime.check_kernel_outputs("B4 (cup3d_lap)", aw)
    else:
        _count("lap", w.dtype, aw, pa, ps)
    return aw, pa, ps


def axpy(r, v, scal, kernels=None):
    """B5: (s = r - alpha v, per-tile sum s); scal = (alpha, ...)."""
    if not _use_kernel(r, kernels):
        return _axpy_math(r, v, scal[0], r.dtype)
    T = _check_vecs(r, v)
    _check_small(scal, (8,), r.device)
    s = torch.empty_like(r)
    ts = torch.empty(T, dtype=_F32, device=r.device)
    _lib().call(_entry("cup3d_axpy", r.dtype), r.data_ptr(), v.data_ptr(),
                scal.data_ptr(), None, s.data_ptr(), ts.data_ptr(), T, T,
                cuda_lib.stream(r.device))
    _count("axpy", r.dtype, s, ts)
    return s, ts


def finish(x, y, z, s, t, rhat, scal, kernels=None):
    """B6: (x + alpha y + omega z, r = s - omega t, per-tile r . r,
    per-tile rhat . r); scal = (alpha, omega, ...); x f32, the rest in
    their storage dtype.  The kernel updates x in place and writes r into
    the buffer of s (both returned)."""
    if not _use_kernel(x, kernels):
        return _finish_math(x, y, z, s, t, rhat, scal[0], scal[1], s.dtype)
    T = _check_vecs(y, z, s, t, rhat)
    if _check_vecs(x, dtype=_F32) != T or x.device != s.device:
        raise ValueError("finish: x must match the other vectors' tiles")
    _check_small(scal, (8,), x.device)
    prr = torch.empty(T, dtype=_F32, device=x.device)
    prh = torch.empty(T, dtype=_F32, device=x.device)
    _lib().call(_entry("cup3d_finish", s.dtype), x.data_ptr(), y.data_ptr(),
                z.data_ptr(), s.data_ptr(), t.data_ptr(), rhat.data_ptr(),
                scal.data_ptr(), s.data_ptr(), prr.data_ptr(), prh.data_ptr(),
                T, T, cuda_lib.stream(x.device))
    _count("finish", s.dtype, x, s, prr, prh)
    return x, s, prr, prh


def _scalars(*vals: torch.Tensor) -> torch.Tensor:
    """Pack 0-dim device scalars into the 8-float row the stages read."""
    row = torch.stack([v.to(_F32) for v in vals])
    return torch.cat([row, row.new_zeros(8 - len(vals))])


def _combine(part: torch.Tensor) -> torch.Tensor:
    """Per-tile partials -> global scalar (f32)."""
    return torch.sum(part, dtype=_F32)


# ---------------------------------------------------------------------------
# the fused solver driver
# ---------------------------------------------------------------------------


def fused_bicgstab_tiles(grid, b, *, tol_abs=1e-6, tol_rel=1e-4,
                         maxiter=1000, rnorm_ref=None, x0=None,
                         two_level=True, store_dtype=None, kernels=None):
    """:func:`fused_bicgstab` on tile-major ``(T, 8, 8, 8)`` f32 ``b``/``x0``;
    returns ``(x_best (T,8,8,8) f32, rnorm_best, iterations)`` (0-dim
    device tensors for the last two).  Tail iterations of the last chunk
    after convergence may compute inf/NaN in the work vectors; they never
    touch x_best, rnorm_best or the iteration count."""
    from cup3d_tpu_torch.ops import precision

    store = precision.krylov_dtype() if store_dtype is None else store_dtype
    bs = BS
    h2 = float(grid.h * grid.h)
    inv_h2 = 1.0 / h2
    dev = b.device
    geom = LapGeom(grid, bs)
    coarse_core = krylov._make_coarse_core(grid, bs) if two_level else None
    deltas_fn = krylov.make_face_deltas(grid, bs) if two_level else None
    T = b.shape[0]

    def coarse_aux(tsum):
        zc = coarse_core(tsum)
        return torch.cat([deltas_fn(zc), zc[None, :],
                          zc.new_zeros(1, T)], dim=0)

    def getz(w, tsum):
        if two_level:
            return getz_two(w, coarse_aux(tsum), h2, kernels)
        return getz_tile(w, h2, kernels)

    b32 = b.to(_F32).contiguous()
    x = (torch.zeros_like(b32) if x0 is None
         else x0.to(_F32).contiguous().clone())
    if x0 is None:
        r0 = b32  # A(0) == 0 exactly; skip the apply
    else:
        r0 = b32 - lap(x, None, inv_h2, geom, kernels)[0]
    # the norm and rho come from the f32 residual, the iteration starts
    # from its stored copy (rhat is its own buffer: B1 re-seeds in place)
    rr0 = krylov._dot(r0, r0)
    rnorm0 = torch.sqrt(rr0)
    ref = rnorm0 if rnorm_ref is None else rnorm_ref
    target = torch.clamp(tol_rel * ref, min=tol_abs)
    eps = torch.full((), 1e-30, dtype=_F32, device=dev)
    one = torch.ones((), dtype=_F32, device=dev)
    r = r0.to(store, copy=True)

    state = dict(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        x=x, r=r, rhat=r.clone(), p=torch.zeros_like(r),
        v=torch.zeros_like(r), rho=one, alpha=one, omega=one,
        rnorm=rnorm0, rho_dot=rr0, x_best=x.clone(), rnorm_best=rnorm0,
    )

    def step(s, active):
        rn2 = s["rnorm"] * s["rnorm"]
        broke = torch.abs(s["rho_dot"]) < eps * torch.clamp(rn2, min=1.0)
        rho_new = torch.where(broke, rn2, s["rho_dot"])
        beta = (rho_new / krylov._safe(s["rho"])) * (
            s["alpha"] / krylov._safe(s["omega"]))
        beta = torch.where(broke, 0.0, beta)

        p, rhat, ts_p = update(s["r"], s["p"], s["v"], s["rhat"],
                               _scalars(beta, s["omega"], broke), kernels)
        y = getz(p, ts_p)
        v, d_rhv, _ = lap(y, rhat, inv_h2, geom, kernels)
        alpha = rho_new / krylov._safe(_combine(d_rhv))

        svec, ts_s = axpy(s["r"], v, _scalars(alpha), kernels)
        z = getz(svec, ts_s)
        t, d_ts, d_tt = lap(z, svec, inv_h2, geom, kernels)
        omega = _combine(d_ts) / krylov._safe(_combine(d_tt))

        x, r, p_rr, p_rhr = finish(s["x"], y, z, svec, t, rhat,
                                   _scalars(alpha, omega), kernels)
        rnorm = torch.sqrt(_combine(p_rr))
        better = active & (rnorm < s["rnorm_best"])
        # the best iterate is updated in place: x_best is its own buffer
        torch.where(better, x, s["x_best"], out=s["x_best"])
        return dict(
            k=s["k"] + active.to(torch.int32), x=x, r=r, rhat=rhat, p=p,
            v=v, rho=rho_new, alpha=alpha, omega=omega,
            rnorm=torch.where(active, rnorm, s["rnorm"]),
            rho_dot=_combine(p_rhr), x_best=s["x_best"],
            rnorm_best=torch.where(
                active, torch.minimum(rnorm, s["rnorm_best"]),
                s["rnorm_best"]),
        )

    out, executed = krylov.iterate(state, step, maxiter, target)
    iterations["executed"] += executed
    return out["x_best"], out["rnorm_best"], out["k"]


def fused_bicgstab(grid, b: torch.Tensor, *, tol_abs: float = 1e-6,
                   tol_rel: float = 1e-4, maxiter: int = 1000,
                   rnorm_ref=None, x0: Optional[torch.Tensor] = None,
                   bs: int = 8, two_level: bool = True, store_dtype=None,
                   kernels: Optional[bool] = None):
    """Fused-iteration preconditioned BiCGSTAB on the lanes layout: the
    production pressure system (A = the grid's 7-point Laplacian, M = the
    exact getZ tile solve, plus the exact Galerkin coarse level when
    ``two_level``).  ``b`` is the mean-removed rhs (bs,bs,bs,T) f32;
    ``store_dtype`` the Krylov vectors' storage (default
    precision.krylov_dtype()); returns ``(x_best (lanes, f32), rnorm_best,
    iterations)``."""
    if bs != BS:
        raise ValueError(f"the fused driver is built for {BS}^3 tiles")
    x0t = None if x0 is None else krylov.lanes_to_tiles(x0)
    xt, rnorm, k = fused_bicgstab_tiles(
        grid, krylov.lanes_to_tiles(b), tol_abs=tol_abs, tol_rel=tol_rel,
        maxiter=maxiter, rnorm_ref=rnorm_ref, x0=x0t, two_level=two_level,
        store_dtype=store_dtype, kernels=kernels)
    return krylov.tiles_to_lanes(xt), rnorm, k


# ---------------------------------------------------------------------------
# analytic traffic model (the JAX package's, ops/fused_bicgstab.py:545-590)
# ---------------------------------------------------------------------------


def bytes_model(store_dtype=None, two_level: bool = True) -> dict:
    """Analytic device bytes per cell per fused iteration (reads + writes),
    by stage.  e = storage bytes a cell (4 f32, 2 bf16); x stays 4 B.
    Partials and aux are O(T) and ignored.  The JAX package's model has a
    "planes" entry (the face planes its driver gathers before each lap,
    0.75 e a pass written and read again): the port's B4 reads its
    neighbour faces from w inside the kernel, so it has no planes glue
    and its lap moves w and the partner in and Aw out, 3 e a pass."""
    from cup3d_tpu_torch.ops import precision

    store = precision.krylov_dtype() if store_dtype is None else store_dtype
    e = torch.empty((), dtype=store).element_size()
    per = {
        # r, p, v, rhat in; p, rhat out
        "update": 6 * e,
        # 2x (w in, y out)
        "getz": 2 * (2 * e),
        # 2x (w + partner in, Aw out)
        "lap": 2 * 3 * e,
        # r, v in; s out
        "axpy": 3 * e,
        # y, z, s, t, rhat in + x f32 in; x f32 + r out
        "finish": 5 * e + 4 + 4 + e,
        # best-x select: x_new, x_best in, x_best out (f32)
        "best_x": 12,
    }
    per["total"] = round(sum(per.values()), 2)
    return per


def legacy_bytes_model() -> float:
    """The unfused composition's bytes a cell an iteration under the same
    counting rules: 2 Laplacians (r+w each), 2 getZ (r+w), ~10 vector
    ops (2 passes), 4 dots (1 read), all f32."""
    return 2 * 8.0 + 2 * 8.0 + 10 * 8.0 + 4 * 4.0
