"""Fused-iteration BiCGSTAB on the AMR block forest (port of
``cup3d_tpu/ops/fused_amr_bicgstab.py``).

The production pressure system of the forest: A = the refluxed 7-point
Laplacian (face tables of width 1 + flux tables), M = the exact getZ tile
solve at each block's own h, plus the block-graph coarse level.  Each
iteration runs five stages over ``(nb, 8, 8, 8)`` blocks — the same
block-major layout and storage dtypes (f32 or bf16 Krylov vectors, f32 x)
as the uniform driver's tiles — and on a CUDA tensor
each is a hand-written kernel (csrc/fused_bicgstab.cu); beside it sits a
plain PyTorch version (a port of the JAX package's ``*_math`` helpers):

- ``update``   (B8)  p/rhat recurrence + breakdown select + per-block
                     sum p * vol (the coarse restriction of p)
- ``getz_two`` (B9)  exact DST tile solve at the block's own h^2 on
                     -h^2 (w - A zf), plus the coarse injection zc
- ``getz_tile`` (B10) the same tile solve without the coarse level
                     (``graph=None``: ``CUP3D_COARSE=0`` and the recovery
                     ladder's tile-only rung)
- ``lap``      (B11) 7-point stencil on the width-1 lab x per-block 1/h^2
                     + the dense reflux increment + the dot partials
- ``axpy``     (B12) s = r - alpha v + per-block sum s * vol
- ``finish``   (B13) x/r updates + the residual/rho dot partials

B8 and B12 are the uniform B1 and B5 kernels with a per-block weight,
B10 the uniform B3 kernel with a per-block h^2; B13 is the uniform B6
kernel itself.  Their launches count under their
own ``amr_*`` names so the two paths are held apart.

Between the stages, in plain torch (the JAX package keeps the same
pieces outside its kernels): the coarse solve
(krylov.coarse_solve_graph, 32 fixed CG sweeps on (nb,) vectors), the
full refluxed Laplacian of the injected correction ``azf``, and the lab
assembly with its reflux increment; these stay f32 under bf16 storage
(the lab is assembled from the stored direction cast to f32, as the JAX
driver's ``lab_corr``).  Partials are per block, combined by one
``torch.sum``: no float atomics, so reruns are bitwise equal.

The forest runs unpadded: exactly ``nb`` blocks, real per-block volumes.
Dispatch follows ops/fused_bicgstab.py (``kernels`` None/False/True).
"""

from __future__ import annotations

from typing import Optional

import torch

from cup3d_tpu_torch.analysis import runtime
from cup3d_tpu_torch.ops import fused_bicgstab as fb
from cup3d_tpu_torch.ops import cuda_lib, krylov, tilesolve

_F32 = torch.float32
BS = 8
LAB = BS + 2  # width-1 lab edge

#: kernel launches per stage, counted by the wrappers where they launch
launches = {"amr_update": 0, "amr_getz_two": 0, "amr_getz_tile": 0,
            "amr_lap": 0, "amr_axpy": 0, "amr_finish": 0}
#: the bf16 kernels' launches, by the same names
launches_bf16 = dict.fromkeys(launches, 0)
#: iterations the fused driver executed, chunk tails included: each runs
#: update/axpy/finish once and getz (two-level or tile-only) and lap twice
iterations = {"executed": 0}


def reset_launches() -> None:
    for counts in (launches, launches_bf16):
        for name in counts:
            counts[name] = 0
    iterations["executed"] = 0


#: the kernel table's names of the stages
KERNEL_IDS = {"amr_update": "B8", "amr_getz_two": "B9",
              "amr_getz_tile": "B10", "amr_lap": "B11", "amr_axpy": "B12",
              "amr_finish": "B13"}


def _count(stage: str, dtype, *outs) -> None:
    """One launch of ``stage``'s kernel; under
    ``analysis.runtime.debug_nans`` its outputs ``outs`` are checked."""
    (launches_bf16 if dtype == torch.bfloat16 else launches)[stage] += 1
    if runtime.NAN_CHECKS[0]:
        runtime.check_kernel_outputs(
            f"{KERNEL_IDS[stage]} ({stage})", *outs)


# ---------------------------------------------------------------------------
# plain versions (ports of the JAX *_math helpers), block-major
# ---------------------------------------------------------------------------


def _col(c: torch.Tensor) -> torch.Tensor:
    """(n,) per-block column -> (n, 1, 1, 1)."""
    return c.reshape(-1, 1, 1, 1)


def _lanes(scal: torch.Tensor, n: int) -> int:
    """Blocks a lane for ``n`` blocks and a scalar block ``scal``: (8,)
    is one lane (n), (L, 8) one row a lane, n / L blocks each."""
    if scal.dim() == 1:
        return n
    L = scal.shape[0]
    if L < 1 or n % L:
        raise ValueError(f"{n} blocks do not split into {L} lanes")
    return n // L


def _row_col(scal: torch.Tensor, j: int, bpl: int) -> torch.Tensor:
    """Entry j of the scalar rows for the plain versions: the 0-dim
    scalar of one row, or a per-block (n, 1, 1, 1) column of the (L, 8)
    rows (each block its lane's value: the same elementwise arithmetic as
    the scalar broadcast)."""
    if scal.dim() == 1:
        return scal[j]
    return _col(scal[:, j].repeat_interleave(bpl))


def _update_math(r, p, v, rhat, vol, beta, omega, broke, store=_F32):
    p_st, rh_st, _ = fb._update_math(r, p, v, rhat, beta, omega, broke,
                                     store)
    return p_st, rh_st, fb._cellsum(p_st.to(_F32) * _col(vol))


def _getz_math(w, azf, zc, S3, lam, h2, two_level, store=_F32):
    """y = zc + tilesolve(-h2 (w - azf)) (two-level) or
    y = tilesolve(-h2 w) (tile-only), h2 per block; two (512, 512) f32
    matmuls; azf and zc f32, y rounded to ``store``."""
    w32 = w.to(_F32)
    if two_level:
        b = -_col(h2) * (w32 - azf)
    else:
        b = -_col(h2) * w32
    n = b.shape[0]
    if b.is_cuda:
        from cup3d_tpu_torch.ops import precision

        precision.check_fp32_matmul()
    t = b.reshape(n, -1) @ S3
    t = t / lam
    y = (t @ S3).reshape(b.shape)
    if two_level:
        y = y + _col(zc)
    return y.to(store)


def _lap_math(lab, corr, a, inv_h2, store=_F32):
    """Refluxed 7-point Laplacian on f32 width-1 labs (n, 10, 10, 10) +
    the f32 reflux increment, Aw rounded to ``store``, + the per-block
    partials of a . Aw and Aw . Aw over the stored Aw."""
    lab = lab.to(_F32)
    c = lab[:, 1:BS + 1, 1:BS + 1, 1:BS + 1]
    s = -6.0 * c
    s = s + lab[:, 2:BS + 2, 1:BS + 1, 1:BS + 1]
    s = s + lab[:, 0:BS, 1:BS + 1, 1:BS + 1]
    s = s + lab[:, 1:BS + 1, 2:BS + 2, 1:BS + 1]
    s = s + lab[:, 1:BS + 1, 0:BS, 1:BS + 1]
    s = s + lab[:, 1:BS + 1, 1:BS + 1, 2:BS + 2]
    s = s + lab[:, 1:BS + 1, 1:BS + 1, 0:BS]
    aw = (s * _col(inv_h2) + corr).to(store)
    aw32 = aw.to(_F32)
    a32 = a.to(_F32)
    return aw, fb._cellsum(a32 * aw32), fb._cellsum(aw32 * aw32)


def _axpy_math(r, v, vol, alpha, store=_F32):
    s, _ = fb._axpy_math(r, v, alpha, store)
    return s, fb._cellsum(s.to(_F32) * _col(vol))


# ---------------------------------------------------------------------------
# stage wrappers: CUDA kernel for a CUDA tensor, plain version otherwise
# ---------------------------------------------------------------------------


def _check_cols(n: int, dev, *cols: torch.Tensor) -> None:
    for c in cols:
        fb._check_small(c, (n,), dev)


def update(r, p, v, rhat, vol, scal, kernels=None):
    """B8: (p_new, rhat_new, per-block sum p_new * vol); vol (nb,) f32,
    the vectors in their storage dtype; scal the (8,) row, or (L, 8) for
    L lanes of nb / L contiguous blocks each (every lane its own row).
    The kernel updates p and rhat in place (returned)."""
    bpl = _lanes(scal, r.shape[0])
    if not fb._use_kernel(r, kernels):
        return _update_math(r, p, v, rhat, vol, _row_col(scal, 0, bpl),
                            _row_col(scal, 1, bpl), _row_col(scal, 2, bpl),
                            p.dtype)
    n = fb._check_vecs(r, p, v, rhat)
    fb._check_small(scal, tuple(scal.shape[:-1]) + (8,), r.device)
    _check_cols(n, r.device, vol)
    if len({r.data_ptr(), p.data_ptr(), v.data_ptr(), rhat.data_ptr()}) < 4:
        raise ValueError("update: r, p, v and rhat must not share memory")
    ts = torch.empty(n, dtype=_F32, device=r.device)
    fb._lib().call(fb._entry("cup3d_update", r.dtype), r.data_ptr(),
                   p.data_ptr(), v.data_ptr(), rhat.data_ptr(),
                   scal.data_ptr(), vol.data_ptr(), ts.data_ptr(), n, bpl,
                   cuda_lib.stream(r.device))
    _count("amr_update", r.dtype, p, rhat, ts)
    return p, rhat, ts


def getz_two(w, azf, zc, h2, kernels=None):
    """B9: y = zc + tilesolve(-h2 (w - azf)) per block, in w's storage
    dtype; azf (nb,8,8,8), zc and h2 (nb,) f32."""
    S3, lam, S1 = tilesolve.basis(BS, _F32, str(w.device))
    if not fb._use_kernel(w, kernels):
        return _getz_math(w, azf, zc, S3, lam, h2, True, w.dtype)
    n = fb._check_vecs(w)
    if fb._check_vecs(azf, dtype=_F32) != n or azf.device != w.device:
        raise ValueError("getz_two: azf must match w's blocks")
    _check_cols(n, w.device, zc, h2)
    y = torch.empty_like(w)
    fb._lib().call(fb._entry("cup3d_getz_amr", w.dtype), w.data_ptr(),
                   azf.data_ptr(), S1.data_ptr(), lam.data_ptr(),
                   zc.data_ptr(), h2.data_ptr(), y.data_ptr(), n,
                   cuda_lib.stream(w.device))
    _count("amr_getz_two", w.dtype, y)
    return y


def getz_tile(w, h2, kernels=None):
    """B10: tile-only getZ at per-block h^2, y = tilesolve(-h2 w); h2
    (nb,).  The B3 kernel with the h^2 column."""
    S3, lam, S1 = tilesolve.basis(BS, _F32, str(w.device))
    if not fb._use_kernel(w, kernels):
        return _getz_math(w, None, None, S3, lam, h2, False, w.dtype)
    n = fb._check_vecs(w)
    _check_cols(n, w.device, h2)
    y = torch.empty_like(w)
    fb._lib().call(fb._entry("cup3d_getz_tile", w.dtype), w.data_ptr(),
                   S1.data_ptr(), lam.data_ptr(), h2.data_ptr(), 0.0,
                   y.data_ptr(), n, cuda_lib.stream(w.device))
    _count("amr_getz_tile", w.dtype, y)
    return y


def lap(lab, corr, a, inv_h2, kernels=None):
    """B11: (Aw, per-block a . Aw, per-block Aw . Aw); lab (nb,10,10,10)
    and corr (nb,8,8,8) f32, a and Aw in the storage dtype, inv_h2 (nb,)."""
    if not fb._use_kernel(lab, kernels):
        return _lap_math(lab, corr, a, inv_h2, a.dtype)
    n = fb._check_vecs(a)
    if fb._check_vecs(corr, dtype=_F32) != n or corr.device != a.device:
        raise ValueError("lap: corr must match a's blocks")
    fb._check_small(lab, (n, LAB, LAB, LAB), a.device, aligned=True)
    _check_cols(n, a.device, inv_h2)
    aw = torch.empty_like(a)
    pa = torch.empty(n, dtype=_F32, device=a.device)
    ps = torch.empty(n, dtype=_F32, device=a.device)
    fb._lib().call(fb._entry("cup3d_lap_amr", a.dtype), lab.data_ptr(),
                   corr.data_ptr(), a.data_ptr(), inv_h2.data_ptr(),
                   aw.data_ptr(), pa.data_ptr(), ps.data_ptr(), n,
                   cuda_lib.stream(a.device))
    _count("amr_lap", a.dtype, aw, pa, ps)
    return aw, pa, ps


def axpy(r, v, vol, scal, kernels=None):
    """B12: (s = r - alpha v, per-block sum s * vol); scal = (alpha, ...),
    or (L, 8) rows for L lanes as in :func:`update`."""
    bpl = _lanes(scal, r.shape[0])
    if not fb._use_kernel(r, kernels):
        return _axpy_math(r, v, vol, _row_col(scal, 0, bpl), r.dtype)
    n = fb._check_vecs(r, v)
    fb._check_small(scal, tuple(scal.shape[:-1]) + (8,), r.device)
    _check_cols(n, r.device, vol)
    s = torch.empty_like(r)
    ts = torch.empty(n, dtype=_F32, device=r.device)
    fb._lib().call(fb._entry("cup3d_axpy", r.dtype), r.data_ptr(),
                   v.data_ptr(), scal.data_ptr(), vol.data_ptr(),
                   s.data_ptr(), ts.data_ptr(), n, bpl,
                   cuda_lib.stream(r.device))
    _count("amr_axpy", r.dtype, s, ts)
    return s, ts


def finish(x, y, z, s, t, rhat, scal, kernels=None):
    """B13: the B6 function on blocks (served by the B6 kernel): x +=
    alpha y + omega z (x f32), r = s - omega t into the buffer of s,
    per-block r . r and rhat . r; scal (8,) or (L, 8) as in
    :func:`update`."""
    bpl = _lanes(scal, s.shape[0])
    if not fb._use_kernel(x, kernels):
        return fb._finish_math(x, y, z, s, t, rhat, _row_col(scal, 0, bpl),
                               _row_col(scal, 1, bpl), s.dtype)
    n = fb._check_vecs(y, z, s, t, rhat)
    if fb._check_vecs(x, dtype=_F32) != n or x.device != s.device:
        raise ValueError("finish: x must match the other vectors' blocks")
    fb._check_small(scal, tuple(scal.shape[:-1]) + (8,), x.device)
    prr = torch.empty(n, dtype=_F32, device=x.device)
    prh = torch.empty(n, dtype=_F32, device=x.device)
    fb._lib().call(fb._entry("cup3d_finish", s.dtype), x.data_ptr(),
                   y.data_ptr(), z.data_ptr(), s.data_ptr(), t.data_ptr(),
                   rhat.data_ptr(), scal.data_ptr(), s.data_ptr(),
                   prr.data_ptr(), prh.data_ptr(), n, bpl,
                   cuda_lib.stream(x.device))
    _count("amr_finish", s.dtype, x, s, prr, prh)
    return x, s, prr, prh


# ---------------------------------------------------------------------------
# the fused solver driver
# ---------------------------------------------------------------------------


class _Lanes:
    """The per-lane reductions and selects of the lane-batched driver: L
    lanes of ``nb`` blocks each stacked along the block axis (lane l's
    blocks contiguous), every Krylov scalar an (L,) tensor.  With
    ``L = None`` each is the one-system version the driver always used
    (so one system's bits are unchanged)."""

    def __init__(self, L: Optional[int]):
        self.L = L

    def dot(self, a, b):
        if self.L is None:
            return krylov._dot(a, b)
        from cup3d_tpu_torch.ops import precision

        return torch.sum((a * b).reshape(self.L, -1), dim=1,
                         dtype=precision.accum_dtype(a.dtype))

    def combine(self, part):
        """Per-block partials -> one scalar a lane, each lane's blocks
        summed in block order (no float atomics)."""
        if self.L is None:
            return fb._combine(part)
        return torch.sum(part.reshape(self.L, -1), dim=1, dtype=_F32)

    def rows(self, *vals):
        """The scalar row(s) the stages read: (8,), or (L, 8)."""
        if self.L is None:
            return fb._scalars(*vals)
        row = torch.stack([v.to(_F32) for v in vals], dim=1)
        return torch.cat([row, row.new_zeros(self.L, 8 - len(vals))],
                         dim=1).contiguous()

    def select_into(self, mask, new, dst):
        """dst = where(mask, new, dst) in place, mask one value a lane."""
        if self.L is None:
            torch.where(mask, new, dst, out=dst)
            return
        dv = dst.view(self.L, -1)
        torch.where(mask[:, None], new.reshape(self.L, -1), dv, out=dv)

    def blocks(self, fn, x):
        """``fn`` of one lane's blocks, applied to every lane (L * nb
        stacked blocks -> L * nb stacked results) in one batched call."""
        if self.L is None:
            return fn(x)
        y = torch.func.vmap(fn)(x.reshape((self.L, -1) + tuple(x.shape[1:])))
        return y.reshape((-1,) + tuple(y.shape[2:]))


def fused_amr_bicgstab(geom, b: torch.Tensor, *, tab, ftab=None,
                       vol: torch.Tensor, graph=None, tol_abs: float = 1e-6,
                       tol_rel: float = 1e-4, maxiter: int = 1000,
                       rnorm_ref=None, x0: Optional[torch.Tensor] = None,
                       store_dtype=None, kernels: Optional[bool] = None,
                       lanes: Optional[int] = None, live=None):
    """Fused-iteration preconditioned BiCGSTAB on the forest ``geom`` (a
    BlockGrid): ``b`` the mean-removed rhs (nb, 8, 8, 8), ``tab`` width-1
    face tables, ``ftab`` flux tables, ``vol`` the (nb,1,1,1) cell volume,
    ``graph`` the krylov.BlockGraph (None: tile-only getZ),
    ``store_dtype`` the Krylov vectors' storage (default
    precision.krylov_dtype()).  Returns ``(x_best (nb,8,8,8) f32,
    rnorm_best, iterations)`` (0-dim device tensors for the last two).
    Tail iterations of the last chunk after convergence never touch
    x_best, rnorm_best or the count.

    ``lanes`` = L solves L independent systems on one topology at once
    (the fleet's lane-batched forest, the JAX package's ``vmap`` of this
    solve): ``b``, ``x0`` and the result are (L * nb, 8, 8, 8), lane l's
    blocks contiguous; ``geom``, ``tab``, ``ftab``, ``vol`` and ``graph``
    are one lane's; ``rnorm_ref`` is (L,) and the returned residual and
    iteration count are (L,).  Each stage launches once for all lanes,
    B8, B12 and B13 reading each lane's own scalar row; the dot partials
    combine per lane; every lane iterates until the last one stops, a
    stopped lane's x_best, residual and count frozen (the JAX
    ``while_loop`` under ``vmap``).  ``live`` ((L,) bool, or None) marks
    the lanes that solve at all: a lane False (the fleet's finished and
    padding lanes, whose step the gate discards) is frozen from the start
    and holds no lane to its iteration count (krylov.iterate)."""
    from cup3d_tpu_torch.ops import amr_ops, precision

    store = precision.krylov_dtype() if store_dtype is None else store_dtype
    ln = _Lanes(lanes)
    nl = 1 if lanes is None else int(lanes)

    bs, nb = int(geom.bs), int(geom.nb)
    if bs != BS:
        raise ValueError(f"the fused forest driver is built for {BS}^3 blocks")
    if tab.width != 1:
        raise ValueError("fused AMR Laplacian needs width-1 lab tables")
    if b.shape[0] != nl * nb:
        raise ValueError(f"rhs of {b.shape[0]} blocks for {nl} lane(s) of "
                         f"{nb} blocks")
    dev = b.device
    h_col = geom.h_column(_F32, dev)
    inv_h = 1.0 / h_col
    h2 = (h_col * h_col).reshape(nb).repeat(nl).contiguous()
    inv_h2 = (inv_h * inv_h).reshape(nb).repeat(nl).contiguous()
    vol_c = vol.to(_F32).reshape(nb).repeat(nl).contiguous()
    two_level = graph is not None
    zeros = torch.zeros((nb, bs, bs, bs), dtype=_F32, device=dev)
    zeros_all = (zeros if lanes is None else
                 torch.zeros((nl * nb, bs, bs, bs), dtype=_F32, device=dev))

    def coarse(tsum):
        zc = krylov.coarse_solve_graph(tsum, graph).to(_F32)
        zf = zc[:, None, None, None].expand(nb, bs, bs, bs)
        azf = amr_ops.laplacian_blocks(geom, zf, tab, ftab)
        return zc, azf

    def getz(w, tsum):
        if not two_level:
            return getz_tile(w, h2, kernels)
        # the coarse solve of coarse_correct_blocks, its restriction taken
        # from the update/axpy partials; then the full refluxed A zf
        if lanes is None:
            zc, azf = coarse(tsum)
        else:
            zc, azf = torch.func.vmap(coarse)(tsum.reshape(nl, nb))
            zc = zc.reshape(nl * nb)
            azf = azf.reshape((nl * nb,) + tuple(azf.shape[2:]))
        return getz_two(w, azf.contiguous(), zc.contiguous(), h2, kernels)

    def lab_corr_one(w32):
        lab = tab.assemble_scalar(w32, bs)
        if ftab is not None and ftab.ncorr:
            fl = amr_ops.face_fluxes(lab, 1, bs, inv_h)
            return lab, ftab.apply(zeros, fl)
        return lab, zeros

    def lab_corr(w):
        """The width-1 halo lab of a direction and the dense coarse-fine
        reflux increment: the two data-dependent pieces of A, assembled
        in f32 from the stored direction."""
        w32 = w.to(_F32)
        if lanes is None:
            lab, corr = lab_corr_one(w32)
            return lab.contiguous(), corr.contiguous()
        if not (ftab is not None and ftab.ncorr):
            return ln.blocks(lambda u: tab.assemble_scalar(u, bs),
                             w32).contiguous(), zeros_all
        lab, corr = torch.func.vmap(lab_corr_one)(
            w32.reshape(nl, nb, bs, bs, bs))
        return (lab.reshape((nl * nb,) + tuple(lab.shape[2:])).contiguous(),
                corr.reshape(nl * nb, bs, bs, bs).contiguous())

    b32 = b.to(_F32).contiguous()
    x = (torch.zeros_like(b32) if x0 is None
         else x0.to(_F32).contiguous().clone())
    if x0 is None:
        r0 = b32  # A(0) == 0 exactly; skip the apply
    else:
        r0 = b32 - ln.blocks(
            lambda u: amr_ops.laplacian_blocks(geom, u, tab, ftab), x)
    # the norm and rho from the f32 residual, the iteration from its
    # stored copy (rhat its own buffer: B8 re-seeds it in place)
    rr0 = ln.dot(r0, r0)
    rnorm0 = torch.sqrt(rr0)
    ref = rnorm0 if rnorm_ref is None else rnorm_ref
    target = torch.clamp(tol_rel * ref, min=tol_abs)
    eps = torch.full((), 1e-30, dtype=_F32, device=dev)
    one = torch.ones(() if lanes is None else (nl,), dtype=_F32, device=dev)
    r = r0.to(store, memory_format=torch.contiguous_format, copy=True)

    state = dict(
        k=torch.zeros(() if lanes is None else (nl,), dtype=torch.int32,
                      device=dev),
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

        p, rhat, ts_p = update(s["r"], s["p"], s["v"], s["rhat"], vol_c,
                               ln.rows(beta, s["omega"], broke), kernels)
        y = getz(p, ts_p)
        lab_y, corr_y = lab_corr(y)
        v, d_rhv, _ = lap(lab_y, corr_y, rhat, inv_h2, kernels)
        alpha = rho_new / krylov._safe(ln.combine(d_rhv))

        svec, ts_s = axpy(s["r"], v, vol_c, ln.rows(alpha), kernels)
        z = getz(svec, ts_s)
        lab_z, corr_z = lab_corr(z)
        t, d_ts, d_tt = lap(lab_z, corr_z, svec, inv_h2, kernels)
        omega = ln.combine(d_ts) / krylov._safe(ln.combine(d_tt))

        x, r, p_rr, p_rhr = finish(s["x"], y, z, svec, t, rhat,
                                   ln.rows(alpha, omega), kernels)
        rnorm = torch.sqrt(ln.combine(p_rr))
        better = active & (rnorm < s["rnorm_best"])
        # the best iterate is updated in place: x_best is its own buffer
        ln.select_into(better, x, s["x_best"])
        return dict(
            k=s["k"] + active.to(torch.int32), x=x, r=r, rhat=rhat, p=p,
            v=v, rho=rho_new, alpha=alpha, omega=omega,
            rnorm=torch.where(active, rnorm, s["rnorm"]),
            rho_dot=ln.combine(p_rhr), x_best=s["x_best"],
            rnorm_best=torch.where(
                active, torch.minimum(rnorm, s["rnorm_best"]),
                s["rnorm_best"]),
        )

    out, executed = krylov.iterate(state, step, maxiter, target, live)
    iterations["executed"] += executed
    return out["x_best"], out["rnorm_best"], out["k"]


# ---------------------------------------------------------------------------
# analytic traffic model (the JAX package's,
# ops/fused_amr_bicgstab.py:593-630)
# ---------------------------------------------------------------------------


def bytes_model(store_dtype=None, two_level: bool = True) -> dict:
    """Analytic device bytes per cell per fused forest iteration (reads +
    writes), by stage.  e = storage bytes a cell; labs cost (bs+2)^3/bs^3
    ~ 1.95 f32 reads a cell an apply and the dense reflux increment one
    more; per-block columns and partials are O(nb) and ignored."""
    from cup3d_tpu_torch.ops import precision

    store = precision.krylov_dtype() if store_dtype is None else store_dtype
    e = torch.empty((), dtype=store).element_size()
    lab = float((8 + 2) ** 3) / 8 ** 3  # width-1 halo amplification
    per = {
        # r, p, v, rhat in; p, rhat out
        "update": 6 * e,
        # 2x (w + azf in, y out)
        "getz": 2 * (e + 4 + e),
        # 2x (lab assemble: read w, write lab; corr: read lab, write)
        "assemble": 2 * ((e + lab * 4) + (lab * 4 + 4)),
        # 2x (lab + corr + partner in, Aw out)
        "lap": 2 * ((lab * 4 + 4 + e) + e),
        # coarse zf Laplacian between stages: lab round trip again
        "coarse_azf": 2 * (4 + lab * 4 + 4) if two_level else 0.0,
        # r, v in; s out
        "axpy": 3 * e,
        # y, z, s, t, rhat in + x f32 in; x f32 + r out
        "finish": 5 * e + 4 + 4 + e,
        # best-x select: x_new, x_best in, x_best out (f32)
        "best_x": 12,
    }
    per["total"] = round(sum(per.values()), 2)
    return per


def legacy_bytes_model(two_level: bool = True) -> float:
    """The unfused forest composition under the same counting rules: 2
    refluxed Laplacians (lab assemble + stencil + corr), 2 getZ tile
    solves, the two-level r2 Laplacians, ~10 vector ops, 4 dots, all
    f32."""
    lab = float((8 + 2) ** 3) / 8 ** 3
    lap = (4 + lab * 4 + 4) + (lab * 4 + 4 + 4)  # assemble + apply
    n_lap = 4 if two_level else 2
    return n_lap * lap + 2 * 8.0 + 10 * 8.0 + 4 * 4.0
