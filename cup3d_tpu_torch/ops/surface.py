"""Surface-point force probing on the uniform grid (port of the uniform
part of ``cup3d_tpu/ops/surface.py``; the reference's
KernelComputeForces, main.cpp:12250-12494, and its surface extraction,
main.cpp:13291-13404).

On a dense window around the body:

- surface measure delta = (grad H . grad phi)/|grad phi|^2 per cell
  (Towers), surface cells where delta > 0; outward normal
  n = -grad phi/|grad phi| (phi > 0 inside);
- the band is compacted to K static slots, the top K by dS
  (``torch.topk``, never ``nonzero``: no device read), and the slots
  sorted by flat index so every sum runs in the same order run to run;
- probe point: the first cell along round(k n), k = 0..4, with
  chi < 0.01 (the reference's march);
- velocity gradient at the probe point by one-sided 6-point 5th-order
  differences (3-point, 2-point where the window runs out), Taylor-
  corrected back to the surface cell with second and mixed derivatives;
- tractions f = -P n dS + (nu/h) (grad u . n dS) and the reference's
  reductions (force/torque, thrust/drag, Pout, defPower, pLocom).

On the forest the window is gathered from the finest-level blocks
around the body (``force_integrals_probe_blocks``); its cells that no
finest-level block owns are invalid, and the stencils that would reach
them fall back to shorter ones, as the reference's lab-range cascade.

``per_point=True`` adds the per-surface-point record (the reference's
ObstacleBlock arrays, main.cpp:12300-12330) as K-slot tensors;
``compact_surface_points`` compacts it to an (n_pts, 20) host array and
``dump_surface_points`` writes one body's to an .npy file.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_EPS = 1e-21
_C6 = (-137.0 / 60.0, 5.0, -5.0, 10.0 / 3.0, -5.0 / 4.0, 1.0 / 5.0)


def _shift(f, o):
    """Zero-padded static shift along one of the first three axes:
    out[i] = f[i + o[a]]."""
    for a, k in enumerate(o):
        if k == 0:
            continue
        n = f.shape[a]
        z = torch.zeros_like(f.narrow(a, 0, abs(k)))
        if k > 0:
            f = torch.cat([f.narrow(a, k, n - k), z], dim=a)
        else:
            f = torch.cat([z, f.narrow(a, 0, n + k)], dim=a)
    return f


def _central(f, axis):
    """Undivided centred difference along axis (zero-padded edges)."""
    o = [0, 0, 0]
    o[axis] = 1
    hi = _shift(f, o)
    o[axis] = -1
    lo = _shift(f, o)
    return 0.5 * (hi - lo)


def surface_force_window(vel, p, chi, sdf, udef, valid, xc, h, nu: float,
                         cm, u_trans, omega, per_point: bool = False,
                         max_points=None) -> Dict[str, torch.Tensor]:
    """The reference's KernelComputeForces on a dense uniform window.
    vel/udef (Wx,Wy,Wz,3), p/chi/sdf (Wx,Wy,Wz), ``valid`` (Wx,Wy,Wz)
    bool: the cell holds field data (all true on the uniform grid; false
    in a forest window's cells that no finest-level block owns), xc
    (Wx,Wy,Wz,3) cell centres, h the spacing, cm/u_trans/omega (3,).
    ``max_points`` (static) compacts the band to that many slots.
    Returns the force/torque/power dict ``pack_forces`` packs, with the
    surface-cell count n_surf and, with ``per_point``, the record of
    each slot in ``points`` (``surf``: the slot holds a surface point;
    ``x`` its cell centre, ``n_dS`` outward normal times dS, ``dS``,
    ``p`` the pressure, ``fP``/``fV`` the pressure and viscous tractions
    times dS, ``v`` the fluid and ``vdef`` the deformation velocity),
    slots in window flat-index order."""
    shape = tuple(vel.shape[:3])
    dtype, dev = vel.dtype, vel.device

    # -- surface measure + outward normal ---------------------------------
    gphi = torch.stack([_central(sdf, a) for a in range(3)], -1)
    gH = torch.stack([_central(chi, a) for a in range(3)], -1)
    gphi2 = torch.sum(gphi * gphi, -1) + _EPS
    dS_w = torch.sum(gH * gphi, -1) / gphi2 * (h * h * h)
    nhat_w = -gphi / torch.sqrt(gphi2)[..., None]
    surf_w = (dS_w > 1e-12) & valid

    # -- compact the band to K static slots (top K by dS, then in flat
    # index order) -------------------------------------------------------
    ncells = int(np.prod(shape))
    K = ncells if max_points is None else min(int(max_points), ncells)
    surf_flat = surf_w.reshape(-1)
    n_surf = torch.sum(surf_flat.to(torch.int32))
    dS_flat = torch.where(surf_flat, dS_w.reshape(-1),
                          torch.zeros((), dtype=dtype, device=dev))
    _, itop = torch.topk(dS_flat, K, sorted=False)
    iflat0 = torch.sort(itop).values
    top_dS = dS_flat[iflat0]
    pt_ok = top_dS > 0

    def take_s(fw):
        return fw.reshape(-1)[iflat0]

    def take_v(fw):
        return fw.reshape((-1,) + tuple(fw.shape[3:]))[iflat0]

    zero = torch.zeros((), dtype=dtype, device=dev)
    dS = torch.where(pt_ok, take_s(dS_w), zero)
    nhat = take_v(nhat_w)
    xc = take_v(xc)
    P = take_s(p)
    v_base = take_v(vel)
    u_base = take_v(udef)
    s1, s2 = shape[1] * shape[2], shape[2]
    base = (iflat0 // s1, (iflat0 // s2) % shape[1], iflat0 % s2)
    chif = chi.reshape(-1)
    velf = vel.reshape(-1, 3)
    validf = valid.reshape(-1)
    hi = [n - 1 for n in shape]

    def flat(ix, iy, iz):
        return ((torch.clamp(ix, 0, hi[0]) * shape[1]
                 + torch.clamp(iy, 0, hi[1])) * shape[2]
                + torch.clamp(iz, 0, hi[2]))

    def inwin(ix, iy, iz):
        geo = ((ix >= 0) & (ix < shape[0]) & (iy >= 0) & (iy < shape[1])
               & (iz >= 0) & (iz < shape[2]))
        return geo & validf[flat(ix, iy, iz)]

    def nbhd_ok(ix, iy, iz):
        """The candidate cell and its +-1 neighbourhood are in the window
        and hold data (the reference's lab-range check for the centred
        stencils)."""
        ok = inwin(ix, iy, iz)
        for a in range(3):
            o = [ix, iy, iz]
            for sg in (-1, 1):
                o[a] = (ix, iy, iz)[a] + sg
                ok = ok & inwin(*o)
        return ok

    # -- probe point: march outward to the first chi < 0.01 cell ----------
    px, py, pz = base
    found = torch.zeros_like(pt_ok)
    for k in range(5):
        c = [base[a] + torch.round(k * nhat[:, a]).to(torch.long)
             for a in range(3)]
        ok = nbhd_ok(*c) & ~found
        px = torch.where(ok, c[0], px)
        py = torch.where(ok, c[1], py)
        pz = torch.where(ok, c[2], pz)
        found = found | (ok & (chif[flat(*c)] < 0.01))

    one_l = torch.ones((), dtype=torch.long, device=dev)
    sx, sy, sz = (torch.where(nhat[:, a] > 0, one_l, -one_l)
                  for a in range(3))

    def vat(ix, iy, iz):
        return velf[flat(ix, iy, iz)]

    def one_sided(axis, s):
        """Undivided one-sided first derivative at the probe point:
        6-pt 5th order -> 3-pt 2nd order -> 2-pt 1st order by range."""
        def at(k):
            o = [px, py, pz]
            o[axis] = o[axis] + k * s
            return o
        v = [vat(*at(k)) for k in range(6)]
        sf = s.to(dtype)[:, None]
        d6 = sf * sum(cf * vk for cf, vk in zip(_C6, v))
        d3 = sf * (-1.5 * v[0] + 2.0 * v[1] - 0.5 * v[2])
        d2 = sf * (v[1] - v[0])
        oks = [inwin(*at(k)) for k in range(6)]
        ok5 = (oks[1] & oks[2] & oks[3] & oks[4] & oks[5])[:, None]
        ok2 = (oks[1] & oks[2])[:, None]
        d2 = torch.where(oks[1][:, None], d2, zero)
        return torch.where(ok5, d6, torch.where(ok2, d3, d2))

    dvdx = one_sided(0, sx)
    dvdy = one_sided(1, sy)
    dvdz = one_sided(2, sz)

    probe_ok = nbhd_ok(px, py, pz)

    def second(axis):
        o = [px, py, pz]
        o2 = [px, py, pz]
        o[axis] = o[axis] + 1
        o2[axis] = o2[axis] - 1
        d2 = vat(*o) - 2.0 * vat(px, py, pz) + vat(*o2)
        return torch.where(probe_ok[:, None], d2, zero)

    d2x, d2y, d2z = second(0), second(1), second(2)

    def mixed(a1, s1_, a2, s2_):
        """Nested one-sided mixed derivative, falling back to the compact
        2x2 form out of range (the mathematically consistent sign, as
        the JAX package; the reference signs one term only,
        main.cpp:12399-12401)."""
        def at(k1, k2):
            o = [px, py, pz]
            o[a1] = o[a1] + k1 * s1_
            o[a2] = o[a2] + k2 * s2_
            return o

        def row(k1):
            return (-1.5 * vat(*at(k1, 0)) + 2.0 * vat(*at(k1, 1))
                    - 0.5 * vat(*at(k1, 2)))

        ss = (s1_ * s2_).to(dtype)[:, None]
        full = ss * (-0.5 * row(2) + 2.0 * row(1) - 1.5 * row(0))
        compact = ss * ((vat(*at(1, 1)) - vat(*at(1, 0)))
                        - (vat(*at(0, 1)) - vat(*at(0, 0))))
        ok = torch.ones_like(pt_ok)
        for k1 in range(3):
            for k2 in range(3):
                ok = ok & inwin(*at(k1, k2))
        okc = (inwin(*at(0, 0)) & inwin(*at(0, 1)) & inwin(*at(1, 0))
               & inwin(*at(1, 1)))
        compact = torch.where(okc[:, None], compact, zero)
        return torch.where(ok[:, None], full, compact)

    dxy = mixed(0, sx, 1, sy)
    dxz = mixed(0, sx, 2, sz)
    dyz = mixed(1, sy, 2, sz)

    ox = (base[0] - px).to(dtype)[:, None]
    oy = (base[1] - py).to(dtype)[:, None]
    oz = (base[2] - pz).to(dtype)[:, None]
    gx = dvdx + d2x * ox + dxy * oy + dxz * oz
    gy = dvdy + d2y * oy + dyz * oz + dxy * ox
    gz = dvdz + d2z * oz + dxz * ox + dyz * oy

    # -- tractions ---------------------------------------------------------
    n_meas = nhat * dS[:, None]
    inv_h = nu / h
    fV = inv_h * (gx * n_meas[:, 0:1] + gy * n_meas[:, 1:2]
                  + gz * n_meas[:, 2:3])
    fP = -P[:, None] * n_meas
    fT = fV + fP

    vel_norm = torch.linalg.vector_norm(u_trans)
    vel_unit = torch.where(
        vel_norm > 1e-9,
        u_trans / torch.where(vel_norm > 0, vel_norm, torch.ones_like(vel_norm)),
        zero)

    r = xc - cm
    pres_force = torch.sum(fP, dim=0)
    visc_force = torch.sum(fV, dim=0)
    torque = torch.sum(torch.linalg.cross(r, fT), dim=0)
    force_par = torch.sum(fT * vel_unit, -1)
    thrust = torch.sum(0.5 * (force_par + torch.abs(force_par)))
    drag = -torch.sum(0.5 * (force_par - torch.abs(force_par)))
    pow_pt = torch.sum(fT * v_base, -1)
    defp_pt = torch.sum(fT * u_base, -1)
    u_solid = u_trans + torch.linalg.cross(omega.expand_as(r), r)
    out = {
        "pres_force": pres_force,
        "visc_force": visc_force,
        "torque": torque,
        "power": torch.sum(pow_pt),
        "pout_bnd": torch.sum(torch.clamp_max(pow_pt, 0.0)),
        "thrust": thrust,
        "drag": drag,
        "def_power": torch.sum(defp_pt),
        "def_power_bnd": torch.sum(torch.clamp_max(defp_pt, 0.0)),
        "p_locom": torch.sum(fT * u_solid),
        "n_surf": n_surf,
    }
    if per_point:
        out["points"] = {"surf": pt_ok & (dS > 0), "x": xc, "n_dS": n_meas,
                         "dS": dS, "p": P, "fP": fP, "fV": fV, "v": v_base,
                         "vdef": u_base}
    return out


# ---------------------------------------------------------------------------
# window extraction: a dense neighbourhood around one obstacle
# ---------------------------------------------------------------------------


def probe_margin(length: float, h: float) -> float:
    """Half-extent of an obstacle's working box: body half-length plus an
    8h band (the rasterizer's candidate search and the probe windows
    share it)."""
    return 0.625 * length + 8.0 * h


def window_size_cells(length: float, h: float, bs: int = 8) -> int:
    """Static window edge (cells): 2x probe_margin, rounded up to whole
    blocks."""
    half = probe_margin(length, h)
    return int(-(-2.0 * half / h // bs) * bs)


def probe_max_points(length: float, h) -> int:
    """Surface slot budget with no prior measurement: 20 (L/h)^2, rounded
    up to 1024, at least 4096."""
    n = 20.0 * (float(length) / float(h)) ** 2
    return int(max(4096, -(-n // 1024) * 1024))


def obstacle_probe_budget(ob, h) -> int:
    """Per-obstacle slot budget: 4x the measured band (``n_surf_points``,
    refreshed by every step's force read), kept while it stays within
    [2x, 8x] of the measurement."""
    n = float(getattr(ob, "n_surf_points", 0) or 0)
    prev = int(getattr(ob, "_probe_budget", 0) or 0)
    if n > 0 and np.isfinite(n):
        if prev and 2.0 * n <= prev <= 8.0 * n:
            return prev
        b = int(max(4096, -(-4.0 * n // 1024) * 1024))
    elif prev:
        return prev
    else:
        b = probe_max_points(ob.length, h)
    ob._probe_budget = b
    return b


def window_index(idx0: torch.Tensor, shape):
    """Advanced-index tuple of the window of ``shape`` cells whose corner
    is the device tensor ``idx0`` (3,) long: gathers and scatters through
    it need no device read."""
    dev = idx0.device
    r = [idx0[a] + torch.arange(int(shape[a]), device=dev) for a in range(3)]
    return r[0][:, None, None], r[1][None, :, None], r[2][None, None, :]


def _uniform_window_probe(vel, p, chi, sdf, udef, idx0, h, nu, cm, u_trans,
                          omega, wcells: int, per_point: bool = False,
                          max_points=None):
    """``idx0``: the window corner, a device (3,) long tensor (the
    megaloop's, from the device position): the window is gathered
    without a read."""
    dtype, dev = vel.dtype, vel.device
    loc = torch.arange(wcells, dtype=dtype, device=dev) + 0.5
    sl = window_index(idx0, (wcells,) * 3)
    axes = [(idx0[a].to(dtype) + loc) * h for a in range(3)]
    xc = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    valid = torch.ones((wcells,) * 3, dtype=torch.bool, device=dev)
    return surface_force_window(
        vel[sl], p[sl], chi[sl], sdf[sl], udef[sl], valid, xc, h, nu, cm,
        u_trans, omega, per_point=per_point, max_points=max_points)


def force_integrals_probe_uniform(grid, ob, vel, p, chi, sdf, udef, nu, cm,
                                  u_trans, omega, per_point: bool = False,
                                  max_points=None):
    """Uniform-grid entry: a cubic window around the obstacle, its corner
    from the host mirror of the position (no device read)."""
    n = np.asarray(grid.shape)
    w = window_size_cells(ob.length, grid.h)
    w = int(min(w, n.min()))
    half = 0.5 * w * grid.h
    pos = np.asarray(ob.position)
    idx0 = np.clip(np.floor((pos - half) / grid.h).astype(np.int64), 0, n - w)
    if max_points is None:
        max_points = obstacle_probe_budget(ob, grid.h)
    from cup3d_tpu_torch.analysis.runtime import upload

    npd = np.float32 if vel.dtype == torch.float32 else np.float64
    return _uniform_window_probe(
        vel, p, chi, sdf, udef, upload(idx0, torch.long, vel.device),
        float(npd(grid.h)), nu, cm, u_trans, omega, wcells=w,
        per_point=per_point, max_points=max_points)


# ---------------------------------------------------------------------------
# the forest: a window of finest-level blocks around the body
# ---------------------------------------------------------------------------


def block_window_slots(grid, position: np.ndarray, length: float):
    """Host: the finest-level block slots covering the body's box.
    Returns (slots (nbx,nby,nbz) int32, -1 where the finest level holds
    no block there; the window's block origin (3,); the finest h).  The
    window's size depends only on (length, h, domain), never on the
    position."""
    lmax = len(grid._slot_maps) - 1
    h = grid.h0 / (1 << lmax)
    bs = grid.bs
    nbd = np.asarray(grid.tree.blocks_per_dim(lmax))
    half = probe_margin(length, h)
    nwin = np.minimum(int(np.ceil(2.0 * half / (bs * h))) + 1, nbd)
    b0 = np.floor((position - half) / (bs * h)).astype(np.int64)
    b0 = np.clip(b0, 0, nbd - nwin)
    rng = [np.arange(b0[a], b0[a] + nwin[a]) for a in range(3)]
    slots = grid._slot_maps[lmax][np.ix_(*rng)].astype(np.int32)
    return slots, b0, h


def gather_block_window(field: torch.Tensor, slots: torch.Tensor,
                        shape) -> torch.Tensor:
    """(nb, bs, bs, bs[, C]) + (nbx*nby*nbz,) device slots of a window of
    ``shape`` = (nbx, nby, nbz) blocks -> the dense window; rows of slot
    -1 are zeros."""
    nbx, nby, nbz = shape
    bs = field.shape[1]
    trail = tuple(field.shape[4:])
    ok = (slots >= 0).reshape((-1,) + (1,) * (field.ndim - 1))
    flat = torch.where(ok, field[torch.clamp_min(slots, 0)],
                       torch.zeros((), dtype=field.dtype,
                                   device=field.device))
    wi = flat.reshape((nbx, nby, nbz, bs, bs, bs) + trail)
    wi = wi.movedim(3, 1).movedim(4, 3)  # (nbx, bs, nby, bs, nbz, bs, ...)
    return wi.reshape((nbx * bs, nby * bs, nbz * bs) + trail)


def probe_blocks_core(vel, p, ob_chi, ob_sdf, ob_udef, slots, shape, b0, h,
                      nu, cm, u_trans, omega, per_point: bool = False,
                      max_points=None):
    """The forest's probe: the finest-level blocks of ``slots`` (device
    (nbx*nby*nbz,) long, -1 where the finest level holds no block) as a
    dense window of ``shape`` blocks whose origin is ``b0`` (3,) in
    finest-block units, then the surface probe on it, its cells of slot
    -1 invalid."""
    bs = vel.shape[1]
    win = [gather_block_window(f, slots, shape)
           for f in (vel, p, ob_chi, ob_sdf, ob_udef)]
    ok = (slots >= 0).reshape(shape)
    valid = ok.repeat_interleave(bs, 0).repeat_interleave(
        bs, 1).repeat_interleave(bs, 2)
    dtype, dev = vel.dtype, vel.device
    # (b0 bs + i + 1/2) h in the field dtype, as the JAX package's
    axes = [(int(b0[a]) * bs + torch.arange(shape[a] * bs, dtype=dtype,
                                            device=dev) + 0.5) * h
            for a in range(3)]
    xc = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return surface_force_window(*win[:5], valid, xc, h, nu, cm, u_trans,
                                omega, per_point=per_point,
                                max_points=max_points)


def force_integrals_probe_blocks(grid, vel, p, ob_chi, ob_sdf, ob_udef, nu,
                                 position, length, cm, u_trans, omega,
                                 per_point: bool = False, max_points=None):
    """The forest's entry: the window's slots from the host mirror of the
    position (no device read), the probe on the device."""
    from cup3d_tpu_torch.analysis.runtime import upload

    slots, b0, h = block_window_slots(grid, np.asarray(position), length)
    if max_points is None:
        max_points = probe_max_points(length, h)
    npd = np.float32 if vel.dtype == torch.float32 else np.float64
    return probe_blocks_core(
        vel, p, ob_chi, ob_sdf, ob_udef,
        upload(slots.reshape(-1), torch.long, vel.device), slots.shape,
        b0, float(npd(h)), nu, cm, u_trans, omega, per_point=per_point,
        max_points=max_points)


# ---------------------------------------------------------------------------
# per-surface-point export (reference per-point arrays, main.cpp:12300-12330)
# ---------------------------------------------------------------------------

SURFACE_POINT_COLUMNS = (
    "x", "y", "z",              # surface-cell centre
    "nx_dS", "ny_dS", "nz_dS",  # outward normal * dS
    "dS",
    "p",                        # surface-cell pressure
    "fxP", "fyP", "fzP",        # pressure traction * dS
    "fxV", "fyV", "fzV",        # viscous traction * dS
    "vx", "vy", "vz",           # fluid velocity at the surface cell
    "vxDef", "vyDef", "vzDef",  # body deformation velocity
)


def compact_surface_points(pts: Dict[str, torch.Tensor]) -> np.ndarray:
    """A probe's per-point record (``per_point=True``) -> the compact
    (n_pts, 20) float64 host array of its surface points, columns as
    SURFACE_POINT_COLUMNS, rows in the probe's slot order: one device
    read of the dense stack, the compaction on the host."""
    dense = torch.cat(
        [pts["x"], pts["n_dS"], pts["dS"][..., None], pts["p"][..., None],
         pts["fP"], pts["fV"], pts["v"], pts["vdef"]], dim=-1)
    mask = pts["surf"].reshape(-1).cpu().numpy()
    flat = dense.cpu().to(torch.float64).numpy().reshape(-1, dense.shape[-1])
    return flat[mask]


def dump_surface_points(path: str, grid, state_fields, ob, nu) -> int:
    """Write one body's compacted surface-point record (positions,
    measures, tractions, velocities) to ``path`` (.npy, ``np.save``) and
    return its row count.  ``grid``: the forest (a BlockGrid: the probe
    on the finest-level window, slots as its ComputeForces budgets them
    with no measurement) or the uniform grid; ``state_fields`` the
    driver's ``vel`` and ``p``; the body's chi/sdf/udef and host rigid
    state are read from ``ob``."""
    vel, p = state_fields["vel"], state_fields["p"]

    def dev(v):
        return torch.as_tensor(np.asarray(v), dtype=vel.dtype,
                               device=vel.device)

    cm, ut, om = dev(ob.centerOfMass), dev(ob.transVel), dev(ob.angVel)
    if hasattr(grid, "_slot_maps"):  # the forest
        out = force_integrals_probe_blocks(
            grid, vel, p, ob.chi, ob.sdf, ob.udef, nu, ob.position,
            ob.length, cm, ut, om, per_point=True)
    else:
        out = force_integrals_probe_uniform(
            grid, ob, vel, p, ob.chi, ob.sdf, ob.udef, nu, cm, ut, om,
            per_point=True)
    rows = compact_surface_points(out["points"])
    np.save(path, rows)
    return rows.shape[0]
