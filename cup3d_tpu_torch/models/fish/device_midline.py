"""Device-resident fish midline: the tensor twin of the host gait path
(port of ``cup3d_tpu/models/fish/device_midline.py``).

The host pipeline (curvature.py -> frenet.py -> midline.py) evaluates the
midline in numpy every step and uploads the (Nm, 20) pack; inside the
K-step megaloop (sim/megaloop.py) the time is a device value, so the
whole chain has to run on the device as a function of ``(t, dt, qint)``.
This module freezes the *gait parameters* (scheduler states, PID outputs,
wave phase bookkeeping) once per megaloop build and evaluates the
midline as tensor operations at an explicit device.

Freezability: the scheduler states only mutate through RL actions and PID
controllers.  ``device_midline_eligible`` admits exactly the steady-gait
fish (no TperiodPID, no torsion control, no period transition in flight,
no position/depth/roll PID), for which every frozen parameter is constant
over any future window.  Freezing ``time0``/``timeshift`` is safe because
the host's in-window rewrite preserves the wave argument exactly when the
period is constant, so a fallback to the host path resumes seamlessly.

The Frenet-Serret integration is a recurrence over the Nm midline points
(a ``lax.scan`` in the JAX package).  On a CUDA tensor it is one launch
of a hand-written kernel (csrc/frenet.cu: one thread runs the recurrence
in order; ``launches["frenet"]`` counts it); its plain version, the CPU's
and the card's reference, is a Python loop, each step one (8, 8) @ (8, 3)
product of the frame state and the renormalisation of three rows, about
7 launches a point (~30 ms a megaloop step at 128^3 on the card, PERF.md).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from cup3d_tpu_torch.analysis import runtime
from cup3d_tpu_torch.analysis.runtime import upload
from cup3d_tpu_torch.models.base import quat_to_rot_dev, solve3
from cup3d_tpu_torch.models.fish.interpolation import natural_cubic_spline
from cup3d_tpu_torch.ops import cuda_lib
from cup3d_tpu_torch.ops.fused_bicgstab import _check_small, _use_kernel

#: launches of the Frenet kernel, counted by its wrapper where it launches
launches = {"frenet": 0}

# the host renorm / inertia-floor threshold (float64 eps even in f32 runs:
# a do-not-divide-by-zero guard, not a solver tolerance)
_EPS64 = float(np.finfo(np.float64).eps)

# gait spline constants (compute_midline, main.cpp:15475-15479)
_CURV_POINTS = np.array([0.0, 0.15, 0.4, 0.65, 0.9, 1.0])
_CURV_VALUES = np.array([0.82014, 1.46515, 2.57136, 3.75425, 5.09147, 5.70449])
_BEND_POINTS = np.array([-0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0])


def device_midline_eligible(ob) -> bool:
    """True when the fish's gait is frozen-parameter representable: every
    scheduler/PID input that could mutate between steps is inactive."""
    cf = getattr(ob, "myFish", None)
    if cf is None:
        return False
    if cf.TperiodPID or cf.control_torsion:
        return False
    if cf.current_period != cf.next_period:
        return False
    if ob.bCorrectPosition or ob.bCorrectPositionZ or ob.bCorrectRoll:
        return False
    return ob.supports_device_update()


def freeze_gait(ob, t: float, dtype, device=None):
    """Snapshot the gait parameters at host time ``t`` into a dict of
    device tensors and Python scalars for ``midline_state_device``.
    None when the scheduler state is not provably constant over future
    steps (a period transition in flight): the caller stays on the host
    midline path."""
    cf = ob.myFish
    L = float(cf.length)
    if device is None:
        device = ob.sim.device

    # -- period: replicate compute_midline's scheduler interplay on a
    # scratch copy (main.cpp:15467-15474) and demand a constant outcome
    sched = copy.deepcopy(cf.periodScheduler)
    sched.transition_scalar(
        t, cf.transition_start,
        cf.transition_start + cf.transition_duration,
        cf.current_period, cf.next_period,
    )
    if float(np.max(np.abs(sched.dparams_t0))) != 0.0:
        return None
    p0, p1 = float(sched.params_t0[0]), float(sched.params_t1[0])
    if not (p0 == p1 == cf.current_period == cf.next_period):
        return None
    Tp, dTp = sched.get_scalar(t)
    if dTp != 0.0 or Tp <= 0.0:
        return None

    # -- amplitude envelope: the host forces this exact transition every
    # step (main.cpp:15480-15483), so replicating it once captures the
    # scheduler's fixed point
    env = copy.deepcopy(cf.curvatureScheduler)
    curvature_points = _CURV_POINTS * L
    curvature_values = _CURV_VALUES / L
    env.transition_between(0.0, 0.0, cf.Tperiod, np.zeros(6), curvature_values)
    env_p0 = natural_cubic_spline(curvature_points, env.params_t0, cf.rS)
    env_p1 = natural_cubic_spline(curvature_points, env.params_t1, cf.rS)
    env_dp0 = natural_cubic_spline(curvature_points, env.dparams_t0, cf.rS)
    env_t0, env_t1 = float(env.t0), float(env.t1)
    if env_t0 < 0:
        # a never-started scheduler returns params_t0 for all t: a
        # saturated past window, so the gate picks env_p1 == env_p0
        env_p1 = env_p0.copy()
        env_dp0 = np.zeros_like(env_p0)
        env_t0, env_t1 = 0.0, -1.0

    # -- pitching cylinder: gamma/dgamma only move under the depth PID
    # (excluded by eligibility), so R/Rdot freeze (main.cpp:15524-15530)
    if abs(cf.gamma) > 1e-10:
        R = 1.0 / cf.gamma
        Rdot = -cf.dgamma / cf.gamma ** 2
    else:
        R = 1e10 if cf.gamma >= 0 else -1e10
        Rdot = 0.0

    def arr(a):
        return upload(np.asarray(a, np.float64), dtype, device)

    return {
        "rs": arr(cf.rS),
        "width": arr(cf.width),
        "height": arr(cf.height),
        "env_p0": arr(env_p0), "env_p1": arr(env_p1), "env_dp0": arr(env_dp0),
        "env_t0": env_t0, "env_t1": env_t1,
        "rb_p": arr(cf.rlBendingScheduler.params_t0),
        "rb_t0": float(cf.rlBendingScheduler.t0),
        "bend": arr(_BEND_POINTS),
        "Tp": float(Tp),
        "time0": float(cf.time0),
        "timeshift": float(cf.timeshift),
        "phase": float(cf.phaseShift),
        "wavelen": float(cf.waveLength),
        "L": L,
        "af": float(cf.amplitudeFactor),
        "alpha": float(cf.alpha), "dalpha": float(cf.dalpha),
        "beta": float(cf.beta), "dbeta": float(cf.dbeta),
        "R": float(R), "Rdot": float(Rdot),
    }


def _hermite_dev(x0, x1, x, y0, y1, dy0, dy1):
    """Twin of interpolation.cubic_hermite; returns (y, dy/dx)."""
    xr = x - x0
    dx = x1 - x0
    a = (dy0 + dy1) / (dx * dx) - 2.0 * (y1 - y0) / (dx * dx * dx)
    b = (-2.0 * dy0 - dy1) / dx + 3.0 * (y1 - y0) / (dx * dx)
    y = a * xr ** 3 + b * xr ** 2 + dy0 * xr + y0
    dy = 3.0 * a * xr ** 2 + 2.0 * b * xr + dy0
    return y, dy


def _frenet_scan_dev(rs, curv, dcurv, kernels=None):
    """Twin of frenet.frenet_solve with zero torsion (torsion control is
    excluded by eligibility): forward-Euler Frenet-Serret integration
    carrying the frame and its time derivative, renormalising each step.
    rs, curv, dcurv (Nm,), or (L, Nm) for L lanes (the fleet's fish
    lanes: one launch for all of them); returns r, v, nor, vnor, bin,
    vbin (Nm, 3) or (L, Nm, 3).  The CUDA kernel on a CUDA tensor (f32),
    the plain loop on a CPU one or with ``kernels=False``."""
    if not _use_kernel(rs, kernels):
        return _frenet_scan_plain(rs, curv, dcurv)
    n = rs.shape[-1]
    lanes = rs.shape[0] if rs.dim() == 2 else 1
    for t in (rs, curv, dcurv):
        _check_small(t, tuple(rs.shape), rs.device)
    if rs.dim() not in (1, 2):
        raise ValueError("the Frenet kernel takes (Nm,) or (L, Nm) inputs")
    out = torch.empty(tuple(rs.shape) + (6, 3), dtype=rs.dtype,
                      device=rs.device)
    cuda_lib.load().call("cup3d_frenet", rs.data_ptr(), curv.data_ptr(),
                         dcurv.data_ptr(), out.data_ptr(), n, lanes,
                         cuda_lib.stream(rs.device))
    launches["frenet"] += 1
    if runtime.NAN_CHECKS[0]:
        runtime.check_kernel_outputs("cup3d_frenet", out)
    return dict(zip(("r", "v", "nor", "vnor", "bin", "vbin"),
                    out.unbind(-2)))


def _frenet_scan_plain(rs, curv, dcurv):
    """The plain version of the Frenet kernel.

    The state S = [ksi, vksi, r, v, nor, vnor, bin, vbin] (8, 3) moves by
    one linear map a point, M_i (8, 8) built for every point at once from
    (k, dk, ds), then ksi, nor and bin are renormalised; M_i reads the OLD
    ksi, vksi and nor, as the host loop does.  (L, Nm) inputs run the L
    lanes' recurrences side by side, S (L, 8, 3)."""
    dtype, dev = rs.dtype, rs.device
    lead = tuple(rs.shape[:-1])
    n = rs.shape[-1]
    ds = rs[..., 1:] - rs[..., :-1]
    k, dk = curv[..., :-1], dcurv[..., :-1]
    M = torch.eye(8, dtype=dtype, device=dev).repeat(lead + (n - 1, 1, 1))
    # ksi += ds k nor; vksi += ds (dk nor + k vnor); r += ds ksi;
    # v += ds vksi; nor -= ds k ksi; vnor -= ds (dk ksi + k vksi)
    M[..., 0, 4] = ds * k
    M[..., 1, 4] = ds * dk
    M[..., 1, 5] = ds * k
    M[..., 2, 0] = ds
    M[..., 3, 1] = ds
    M[..., 4, 0] = -(ds * k)
    M[..., 5, 0] = -(ds * dk)
    M[..., 5, 1] = -(ds * k)
    renorm = upload(np.array([1, 0, 0, 0, 1, 0, 1, 0], bool), torch.bool,
                    dev)
    one = torch.ones((), dtype=dtype, device=dev)
    S = torch.zeros(lead + (8, 3), dtype=dtype, device=dev)
    S[..., 0, 0] = 1.0  # ksi = e_x
    S[..., 4, 1] = 1.0  # nor = e_y
    S[..., 6, 2] = 1.0  # bin = e_z
    out = [S]
    for i in range(n - 1):
        S = M[..., i, :, :] @ S
        d = torch.sum(S * S, dim=-1)
        sc = torch.where(renorm & (d > _EPS64),
                         torch.rsqrt(torch.clamp_min(d, _EPS64)), one)
        S = S * sc[..., None]
        out.append(S)
    st = torch.stack(out, dim=-3)
    # the first point keeps r = v = 0 and the initial frame
    return {"r": st[..., 2, :], "v": st[..., 3, :], "nor": st[..., 4, :],
            "vnor": st[..., 5, :], "bin": st[..., 6, :],
            "vbin": st[..., 7, :]}


def _pitching_dev(r, v, R, Rdot):
    """Twin of perform_pitching_motion (main.cpp:15521-15571)."""
    x0N, y0N = r[-1, 0], r[-1, 1]
    x0Nd, y0Nd = v[-1, 0], v[-1, 1]
    phi = torch.atan2(y0N, x0N)
    phidot = (y0Nd / x0N - y0N * x0Nd / x0N ** 2) / (1.0 + (y0N / x0N) ** 2)
    M = torch.hypot(x0N, y0N)
    Mdot = (x0N * x0Nd + y0N * y0Nd) / M
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    x0, y0 = r[:, 0], r[:, 1]
    x0d, y0d = v[:, 0], v[:, 1]
    x1 = cphi * x0 - sphi * y0
    y1 = sphi * x0 + cphi * y0
    x1d = cphi * x0d - sphi * y0d + (-sphi * x0 - cphi * y0) * phidot
    y1d = sphi * x0d + cphi * y0d + (cphi * x0 - sphi * y0) * phidot
    theta = (M - x1) / R
    cth, sth = torch.cos(theta), torch.sin(theta)
    thetad = (Mdot - x1d) / R - (M - x1) / R ** 2 * Rdot
    r_new = torch.stack([M - R * sth, y1, R - R * cth], dim=1)
    v_new = torch.stack(
        [Mdot - Rdot * sth - R * cth * thetad, y1d,
         Rdot - Rdot * cth + R * sth * thetad], dim=1)
    return r_new, v_new


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _recompute_normals_dev(rs, r, v, nor, vnor):
    """Twin of recompute_normal_vectors (main.cpp:15572-15667)."""
    hp = (rs[2:] - rs[1:-1])[:, None]
    hm = (rs[1:-1] - rs[:-2])[:, None]
    frac = hp / hm
    am = -frac * frac
    a = frac * frac - 1.0
    denom = 1.0 / (hp * (1.0 + frac))
    t_mid = (am * r[:-2] + a * r[1:-1] + r[2:]) * denom
    dt_mid = (am * v[:-2] + a * v[1:-1] + v[2:]) * denom
    ids0 = 1.0 / (rs[1] - rs[0])
    idsN = 1.0 / (rs[-2] - rs[-1])
    t_vec = torch.cat(
        [((r[1] - r[0]) * ids0)[None], t_mid, ((r[-2] - r[-1]) * idsN)[None]])
    dt_vec = torch.cat(
        [((v[1] - v[0]) * ids0)[None], dt_mid, ((v[-2] - v[-1]) * idsN)[None]])
    dot = torch.sum(nor * t_vec, dim=1, keepdim=True)
    ddot = (torch.sum(vnor * t_vec, dim=1)
            + torch.sum(nor * dt_vec, dim=1))[:, None]
    nor_new = nor - dot * t_vec
    nor_out = nor_new / torch.linalg.vector_norm(nor_new, dim=1, keepdim=True)
    vnor_out = vnor - ddot * t_vec - dot * dt_vec
    bin_new = _cross(t_vec, nor_out)
    bin_out = bin_new / torch.linalg.vector_norm(bin_new, dim=1, keepdim=True)
    vbin_out = _cross(dt_vec, nor_out) + _cross(t_vec, vnor_out)
    return nor_out, vnor_out, bin_out, vbin_out


def _d_ds_dev(rs, vals):
    """Twin of midline._d_ds (one-sided ends, averaged interior)."""
    ds = rs[1:] - rs[:-1]
    if vals.ndim == 2:
        ds = ds[:, None]
    fwd = (vals[1:] - vals[:-1]) / ds
    return torch.cat([fwd[:1], 0.5 * (fwd[1:] + fwd[:-1]), fwd[-1:]], dim=0)


def _section_integrals_dev(rs, r, nor, bin_, width, height):
    """Twin of FishMidlineData._section_integrals."""
    ds = torch.cat([
        (0.5 * (rs[1] - rs[0]))[None],
        0.5 * (rs[2:] - rs[:-2]),
        (0.5 * (rs[-1] - rs[-2]))[None],
    ])
    c = _cross(nor, bin_)
    cR = torch.sum(c * _d_ds_dev(rs, r), dim=1)
    cN = torch.sum(c * _d_ds_dev(rs, nor), dim=1)
    cB = torch.sum(c * _d_ds_dev(rs, bin_), dim=1)
    m00 = width * height
    m11 = 0.25 * width ** 3 * height
    m22 = 0.25 * width * height ** 3
    return ds, cR, cN, cB, m00, m11, m22


def _wsum(w, x):
    """sum_i w_i x_i for (N,) weights and (N, 3) rows, elementwise (no
    GEMM, so no TF32 question on the card)."""
    return torch.sum(w[:, None] * x, dim=0)


def _remove_linear_momentum_dev(si, r, v, nor, vnor, bin_, vbin):
    """Twin of integrate_linear_momentum (main.cpp:10961-11012)."""
    ds, cR, cN, cB, m00, m11, m22 = si
    aux1 = m00 * cR * ds
    aux2 = m11 * cN * ds
    aux3 = m22 * cB * ds
    vol = torch.sum(aux1) * np.pi
    cm = (_wsum(aux1, r) + _wsum(aux2, nor) + _wsum(aux3, bin_)) * np.pi / vol
    lm = (_wsum(aux1, v) + _wsum(aux2, vnor) + _wsum(aux3, vbin)) \
        * np.pi / vol
    return r - cm, v - lm


def _remove_angular_momentum_dev(si, dt, qint, r, v, nor, vnor, bin_, vbin):
    """Twin of integrate_angular_momentum (main.cpp:11013-11219): J w = L
    solve, backwards internal-quaternion step, counter-rotation.  Returns
    (r, v, nor, vnor, bin, vbin, qint_new)."""
    ds, cR, cN, cB, m00, m11, m22 = si

    def moment2(a, an, ab_, b, bn, bb):
        return (cR * (a * b * m00 + an * bn * m11 + ab_ * bb * m22)
                + cN * m11 * (a * bn + b * an)
                + cB * m22 * (a * bb + b * ab_))

    n, b_ = nor, bin_
    X, Y, Z = r[:, 0], r[:, 1], r[:, 2]
    JXY = -torch.sum(ds * moment2(X, n[:, 0], b_[:, 0], Y, n[:, 1], b_[:, 1]))
    JZX = -torch.sum(ds * moment2(Z, n[:, 2], b_[:, 2], X, n[:, 0], b_[:, 0]))
    JYZ = -torch.sum(ds * moment2(Y, n[:, 1], b_[:, 1], Z, n[:, 2], b_[:, 2]))
    XX = ds * moment2(X, n[:, 0], b_[:, 0], X, n[:, 0], b_[:, 0])
    YY = ds * moment2(Y, n[:, 1], b_[:, 1], Y, n[:, 1], b_[:, 1])
    ZZ = ds * moment2(Z, n[:, 2], b_[:, 2], Z, n[:, 2], b_[:, 2])
    JXX = torch.sum(YY + ZZ)
    JYY = torch.sum(ZZ + XX)
    JZZ = torch.sum(YY + XX)  # reference parity (main.cpp:11076)

    xd_y = moment2(v[:, 0], vnor[:, 0], vbin[:, 0], Y, n[:, 1], b_[:, 1])
    x_yd = moment2(X, n[:, 0], b_[:, 0], v[:, 1], vnor[:, 1], vbin[:, 1])
    xd_z = moment2(v[:, 0], vnor[:, 0], vbin[:, 0], Z, n[:, 2], b_[:, 2])
    x_zd = moment2(X, n[:, 0], b_[:, 0], v[:, 2], vnor[:, 2], vbin[:, 2])
    yd_z = moment2(v[:, 1], vnor[:, 1], vbin[:, 1], Z, n[:, 2], b_[:, 2])
    y_zd = moment2(Y, n[:, 1], b_[:, 1], v[:, 2], vnor[:, 2], vbin[:, 2])
    am = torch.stack([
        torch.sum((y_zd - yd_z) * ds),
        torch.sum((xd_z - x_zd) * ds),
        torch.sum((x_yd - xd_y) * ds),
    ]) * np.pi

    J = torch.stack([
        torch.stack([torch.clamp_min(JXX, _EPS64), JXY, JZX]),
        torch.stack([JXY, torch.clamp_min(JYY, _EPS64), JYZ]),
        torch.stack([JZX, JYZ, torch.clamp_min(JZZ, _EPS64)]),
    ]) * np.pi
    w = solve3(J, am)

    q = qint
    dqdt = 0.5 * torch.stack([
        -w[0] * q[1] - w[1] * q[2] - w[2] * q[3],
        +w[0] * q[0] + w[1] * q[3] - w[2] * q[2],
        -w[0] * q[3] + w[1] * q[0] + w[2] * q[1],
        +w[0] * q[2] - w[1] * q[1] + w[2] * q[0],
    ])
    q = q - dt * dqdt  # backwards: counter-rotation
    q = q / torch.linalg.vector_norm(q)
    R = quat_to_rot_dev(q)

    def rot(pos, vel):
        # x R^T, as three elementwise sums (no GEMM)
        pos_r = torch.sum(pos[:, None, :] * R[None, :, :], dim=-1)
        vel_r = torch.sum(vel[:, None, :] * R[None, :, :], dim=-1)
        # -w x r counter-rotation, with the ROTATED positions (host order)
        vel_r = vel_r - _cross(w.expand_as(pos_r), pos_r)
        return pos_r, vel_r

    r, v = rot(r, v)
    nor, vnor = rot(nor, vnor)
    bin_, vbin = rot(bin_, vbin)
    return r, v, nor, vnor, bin_, vbin, q


def _curvature_dev(gait, t):
    """The gait's curvature rK and its time derivative vK (Nm,) at device
    time ``t``: the amplitude envelope, the RL bending riding the wave,
    the traveling wave (compute_midline, main.cpp:15475-15519)."""
    rs = gait["rs"]
    L, Tp = gait["L"], gait["Tp"]

    # amplitude envelope (VectorScheduler.get_fine on frozen fine arrays)
    y, dy = _hermite_dev(gait["env_t0"], gait["env_t1"], t,
                         gait["env_p0"], gait["env_p1"], gait["env_dp0"], 0.0)
    rC = torch.where(t > gait["env_t1"], gait["env_p1"],
                     torch.where(t < gait["env_t0"], gait["env_p0"], y))
    inside = (t >= gait["env_t0"]) & (t <= gait["env_t1"])
    vC = torch.where(inside, dy, torch.zeros_like(dy))

    # RL bending riding the wave (LearnWaveScheduler.get_fine, frozen
    # history): values at wave coordinate c = s/L - (t - t0)/Twave
    bp, pb = gait["bend"], gait["rb_p"]
    c = rs / L - (t - gait["rb_t0"]) / Tp
    below = c < bp[0]
    above = c > bp[-1]
    j = torch.clamp(torch.searchsorted(bp, c.contiguous(), side="left"), 1,
                    bp.shape[0] - 1)
    yb, dyb = _hermite_dev(bp[j - 1], bp[j], c, pb[j - 1], pb[j], 0.0, 0.0)
    rB = torch.where(below, pb[0], torch.where(above, pb[-1], yb))
    vB = torch.where(below | above, torch.zeros_like(dyb), -dyb / Tp)

    # traveling wave (compute_midline, main.cpp:15484-15519)
    darg = 2.0 * np.pi / Tp
    arg0 = (2.0 * np.pi * ((t - gait["time0"]) / Tp + gait["timeshift"])
            + np.pi * gait["phase"])
    arg = arg0 - 2.0 * np.pi * rs / (L * gait["wavelen"])
    curv = torch.sin(arg) + rB + gait["beta"]
    dcurv = torch.cos(arg) * darg + vB + gait["dbeta"]
    af = gait["af"]
    rK = gait["alpha"] * af * rC * curv
    vK = (gait["alpha"] * af * (vC * curv + rC * dcurv)
          + gait["dalpha"] * af * rC * curv)
    return rK, vK


def midline_curvature_device(gait, t):
    """The first part of :func:`midline_state_device`: the gait's
    curvature and its rate (Nm,) at device time ``t``, the Frenet
    integration's input."""
    rs = gait["rs"]
    t = torch.as_tensor(t, dtype=rs.dtype, device=rs.device)
    # no host-style finite check: a NaN reaches the carried umax and the
    # megaloop's consumer raises the recoverable nan-velocity failure
    return _curvature_dev(gait, t)


def midline_from_frenet_device(gait, sol, dt, qint):
    """The rest of :func:`midline_state_device` from the Frenet
    integration ``sol`` (its r, v, nor, vnor): pitching wrap -> normal
    re-orthonormalisation -> deformation-momentum removal.  Returns
    (midline dict, updated qint)."""
    rs = gait["rs"]
    r, v = _pitching_dev(sol["r"], sol["v"], gait["R"], gait["Rdot"])
    nor, vnor, bin_, vbin = _recompute_normals_dev(rs, r, v,
                                                   sol["nor"], sol["vnor"])
    si = _section_integrals_dev(rs, r, nor, bin_, gait["width"],
                                gait["height"])
    r, v = _remove_linear_momentum_dev(si, r, v, nor, vnor, bin_, vbin)
    # the host recomputes the section integrals after the linear shift
    si = _section_integrals_dev(rs, r, nor, bin_, gait["width"],
                                gait["height"])
    dt_eff = torch.clamp_min(
        torch.as_tensor(dt, dtype=rs.dtype, device=rs.device), 1e-12)
    r, v, nor, vnor, bin_, vbin, qint_new = _remove_angular_momentum_dev(
        si, dt_eff, qint, r, v, nor, vnor, bin_, vbin)

    mid = {"r": r, "v": v, "nor": nor, "vnor": vnor, "bin": bin_,
           "vbin": vbin, "width": gait["width"], "height": gait["height"]}
    return mid, qint_new


def midline_state_device(gait, t, dt, qint):
    """The full midline state at device time ``t``: gait wave -> Frenet
    integration -> pitching wrap -> normal re-orthonormalisation ->
    deformation-momentum removal.  ``t``, ``dt`` 0-dim tensors (or
    floats), ``qint`` the carried internal quaternion (4,).  Returns
    (midline dict for rasterize_midline, updated qint)."""
    rK, vK = midline_curvature_device(gait, t)
    sol = _frenet_scan_dev(gait["rs"], rK, vK)
    return midline_from_frenet_device(gait, sol, dt, qint)
