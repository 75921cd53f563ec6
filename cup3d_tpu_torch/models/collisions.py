"""Obstacle-obstacle collision handling (port of
``cup3d_tpu/models/collisions.py``; reference ``preventCollidingObstacles``
+ ``ElasticCollision``, main.cpp:13939-14325).

Per obstacle pair the reference scans cells where both bodies' SDFs are
positive, accumulating the overlap-cell count, the overlap centroid,
each body's mean (normalized) SDF-gradient direction and a
representative body-point velocity (the max-|u| overlap point); if the
bodies approach along the contact normal it applies an e=1 rigid-body
impulse (with inertia coupling) and latches the resulting velocities for
one step (``collision_counter``, main.cpp:13069-13077).

The overlap scan is one masked reduction per pair over the dense
per-obstacle chi fields on the device (chi > 1/2 is the SDF > 0
interior), the contact direction comes from grad(chi), and the 3x3
impulse algebra runs on the host in float64, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import sanctioned_transfer

_TOL_CELLS = 0.001  # minimum overlap count (reference `tolerance`)


def overlap_count(chi_i: torch.Tensor, chi_j: torch.Tensor) -> torch.Tensor:
    """Cheap pre-check: number of cells inside both bodies."""
    return torch.sum((chi_i > 0.5) & (chi_j > 0.5))


def _sq3(v: torch.Tensor) -> torch.Tensor:
    return v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]


def pair_overlap_summary(chi_i, chi_j, gchi_i, gchi_j, ub_i, ub_j,
                         xc) -> Dict[str, torch.Tensor]:
    """Masked overlap reductions for one obstacle pair.

    chi_*: (...,) characteristic functions; gchi_*: (..., 3) chi
    gradients; ub_*: (..., 3) body-point velocity fields (rigid +
    deformation); xc: (..., 3) cell centres.  The reference accumulates i
    and j over the SAME overlap cells (main.cpp:14030-14140), so the
    count and centroid are shared."""
    mask = (chi_i > 0.5) & (chi_j > 0.5)
    mf = mask.reshape(-1).to(chi_i.dtype)
    xf = xc.reshape(-1, 3)
    m = torch.sum(mf)
    pos = torch.sum(mf[:, None] * xf, dim=0)

    def dirsum(g):
        gf = g.reshape(-1, 3)
        n = torch.sqrt(_sq3(gf))[:, None] + 1e-21
        return torch.sum(mf[:, None] * (gf / n), dim=0)

    def rep_vel(ub):
        uf = ub.reshape(-1, 3)
        return uf[torch.argmax(_sq3(uf) * mf)]

    return {"m": m, "pos": pos, "ivec": dirsum(gchi_i),
            "jvec": dirsum(gchi_j), "imom": rep_vel(ub_i),
            "jmom": rep_vel(ub_j)}


def _inertia_response(J: np.ndarray, rc: np.ndarray, n: np.ndarray):
    """I^{-1} (rc x n): the angular velocity change per unit impulse
    (reference ComputeJ, main.cpp:13939-13966)."""
    Jm = np.asarray(J, np.float64)
    Jm = Jm + 1e-21 * np.trace(Jm) * np.eye(3) + 1e-30 * np.eye(3)
    return np.linalg.solve(Jm, np.cross(rc, n))


def elastic_collision(m1, m2, J1, J2, v1, v2, o1, o2, c1, c2, n, c, vc1,
                      vc2):
    """e=1 impulse between two rigid bodies (reference ElasticCollision,
    main.cpp:13968-14027).  n: contact normal (i -> j); c: contact point;
    vc1/vc2: representative contact-point velocities.  Returns
    (v1', v2', o1', o2')."""
    e = 1.0
    jr1 = _inertia_response(J1, c - c1, n)
    jr2 = _inertia_response(J2, c - c2, n)
    nom = (1.0 + e) * np.dot(vc1 - vc2, n)
    denom = -(1.0 / m1 + 1.0 / m2) - (
        np.dot(np.cross(jr1, c - c1), n) + np.dot(np.cross(jr2, c - c2), n))
    impulse = nom / (denom + 1e-21)
    return (v1 + (n / m1) * impulse, v2 - (n / m2) * impulse,
            o1 + jr1 * impulse, o2 - jr2 * impulse)


def _host(v) -> np.ndarray:
    """A device value read on the host: the collision pass's one read a
    pair in contact."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v, np.float64)
    with sanctioned_transfer("body-read"):
        return np.asarray(v.detach().cpu().numpy(), np.float64)


def prevent_colliding_obstacles(obstacles: List, ubody_fields: List,
                                gradchi_fn, xc, dt: float,
                                precheck_counts=None) -> bool:
    """Detect overlapping obstacle pairs and resolve them with an elastic
    impulse; latch the collision velocities for one step.  Returns whether
    any collision fired (reference sim.bCollision).

    gradchi_fn: chi -> (..., 3) gradient.  precheck_counts: optional
    {(i, j): float} overlap counts read by the caller; without it each
    pair reads its own ``overlap_count`` (a host read a pair a step)."""
    n_obs = len(obstacles)
    if n_obs < 2:
        return False
    grads: Dict[int, torch.Tensor] = {}

    def grad(k):
        if k not in grads:
            grads[k] = gradchi_fn(obstacles[k].chi)
        return grads[k]

    hit = False
    for i in range(n_obs):
        for j in range(i + 1, n_obs):
            oi, oj = obstacles[i], obstacles[j]
            cnt = (precheck_counts[(i, j)] if precheck_counts is not None
                   else float(_host(overlap_count(oi.chi, oj.chi))))
            if cnt < _TOL_CELLS:
                continue
            s = pair_overlap_summary(oi.chi, oj.chi, grad(i), grad(j),
                                     ubody_fields[i], ubody_fields[j], xc)
            # one read of the pair's summary
            flat = _host(torch.cat([s[k].reshape(-1) for k in
                                    ("m", "pos", "ivec", "jvec", "imom",
                                     "jmom")]))
            m = float(flat[0])
            if m < _TOL_CELLS:
                continue
            pos, ivec, jvec = flat[1:4], flat[4:7], flat[7:10]
            imom, jmom = flat[10:13], flat[13:16]
            ni = np.linalg.norm(ivec)
            nj = np.linalg.norm(jvec)
            if ni < 1e-21 or nj < 1e-21:
                continue
            # contact normal: grad chi points INTO each body, so n points
            # from body j to body i
            mvec = ivec / ni - jvec / nj
            mn = np.linalg.norm(mvec)
            if mn < 1e-21:
                continue
            n = mvec / mn
            # approach test (main.cpp:14262-14266)
            if np.dot(jmom - imom, n) <= 0:
                continue
            hit = True
            c = pos / m
            m1 = oi.mass if oi.mass > 0 else 1.0
            m2 = oj.mass if oj.mass > 0 else 1.0
            # forced bodies are effectively immovable (main.cpp:14293-14298)
            if np.any(oi.bForcedInSimFrame):
                m1 *= 1e10
            if np.any(oj.bForcedInSimFrame):
                m2 *= 1e10
            v1, v2, o1, o2 = elastic_collision(
                m1, m2, oi.J, oj.J, oi.transVel, oj.transVel, oi.angVel,
                oj.angVel, oi.centerOfMass, oj.centerOfMass, n, c, imom,
                jmom)
            for ob, v, o in ((oi, v1, o1), (oj, v2, o2)):
                ob.transVel = np.asarray(v)
                ob.angVel = np.asarray(o)
                ob.collision_vel = np.asarray(v)
                ob.collision_angvel = np.asarray(o)
                ob.collision_counter = 0.01 * dt
    return hit
