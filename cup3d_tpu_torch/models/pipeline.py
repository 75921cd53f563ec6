"""Obstacle operators in the timestep pipeline (port of
``cup3d_tpu/models/pipeline.py``; reference order, main.cpp:15229-15246):
CreateObstacles -> ... -> UpdateObstacles -> Penalization ->
PressureProjection -> ComputeForces.

Single obstacle: the rigid update, the penalization force and the surface
forces stay on the device and join the step's QoI pack
(``pending_parts``: "rigid", "penal", "forces"); pipelined stepping
chains the device rigid state from step to step (models/base.py).  An
obstacle whose update has a host-only branch (roll correction) takes the
host path, which reads its moments and forces at once.  More than one
body takes the host path every step, and the collision pass
(models/collisions.py) runs before the penalization.
"""

from __future__ import annotations

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import sanctioned_transfer, upload
from cup3d_tpu_torch.models.base import (
    log_forces,
    momentum_integrals,
    pack_forces,
    pack_moments,
    rigid_update_device,
    store_force_qoi,
    unpack_forces,
    unpack_moments,
    update_penalization_forces,
)
from cup3d_tpu_torch.ops.penalization import (
    penalize,
    per_obstacle_penalization_force,
)
from cup3d_tpu_torch.sim.operators import Operator

_EPS = 1e-6


def _host_dt(s, dt) -> float:
    """The host value of this step's dt: the operators get the uploaded
    0-dim tensor during a step (its host twin is ``s.dt``) and a Python
    float when called on their own (a restore's ``CreateObstacles(0.0)``)."""
    return float(dt) if isinstance(dt, (int, float)) else float(s.dt)


def _device_step(s) -> bool:
    """True when this step's rigid update ran on the device (single
    obstacle): its QoI join the step's read."""
    return (
        len(s.obstacles) == 1
        and s.obstacles[0]._dev_rigid is not None
        and s.obstacles[0]._dev_rigid["step"] == s.step
    )


class CreateObstacles(Operator):
    """Shape kinematics -> SDF -> chi/udef, then the combined obstacle
    fields (reference CreateObstacles, main.cpp:13589-13621)."""

    def __call__(self, dt):
        s = self.sim
        self._update_uinf()
        dt_host = _host_dt(s, dt)
        for ob in s.obstacles:
            ob.update_shape(s.time, dt_host)
            ob.create(s.time)
        chis = torch.stack([ob.chi for ob in s.obstacles])
        s.state["chi"] = torch.amax(chis, dim=0)
        num = sum(ob.chi[..., None] * ob.udef for ob in s.obstacles)
        den = torch.clamp_min(torch.sum(chis, dim=0), _EPS)[..., None]
        s.state["udef"] = num / den

    def _update_uinf(self):
        """Frame-fixed swimming: uinf counteracts the tracked obstacle's
        translational velocity (ObstacleVector::updateUinf,
        main.cpp:8507-8519), from the host mirrors; while the pipelined
        chain runs, the device value comes from the chain (the host
        mirror trails it and feeds only logs)."""
        s = self.sim
        fixed = [ob for ob in s.obstacles if ob.bFixFrameOfRef]
        if not fixed:
            return
        s.uinf = -np.mean([ob.transVel for ob in fixed], axis=0)
        devs = [ob._dev_rigid for ob in fixed]
        if s.cfg.pipelined and all(d is not None for d in devs):
            s._uinf_dev = -sum(d["trans"] for d in devs) / len(devs)
            s._uinf_src = s.uinf


class UpdateObstacles(Operator):
    """chi-weighted fluid momenta -> 6x6 solve -> rigid-body update
    (reference UpdateObstacles, main.cpp:13812-13837), on the device for
    a single obstacle with no host-only branch."""

    def _moments(self, vel, cms):
        s = self.sim
        return torch.stack([
            pack_moments(momentum_integrals(s.grid, ob.chi, vel, cms[i],
                                            xc=s.xc))
            for i, ob in enumerate(s.obstacles)])

    def __call__(self, dt):
        s = self.sim
        devs = [ob._dev_rigid for ob in s.obstacles]
        if all(d is not None for d in devs):
            # pipelined chain: the fresh centre of mass is on the device
            cms = torch.stack([d["cm"] for d in devs])
        else:
            cms = upload(np.stack([ob.centerOfMass for ob in s.obstacles]),
                         s.dtype, s.device)
        M = self._moments(s.state["vel"], cms)
        if len(s.obstacles) == 1 and s.obstacles[0].supports_device_update():
            ob = s.obstacles[0]
            out = rigid_update_device(
                M[0], ob.rigid_state_dev(s.dtype), ob.forced_mask_dev(),
                ob.block_mask_dev(), s.uinf_device(), dt)
            ob._dev_rigid = {"step": s.step, "trans": out[0:3],
                             "ang": out[3:6], "cm": out[12:15], "pack": out}
            ob._ubody_cache = None
            s.pending_parts.append(("rigid", out))
            return
        # host path: one read of every obstacle's moments
        with sanctioned_transfer("body-read"):
            M = M.detach().cpu().numpy().astype(np.float64)
        dt_host = _host_dt(s, dt)
        for ob, row in zip(s.obstacles, M):
            ob.compute_velocities(unpack_moments(row))
            ob.update(dt_host)


class Penalization(Operator):
    """Collision handling, then Brinkman forcing toward the combined body
    velocity field (reference Penalization, main.cpp:14326-14341:
    preventCollidingObstacles runs first, main.cpp:14330)."""

    def __init__(self, sim):
        super().__init__(sim)
        self._h3 = sim.grid.h ** 3
        #: steps whose collision pass fired
        self.collisions = 0

    def _penal_force(self, vn, vo, chis, dt, cms):
        return per_obstacle_penalization_force(vn, vo, chis, dt, self._h3,
                                               self.sim.xc, cms)

    def __call__(self, dt):
        s = self.sim
        if not s.obstacles:
            return
        ubs = [ob.body_velocity_field() for ob in s.obstacles]
        if len(s.obstacles) > 1:
            from functools import partial

            from cup3d_tpu_torch.models.collisions import (
                prevent_colliding_obstacles)
            from cup3d_tpu_torch.ops.chi import grad_chi

            if prevent_colliding_obstacles(
                    s.obstacles, ubs, partial(grad_chi, s.grid), s.xc,
                    _host_dt(s, dt)):
                # the collision overrode rigid velocities: rebuild
                self.collisions += 1
                ubs = [ob.body_velocity_field() for ob in s.obstacles]
        chis = torch.stack([ob.chi for ob in s.obstacles])
        num = sum(ob.chi[..., None] * ub for ob, ub in zip(s.obstacles, ubs))
        den = torch.clamp_min(torch.sum(chis, dim=0), _EPS)[..., None]
        ubody = num / den
        vel_old = s.state["vel"]
        s.state["vel"] = penalize(vel_old, s.state["chi"], ubody,
                                  s.lambda_device(dt), dt)
        PF = update_penalization_forces(s.obstacles, self._penal_force,
                                        s.state["vel"], vel_old, dt, s.dtype)
        if _device_step(s):
            s.pending_parts.append(("penal", PF.reshape(-1)))


class ComputeForces(Operator):
    """Per-obstacle force/torque/power QoI from the surface-point probe
    (ops/surface.py), logged to forces_<i>.txt (reference ComputeForces,
    main.cpp:12496-12503, reduction 13079-13115)."""

    def __call__(self, dt):
        from cup3d_tpu_torch.ops.surface import force_integrals_probe_uniform

        s = self.sim

        def probe(ob, cm, ut, om):
            return pack_forces(force_integrals_probe_uniform(
                s.grid, ob, s.state["vel"], s.state["p"], ob.chi, ob.sdf,
                ob.udef, s.nu, cm, ut, om))

        if _device_step(s):
            ob = s.obstacles[0]
            d = ob._dev_rigid
            F = probe(ob, d["cm"], d["trans"], d["ang"])
            s.pending_parts.append(("forces", F.reshape(-1)))
            return
        # host path: the mirrors are fresh (no device chain)
        kin = upload(np.stack([np.stack([ob.centerOfMass, ob.transVel,
                                         ob.angVel]) for ob in s.obstacles]),
                     s.dtype, s.device)
        F = torch.stack([probe(ob, kin[i, 0], kin[i, 1], kin[i, 2])
                         for i, ob in enumerate(s.obstacles)])
        with sanctioned_transfer("body-read"):
            F = F.detach().cpu().numpy().astype(np.float64)
        for i, (ob, row) in enumerate(zip(s.obstacles, F)):
            store_force_qoi(ob, unpack_forces(row))
            log_forces(s.logger, i, s.time, ob)
