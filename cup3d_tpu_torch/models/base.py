"""Obstacle base: 6-DOF rigid-body state + dense-field rasterization
contract (port of ``cup3d_tpu/models/base.py``; the reference's
``Obstacle``, main.cpp:7482-7583, 12812-13233).

Each obstacle owns dense device fields (chi, udef, sdf) on the whole
grid; penalization, momentum integrals and force reductions are
whole-domain tensor ops.  Host mirrors of the rigid state (position,
quaternion, velocities, centre of mass) are numpy float64, as in the JAX
package; the device works in the solver dtype.

Single-obstacle fast path: ``rigid_update_device`` runs moments -> 6x6
solve (block-diagonal about the centre of mass) -> position/quaternion
update on the device, and its (RIGID_PACK,) result joins the step's QoI
pack (sim/simulation.py ``_emit_step_pack``), whose read refreshes the
host mirrors.  Pipelined stepping chains the device output into the next
step (``rigid_state_dev``, ``pos_rot_device``) while the mirrors trail
(``apply_rigid_pack(..., clear_dev=False)``).  Nothing here reads the
device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import sanctioned_transfer, upload
from cup3d_tpu_torch.grid.uniform import UniformGrid


# -- quaternion helpers (host, float64) --------------------------------------


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w,x,y,z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_integrate(q: np.ndarray, omega: np.ndarray, dt: float) -> np.ndarray:
    """Exact exponential-map quaternion step for constant omega over dt."""
    th = np.linalg.norm(omega) * dt
    if th < 1e-14:
        return q
    axis = omega / np.linalg.norm(omega)
    dq = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * axis])
    q = quat_multiply(dq, q)
    return q / np.linalg.norm(q)


# -- device twins of the rigid-body update (single-sync fast path) -----------

RIGID_STATE = 19  # trans(3) ang(3) pos(3) absPos(3) cm(3) quat(4)
RIGID_PACK = 29   # RIGID_STATE + mass(1) + J(9)


def quat_multiply_dev(a, b):
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_to_rot_dev(q):
    """Device twin of quat_to_rot."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def quat_integrate_dev(q, omega, dt):
    """Device twin of quat_integrate (exact exponential map)."""
    n = torch.linalg.vector_norm(omega)
    th = n * dt
    axis = omega / torch.where(n > 0, n, torch.ones_like(n))
    dq = torch.cat([torch.cos(th / 2).reshape(1), torch.sin(th / 2) * axis])
    qn = quat_multiply_dev(dq, q)
    qn = qn / torch.linalg.vector_norm(qn)
    return torch.where(th < 1e-14, q, qn)


def solve3(A, b):
    """x = A^-1 b for a 3x3 A by the adjugate: a dozen elementwise ops,
    no LAPACK call and so no error check that reads the device."""
    c = [[A[(i + 1) % 3, (j + 1) % 3] * A[(i + 2) % 3, (j + 2) % 3]
          - A[(i + 1) % 3, (j + 2) % 3] * A[(i + 2) % 3, (j + 1) % 3]
          for j in range(3)] for i in range(3)]
    det = A[0, 0] * c[0][0] + A[0, 1] * c[0][1] + A[0, 2] * c[0][2]
    # x_i = sum_j adj_ij b_j with adj = cofactor^T
    return torch.stack([c[0][i] * b[0] + c[1][i] * b[1] + c[2][i] * b[2]
                        for i in range(3)]) / det


def rigid_update_device(mom, state, forced_mask, block_mask, uinf, dt):
    """Moments (19,) + rigid state (RIGID_STATE,) -> updated (RIGID_PACK,).

    Device twin of compute_velocities + update (reference
    computeVelocities, main.cpp:12921-13029, and update,
    main.cpp:13116-13204): u = P/m and omega = J^-1 L about the measured
    centre of mass; forced/blocked components keep their previous values.
    The 3x3 solve is closed-form (:func:`solve3`), so nothing reads the
    device."""
    m = mom[0]
    center, P, L = mom[1:4], mom[4:7], mom[7:10]
    J = mom[10:19].reshape(3, 3)
    has = m > 0
    one = torch.ones_like(m)
    minv = 1.0 / torch.where(has, m, one)
    ut0, om0 = state[0:3], state[3:6]
    cm_meas = torch.where(has, center * minv, state[12:15])
    eye = torch.eye(3, dtype=mom.dtype, device=mom.device)
    Jsafe = torch.where(has, J, eye)
    ut = torch.where(has, P * minv, ut0)
    om = torch.where(has, solve3(Jsafe, L), om0)
    ut = torch.where(forced_mask, ut0, ut)
    om = torch.where(block_mask, om0, om)
    pos = state[6:9] + dt * (ut + uinf)
    absp = state[9:12] + dt * ut
    cm = cm_meas + dt * (ut + uinf)
    q = quat_integrate_dev(state[15:19], om, dt)
    return torch.cat([ut, om, pos, absp, cm, q, m.reshape(1), J.reshape(9)])


def rigid_update_bodies(moms, states, forced, blocked, uinf, dt):
    """:func:`rigid_update_device` for n bodies at once: (n, 19) moments,
    (n, RIGID_STATE) states and (n, 3) bool masks -> (n, RIGID_PACK), one
    body after the other with the same arithmetic (the JAX package vmaps
    the function over the bodies)."""
    return torch.stack([rigid_update_device(moms[i], states[i], forced[i],
                                            blocked[i], uinf, dt)
                        for i in range(moms.shape[0])])


class Obstacle:
    """One immersed body.  Subclasses implement ``rasterize()`` (the
    sphere, the foil) or their own ``create()`` (the StefanFish's, in
    models/fish/stefanfish.py), and ``update_shape()`` where the body
    deforms."""

    def __init__(self, sim, spec: Dict[str, str]):
        self.sim = sim
        self.spec = spec
        g = lambda k, d: float(spec.get(k, d))
        self.length = g("L", 0.1)
        self.position = np.array(
            [g("xpos", 0.5 * sim.grid.extent[0]),
             g("ypos", 0.5 * sim.grid.extent[1]),
             g("zpos", 0.5 * sim.grid.extent[2])]
        )
        self.quaternion = np.array(
            [g("quat0", 1.0), g("quat1", 0.0), g("quat2", 0.0), g("quat3", 0.0)]
        )
        # planar (yaw) spawn angle in degrees about +z (main.cpp:12820-12837)
        ang = np.deg2rad(g("planarAngle", 0.0))
        if ang != 0.0 and np.allclose(self.quaternion, [1.0, 0.0, 0.0, 0.0]):
            self.quaternion = np.array([np.cos(ang / 2), 0.0, 0.0,
                                        np.sin(ang / 2)])
        self.transVel = np.array([g("xvel", 0.0), g("yvel", 0.0),
                                  g("zvel", 0.0)])
        self.angVel = np.zeros(3)
        # forced-motion flags (main.cpp:12838-12870)
        forced = spec.get("bForcedInSimFrame", "0") == "1"
        self.bForcedInSimFrame = np.array([forced] * 3)
        self.bBlockRotation = np.array(
            [spec.get("bBlockRotation", "1" if forced else "0") == "1"] * 3
        )
        self.bFixFrameOfRef = spec.get("bFixFrameOfRef", "0") == "1"
        # absolute position: not advected by the moving frame's uinf
        # (main.cpp:13138-13143)
        self.absPos = self.position.copy()

        # filled by create()/integrals
        self.chi: Optional[torch.Tensor] = None
        self.udef: Optional[torch.Tensor] = None
        self.sdf: Optional[torch.Tensor] = None
        self.mass = 0.0
        self.J = np.zeros((3, 3))
        self.centerOfMass = self.position.copy()
        # force QoI (reference ComputeForces reduction, main.cpp:13079-13115)
        self.force = np.zeros(3)
        self.torque = np.zeros(3)
        self.pres_force = np.zeros(3)
        self.visc_force = np.zeros(3)
        self.pow_out = 0.0
        self.pout_bnd = 0.0
        self.thrust = 0.0
        self.drag = 0.0
        self.def_power = 0.0
        self.def_power_bnd = 0.0
        self.p_locom = 0.0
        self.Pthrust = 0.0
        self.Pdrag = 0.0
        self.EffPDef = 0.0
        self.EffPDefBnd = 0.0
        self.penal_force = np.zeros(3)
        self.penal_torque = np.zeros(3)
        # collision latch (reference collision_counter/u_collision,
        # main.cpp:7546-7552, 13069-13077)
        self.collision_counter = 0.0
        self.collision_vel = np.zeros(3)
        self.collision_angvel = np.zeros(3)
        # this step's device rigid update (UpdateObstacles), consumed by
        # body_velocity_field, Penalization and ComputeForces; cleared
        # when the step's read refreshes the host mirrors
        self._dev_rigid: Optional[dict] = None

    # -- checkpointing -----------------------------------------------------

    def __getstate__(self):
        """Pickle the host state only: the sim backref and every tensor
        (chi/udef/sdf, caches, the device rigid pack) are rebuilt by
        CreateObstacles after a restore."""
        state = {}
        for k, v in self.__dict__.items():
            if k in ("sim", "_dev_rigid") or isinstance(v, torch.Tensor):
                continue
            if k.endswith("_cache"):
                continue
            state[k] = v
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.sim = None
        self.chi = None
        self.udef = None
        self.sdf = None
        self._dev_rigid = None

    # -- geometry ---------------------------------------------------------

    def rasterize(self, t: float):
        """(sdf, udef) dense fields; sdf > 0 inside, udef (..., 3) or None
        for a rigid body."""
        raise NotImplementedError

    def update_shape(self, t: float, dt: float) -> None:
        """Advance internal deformation kinematics (the fish's midline)."""

    def create(self, t: float) -> None:
        """SDF -> chi + udef (reference Obstacle::create + chi kernel).
        The SDF is kept: the surface-point force probe (ops/surface.py)
        takes its outward normals from grad(phi)."""
        from cup3d_tpu_torch.ops.chi import towers_chi

        sdf, udef = self.rasterize(t)
        self.sdf = sdf
        self.chi = towers_chi(self.sim.grid.pad_scalar(sdf, 1),
                              self.sim.grid.h)
        self.udef = udef if udef is not None else torch.zeros(
            tuple(self.sim.grid.shape) + (3,), dtype=self.sim.dtype,
            device=self.sim.device)

    def max_body_speed(self, uinf=None) -> float:
        """Host bound on the body's material speed in the sim frame: rigid
        translation (+ frame velocity) + rotation at the body radius (+
        deformation in the fish)."""
        tv = np.asarray(self.transVel, np.float64)
        if uinf is not None:
            tv = tv + np.asarray(uinf, np.float64)
        om = float(np.linalg.norm(np.asarray(self.angVel, np.float64)))
        return float(np.linalg.norm(tv)) + om * 0.5 * float(self.length)

    # -- device fast path --------------------------------------------------

    def supports_device_update(self) -> bool:
        """True when the rigid update has no host-only branch this step
        (an active collision latch takes the host path; subclasses add
        their own vetoes, e.g. the StefanFish's roll correction)."""
        return self.collision_counter <= 0

    def rigid_state_vec(self) -> np.ndarray:
        """Host mirrors -> (RIGID_STATE,) input for rigid_update_device."""
        return np.concatenate(
            [self.transVel, self.angVel, self.position, self.absPos,
             self.centerOfMass, self.quaternion]
        )

    def rigid_state_dev(self, dtype) -> torch.Tensor:
        """(RIGID_STATE,) device input for rigid_update_device: chains from
        the previous step's device output when it exists (pipelined
        stepping keeps the rigid trajectory on the device), else uploads
        the host mirrors (the non-pipelined step clears the chain when its
        read refreshes them)."""
        d = self._dev_rigid
        if d is not None:
            return d["pack"][:RIGID_STATE]
        return upload(self.rigid_state_vec(), dtype, self.sim.device)

    def forced_mask_dev(self) -> torch.Tensor:
        """Cached device mirror of ``bForcedInSimFrame`` (uploaded again
        only when the attribute is reassigned)."""
        if getattr(self, "_forced_src_cache", None) is not self.bForcedInSimFrame:
            self._forced_dev_cache = upload(self.bForcedInSimFrame,
                                            torch.bool, self.sim.device,
                                            tag="scalar-upload")
            self._forced_src_cache = self.bForcedInSimFrame
        return self._forced_dev_cache

    def block_mask_dev(self) -> torch.Tensor:
        """Cached device mirror of ``bBlockRotation``."""
        if getattr(self, "_block_src_cache", None) is not self.bBlockRotation:
            self._block_dev_cache = upload(self.bBlockRotation, torch.bool,
                                           self.sim.device,
                                           tag="scalar-upload")
            self._block_src_cache = self.bBlockRotation
        return self._block_dev_cache

    def pos_rot_device(self, dtype):
        """(position, rotation matrix) on the device for rasterization:
        from the device rigid pack while the pipelined chain runs (the
        host mirrors trail it), else from the host mirrors."""
        d = self._dev_rigid
        if d is not None and self.sim.cfg.pipelined:
            pack = d["pack"]
            return pack[6:9], quat_to_rot_dev(pack[15:19])
        host = np.concatenate([self.position,
                               quat_to_rot(self.quaternion).reshape(9)])
        dev = upload(host, dtype, self.sim.device)
        return dev[0:3], dev[3:12].reshape(3, 3)

    def apply_rigid_pack(self, row: np.ndarray,
                         clear_dev: bool = True) -> None:
        """(RIGID_PACK,) output of rigid_update_device -> host mirrors.
        ``clear_dev=False`` (pipelined stepping) keeps the device chain:
        the trailing mirrors must not replace it."""
        row = np.asarray(row, np.float64)
        self.transVel = row[0:3]
        self.angVel = row[3:6]
        self.position = row[6:9]
        self.absPos = row[9:12]
        self.centerOfMass = row[12:15]
        self.quaternion = row[15:19]
        if row[19] > 0:
            self.mass = float(row[19])
            self.J = row[20:29].reshape(3, 3)
        if clear_dev:
            self._dev_rigid = None

    # -- rigid-body dynamics ----------------------------------------------

    def body_velocity_field(self) -> torch.Tensor:
        """u_body = u_trans + omega x r + u_def on the whole grid, memoized
        per (step, rigid state): penalization and the force pass use the
        same field each step."""
        s = self.sim
        dev = self._dev_rigid
        if dev is not None and dev["step"] == s.step:
            tag = (s.step, "dev")
            cm, ut, om = dev["cm"], dev["trans"], dev["ang"]
        else:
            tag = (s.step, tuple(self.transVel), tuple(self.angVel),
                   tuple(self.centerOfMass))
            kin = upload(np.stack([self.centerOfMass, self.transVel,
                                   self.angVel]), s.dtype, s.device)
            cm, ut, om = kin[0], kin[1], kin[2]
        cached = getattr(self, "_ubody_cache", None)
        if cached is not None and cached[0] == tag:
            return cached[1]
        field = s.ubody(self.udef, cm, ut, om)
        self._ubody_cache = (tag, field)
        return field

    def compute_velocities(self, moments: Dict[str, np.ndarray]) -> None:
        """Host 6x6 momentum solve for (u_trans, omega) (reference
        computeVelocities, main.cpp:12921-13029), then the forced
        components' overrides."""
        m = moments["mass"]
        if m <= 0:
            return
        cm = moments["center"] / m
        self.centerOfMass = cm
        P = moments["lin_mom"]
        L = moments["ang_mom"]
        J = moments["inertia"]
        A = np.zeros((6, 6))
        A[:3, :3] = m * np.eye(3)
        A[3:, 3:] = J
        sol = np.linalg.solve(A, np.concatenate([P, L]))
        self.mass = m
        self.J = J
        new_ut, new_om = sol[:3], sol[3:]
        self.transVel = np.where(self.bForcedInSimFrame, self.transVel, new_ut)
        self.angVel = np.where(self.bBlockRotation, self.angVel, new_om)
        # a fresh collision overrides the fluid-coupled solve for one step
        # (reference main.cpp:13069-13077)
        if self.collision_counter > 0:
            self.collision_counter -= self.sim.dt
            self.transVel = self.collision_vel.copy()
            self.angVel = self.collision_angvel.copy()

    def update(self, dt: float) -> None:
        """Advance position/orientation on the host (main.cpp:13116-13204)."""
        uinf = self.sim.uinf
        self.position = self.position + dt * (self.transVel + uinf)
        self.absPos = self.absPos + dt * self.transVel
        self.centerOfMass = self.centerOfMass + dt * (self.transVel + uinf)
        self.quaternion = quat_integrate(self.quaternion, self.angVel, dt)


# -- QoI packing: every per-step reduction travels in the step's one read ---

_MOMENT_KEYS = ("mass", "center", "lin_mom", "ang_mom", "inertia")
_FORCE_KEYS = ("pres_force", "visc_force", "torque", "power", "pout_bnd",
               "thrust", "drag", "def_power", "def_power_bnd", "p_locom",
               "n_surf")
FORCE_PACK = 17


def pack_moments(m: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Momentum-integral dict -> (19,) device vector."""
    return torch.cat([torch.reshape(m[k], (-1,)) for k in _MOMENT_KEYS])


def unpack_moments(a) -> Dict[str, np.ndarray]:
    a = np.asarray(a, np.float64)
    return {
        "mass": a[0],
        "center": a[1:4],
        "lin_mom": a[4:7],
        "ang_mom": a[7:10],
        "inertia": a[10:19].reshape(3, 3),
    }


def pack_forces(f: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Force-integral dict -> (FORCE_PACK,) device vector; the probe-only
    slots a band producer lacks pack as 0."""
    ref = f["power"]
    z = torch.zeros((), dtype=ref.dtype, device=ref.device)
    return torch.cat([torch.reshape(f.get(k, z), (-1,)).to(ref.dtype)
                      for k in _FORCE_KEYS])


def unpack_forces(a) -> Dict[str, np.ndarray]:
    a = np.asarray(a, np.float64)
    return {
        "pres_force": a[0:3],
        "visc_force": a[3:6],
        "torque": a[6:9],
        "power": float(a[9]),
        "pout_bnd": float(a[10]),
        "thrust": float(a[11]),
        "drag": float(a[12]),
        "def_power": float(a[13]),
        "def_power_bnd": float(a[14]),
        "p_locom": float(a[15]),
        "n_surf": float(a[16]),
    }


def derived_force_qoi(f: Dict[str, np.ndarray], trans_vel: np.ndarray,
                      eps: float = 1e-21) -> Dict[str, float]:
    """Host-side derived swimming QoI (main.cpp:13098-13114)."""
    vnorm = float(np.linalg.norm(trans_vel))
    pthrust = f["thrust"] * vnorm
    pdrag = f["drag"] * vnorm
    def_power = f["def_power"]
    eff = pthrust / (pthrust - min(def_power, 0.0) + eps)
    eff_bnd = pthrust / (pthrust - f.get("def_power_bnd", 0.0) + eps)
    return {"Pthrust": pthrust, "Pdrag": pdrag, "EffPDef": eff,
            "EffPDefBnd": eff_bnd}


def momentum_integrals_core(x: torch.Tensor, vol, chi: torch.Tensor,
                            vel: torch.Tensor, cm_guess: torch.Tensor):
    """Layout-generic chi-weighted moments (KernelIntegrateFluidMomenta,
    main.cpp:13625-13735).  x: (..., 3) cell centres; vol a scalar or
    broadcastable to chi.  Products and sums are elementwise f32 (no
    GEMM, so no TF32 question)."""
    w = (chi * vol).reshape(-1)
    xf = x.reshape(-1, 3)
    vf = vel.reshape(-1, 3)
    wc = w[:, None]
    mass = torch.sum(w)
    center = torch.sum(wc * xf, dim=0)
    lin = torch.sum(wc * vf, dim=0)
    r = xf - cm_guess
    ang = torch.sum(wc * torch.linalg.cross(r, vf), dim=0)
    r2 = torch.sum(r * r, dim=-1)
    eye = torch.eye(3, dtype=vel.dtype, device=vel.device)
    wr = wc * r
    outer = torch.sum(wr[:, :, None] * r[:, None, :], dim=0)
    inertia = torch.sum(w * r2) * eye - outer
    return {"mass": mass, "center": center, "lin_mom": lin, "ang_mom": ang,
            "inertia": inertia}


def momentum_integrals(grid: UniformGrid, chi: torch.Tensor,
                       vel: torch.Tensor, cm_guess: torch.Tensor, xc=None):
    """Uniform-grid wrapper of momentum_integrals_core (``xc``: the
    driver's cached cell centres, else built here)."""
    if xc is None:
        xc = grid.cell_centers(vel.dtype, vel.device)
    return momentum_integrals_core(xc, grid.h ** 3, chi, vel, cm_guess)


def store_force_qoi(ob, f: Dict[str, np.ndarray]) -> None:
    """Unpacked force vector -> obstacle attributes incl. the derived
    swimming QoI (main.cpp:13098-13114)."""
    ob.pres_force = f["pres_force"]
    ob.visc_force = f["visc_force"]
    ob.force = ob.pres_force + ob.visc_force
    ob.torque = f["torque"]
    ob.pow_out = f["power"]
    ob.pout_bnd = f.get("pout_bnd", 0.0)
    ob.thrust = f["thrust"]
    ob.drag = f["drag"]
    ob.def_power = f["def_power"]
    ob.def_power_bnd = f.get("def_power_bnd", 0.0)
    ob.p_locom = f.get("p_locom", 0.0)
    # measured surface-band size: the probe's slot budget
    # (ops/surface.obstacle_probe_budget)
    n_surf = f.get("n_surf", 0.0)
    if n_surf > 0:
        ob.n_surf_points = n_surf
    d = derived_force_qoi(f, ob.transVel)
    ob.Pthrust, ob.Pdrag, ob.EffPDef = d["Pthrust"], d["Pdrag"], d["EffPDef"]
    ob.EffPDefBnd = d["EffPDefBnd"]


def log_forces(logger, i: int, time: float, ob) -> None:
    """forces_<i>.txt row (main.cpp:13089-13114)."""
    logger.write(
        f"forces_{i}.txt",
        f"{time:.8e} " + " ".join(f"{v:.8e}" for v in ob.force)
        + f" {ob.pow_out:.8e} {ob.pout_bnd:.8e} {ob.thrust:.8e}"
        + f" {ob.drag:.8e} {ob.def_power:.8e} {ob.def_power_bnd:.8e}"
        + f" {ob.p_locom:.8e} {ob.EffPDef:.8e} {ob.EffPDefBnd:.8e}\n",
    )


def update_penalization_forces(obstacles, penal_force_fn, vel_new, vel_old,
                               dt, dtype) -> torch.Tensor:
    """Per-obstacle momentum-balance force/torque ON THE BODY (the
    negative of what the penalization injects into the fluid;
    main.cpp:13913-13938).  Returns the (n_obs, 6) device tensor; the
    rows ride the step's read into ``penal_force``/``penal_torque``.
    Centres of mass come from this step's device rigid update where it
    ran, else from the host mirrors."""
    def _cm(ob):
        d = ob._dev_rigid
        if d is not None and d["step"] == ob.sim.step:
            return d["cm"]
        return upload(ob.centerOfMass, dtype, ob.sim.device)

    cms = torch.stack([_cm(ob) for ob in obstacles])
    PF = -penal_force_fn(vel_new, vel_old, tuple(ob.chi for ob in obstacles),
                         dt, cms)
    for i, ob in enumerate(obstacles):
        # device rows until the step's read replaces them with numpy
        ob.penal_force = PF[i, :3]
        ob.penal_torque = PF[i, 3:]
    return PF
