"""StefanFish: the self-propelled carangiform swimmer (port of
``cup3d_tpu/models/fish/stefanfish.py``; the reference's StefanFish,
main.cpp:8960-8978, 15668-15981, on top of Fish, 7586-7617,
10597-10958).

- CurvatureDefinedFishData (host, numpy float64) generates the gait and
  removes the deformation's momenta;
- PID feedback on streamwise/lateral position (alpha/beta), depth
  (gamma) and roll toward the spawn point;
- the RL interface: ``act()``, ``state()`` (25 values, 3 shear sensors).

The SDF/udef rasterization runs on a dense window around the body on
the uniform grid, and on the candidate blocks around it on the forest
(``_rasterize_blocks``), both through models/fish/rasterize.py.
"""

from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import upload
from cup3d_tpu_torch.models.base import Obstacle, quat_to_rot
from cup3d_tpu_torch.models.fish.curvature import CurvatureDefinedFishData
from cup3d_tpu_torch.models.fish.rasterize import (rasterize_midline,
                                                   rasterize_points)
from cup3d_tpu_torch.models.fish.shapes import compute_widths_heights


def _raster_window_dense(pos, rot, midline, half, h, grid_shape,
                         window_shape):
    """Window snap, midline rasterization and dense placement.  The window
    corner is snapped on the device from the device position (the host
    mirror trails it under pipelined stepping and in the megaloop) in the
    solver dtype, as the JAX package does, and the window is placed
    through an advanced index: no device read.  ``half`` the window's
    half extent as a device tensor, ``h`` the spacing in the solver
    dtype."""
    from cup3d_tpu_torch.ops.surface import window_index

    dtype, dev = pos.dtype, pos.device
    lim = upload(np.asarray(grid_shape) - np.asarray(window_shape),
                 torch.long, dev)
    idx0 = torch.minimum(torch.clamp_min(
        torch.floor((pos - half) / h).to(torch.long), 0), lim)
    origin = idx0.to(dtype) * h
    sdf_w, udef_w = rasterize_midline(origin, h, window_shape, midline, pos,
                                      rot)
    sl = window_index(idx0, window_shape)
    # out of place: the fleet's fish lanes place each lane's window at its
    # own position from one shared background (torch.func.vmap)
    sdf = torch.full(tuple(grid_shape), -1.0, dtype=dtype,
                     device=dev).index_put(sl, sdf_w)
    udef = torch.zeros(tuple(grid_shape) + (3,), dtype=dtype,
                       device=dev).index_put(sl, udef_w)
    return sdf, udef


def _raster_scatter_blocks(xc, idx, mpad: int, midline, position, rot):
    """Gather the candidate blocks' cell centres, rasterize the midline
    there and scatter into full forest arrays (sdf -1, udef 0 off the
    candidates).  ``idx``: the candidate slots; the pass runs on
    ``mpad`` rows, the rest taking far-away centres as the JAX package's
    out-of-range gather fills them, and drops them."""
    dtype, dev = xc.dtype, xc.device
    m = idx.shape[0]
    centers = xc[idx]
    if mpad > m:
        far = torch.full((mpad - m,) + tuple(xc.shape[1:]), 1e6,
                         dtype=dtype, device=dev)
        centers = torch.cat([centers, far])
    sdf_c, udef_c = rasterize_points(centers, midline, position, rot)
    sdf = torch.full(tuple(xc.shape[:4]), -1.0, dtype=dtype, device=dev)
    sdf[idx] = sdf_c[:m]
    udef = torch.zeros(tuple(xc.shape[:4]) + (3,), dtype=dtype, device=dev)
    udef[idx] = udef_c[:m]
    return sdf, udef


def _clip_quantities(fmax, dfmax, dt, fcandidate, dfcandidate, f, df):
    """PID anti-windup clipping (main.cpp:15698-15713)."""
    if abs(dfcandidate) > dfmax:
        df = dfmax if dfcandidate > 0 else -dfmax
        f = f + dt * df
    elif abs(fcandidate) < fmax:
        f, df = fcandidate, dfcandidate
    else:
        f = fmax if fcandidate > 0 else -fmax
        df = 0.0
    return f, df


class StefanFish(Obstacle):
    def __init__(self, sim, spec: Dict[str, str]):
        super().__init__(sim, spec)
        g = lambda k, d: float(spec.get(k, d))
        b = lambda k: spec.get(k, "0").lower() in ("1", "true")
        self.Tperiod = g("T", 1.0)
        self.phaseShift = g("phi", 0.0)
        amp = g("amplitudeFactor", 1.0)
        self.bCorrectPosition = b("CorrectPosition")
        self.bCorrectPositionZ = b("CorrectPositionZ")
        self.bCorrectRoll = b("CorrectRoll")
        height_name = spec.get("heightProfile", "baseline")
        width_name = spec.get("widthProfile", "baseline")
        self.wyp = g("wyp", 1.0)
        self.wzp = g("wzp", 1.0)
        if (self.bCorrectPosition or self.bCorrectPositionZ or self.bCorrectRoll
                ) and abs(self.quaternion[0] - 1) > 1e-6:
            raise ValueError("PID controllers require zero initial angles")

        # midline resolution follows the finest spacing (main.cpp:15402)
        h = sim.grid.hmin
        self.myFish = CurvatureDefinedFishData(
            self.length, self.Tperiod, self.phaseShift, h, amp
        )
        self.myFish.height, self.myFish.width = compute_widths_heights(
            height_name, width_name, self.length, self.myFish.rS
        )
        self.origC = self.position.copy()  # PID target (spawn point)
        self.r_axis: deque = deque()  # roll-axis history for bCorrectRoll

        # uniform layout: a static rasterization window (the deformed
        # fish stays within ~0.6 L of its centre; margin for the mollified
        # band); block layout: candidate blocks are found per call
        self._is_blocks = not hasattr(sim.grid, "shape")
        if not self._is_blocks:
            nw = int(np.ceil(1.25 * self.length / h)) + 8
            self._window_shape = tuple(min(nw, n) for n in sim.grid.shape)

    # -- geometry pipeline (Fish::create, main.cpp:10952-10958) ------------

    def update_shape(self, t: float, dt: float) -> None:
        self._apply_position_pid(dt)
        self.myFish.compute_midline(t, dt)
        self.myFish.integrate_linear_momentum()
        self.myFish.integrate_angular_momentum(max(dt, 1e-12))
        self._update_sensor_locations()

    def max_body_speed(self, uinf=None) -> float:
        """Rigid bound + the midline's max deformation speed."""
        base = super().max_body_speed(uinf)
        v = np.asarray(self.myFish.v, np.float64)
        return base + float(np.sqrt((v * v).sum(-1).max()))

    def _apply_position_pid(self, dt: float) -> None:
        """alpha/beta/gamma corrections (StefanFish::create,
        main.cpp:15716-15778)."""
        cf = self.myFish
        q = self.quaternion
        s = self.sim
        Rrow = np.array(
            [2 * (q[1] * q[3] - q[2] * q[0]), 2 * (q[2] * q[3] + q[1] * q[0]),
             1 - 2 * (q[1] * q[1] + q[2] * q[2])]
        )
        nm = cf.Nm
        d = cf.r[0] - cf.r[nm // 2]
        dn = np.linalg.norm(d) + 1e-21
        pitch = np.arcsin(np.clip(Rrow @ (d / dn), -1.0, 1.0))
        roll = np.arctan2(2 * (q[3] * q[2] + q[0] * q[1]),
                          1 - 2 * (q[1] * q[1] + q[2] * q[2]))
        yaw = np.arctan2(2 * (q[3] * q[0] + q[1] * q[2]),
                         -1 + 2 * (q[0] * q[0] + q[1] * q[1]))
        roll_small = abs(roll) < np.pi / 9
        yaw_small = abs(yaw) < np.pi / 9
        dt_eff = max(dt, 1e-12)

        if self.bCorrectPosition:
            cf.alpha = 1.0 + (self.position[0] - self.origC[0]) / self.length
            cf.dalpha = (self.transVel[0] + s.uinf[0]) / self.length
            if not roll_small:
                cf.alpha, cf.dalpha = 1.0, 0.0
            elif cf.alpha < 0.9:
                cf.alpha, cf.dalpha = 0.9, 0.0
            elif cf.alpha > 1.1:
                cf.alpha, cf.dalpha = 1.1, 0.0
            dy = (self.origC[1] - self.absPos[1]) / self.length
            sign_y = 1.0 if dy > 0 else -1.0
            dphi = yaw - 0.0
            bb = self.wyp * sign_y * dy * dphi if roll_small else 0.0
            dbdt = (bb - cf.beta) / dt_eff if s.step > 1 else 0.0
            cf.beta, cf.dbeta = _clip_quantities(
                1.0, 5.0, dt_eff, bb, dbdt, cf.beta, cf.dbeta
            )
        if self.bCorrectPositionZ:
            dphi = pitch - 0.0
            dz = (self.origC[2] - self.absPos[2]) / self.length
            sign_z = 1.0 if dz > 0 else -1.0
            gg = (-self.wzp * dphi * dz * sign_z
                  if (roll_small and yaw_small) else 0.0)
            dgdt = (gg - cf.gamma) / dt_eff if s.step > 1 else 0.0
            gmax = 0.10 / self.length
            dRdtmax = 0.1 * self.length / cf.Tperiod
            dgdtmax = abs(gmax * gmax * dRdtmax)
            cf.gamma, cf.dgamma = _clip_quantities(
                gmax, dgdtmax, dt_eff, gg, dgdt, cf.gamma, cf.dgamma
            )

    def _midline_device(self):
        """One packed (Nm, 20) upload per rasterization, sliced back into
        the rasterizer's dict on the device."""
        cf = self.myFish
        packed = np.concatenate(
            [cf.r, cf.v, cf.nor, cf.vnor, cf.bin, cf.vbin,
             cf.width[:, None], cf.height[:, None]], axis=1
        )
        dev = upload(packed, self.sim.dtype, self.sim.device)
        return {
            "r": dev[:, 0:3], "v": dev[:, 3:6],
            "nor": dev[:, 6:9], "vnor": dev[:, 9:12],
            "bin": dev[:, 12:15], "vbin": dev[:, 15:18],
            "width": dev[:, 18], "height": dev[:, 19],
        }

    def window_half(self) -> torch.Tensor:
        """Half extent of the rasterization window, in the solver dtype on
        the device (the device snap's operand)."""
        s = self.sim
        half = 0.5 * np.asarray(self._window_shape) * s.grid.h
        return upload(half, s.dtype, s.device)

    def _rasterize_blocks(self, t: float):
        """Forest rasterization: candidate blocks by box intersection on
        the host (the reference's prepare_segPerBlock,
        main.cpp:10672-10717) with the body's box padded at each block's
        own h (ops/surface.probe_margin), one midline pass over their
        cells, gathered from the driver's cached centres ``sim.xc`` (the
        real blocks'), scattered into (nb, bs, bs, bs) arrays.  The candidate count is
        padded to a multiple of 16 as in the JAX package."""
        from cup3d_tpu_torch.ops.surface import probe_margin

        s = self.sim
        grid = s.grid
        half = probe_margin(self.length, grid.h)  # (nb,)
        lo = grid.origin
        hi = grid.origin + (grid.bs * grid.h)[:, None]
        cand = (np.all(hi > self.position - half[:, None], axis=1)
                & np.all(lo < self.position + half[:, None], axis=1))
        idx = np.where(cand)[0]
        mpad = max(16, -(-len(idx) // 16) * 16)
        pos, rot = self.pos_rot_device(s.dtype)
        return _raster_scatter_blocks(
            s.xc, upload(idx, torch.long, s.device), mpad,
            self._midline_device(), pos, rot)

    def rasterize(self, t: float):
        if self._is_blocks:
            return self._rasterize_blocks(t)
        s = self.sim
        npd = np.float32 if s.dtype == torch.float32 else np.float64
        pos, rot = self.pos_rot_device(s.dtype)
        return _raster_window_dense(
            pos, rot, self._midline_device(), self.window_half(),
            float(npd(s.grid.h)), tuple(s.grid.shape),
            tuple(self._window_shape))

    def create(self, t: float) -> None:
        from cup3d_tpu_torch.ops.chi import towers_chi

        sdf, udef = self.rasterize(t)
        self.sdf = sdf
        self.chi = towers_chi(self.sim.grid.pad_scalar(sdf, 1),
                              self.sim.grid.h)
        # deformation velocity only matters inside the mollified band
        self.udef = udef * (self.chi > 0)[..., None]

    # -- rigid-body override: roll correction ------------------------------

    def supports_device_update(self) -> bool:
        # roll correction mutates angVel on the host after the 6x6 solve
        return super().supports_device_update() and not self.bCorrectRoll

    def compute_velocities(self, moments) -> None:
        super().compute_velocities(moments)
        if not self.bCorrectRoll:
            return
        cf = self.myFish
        s = self.sim
        q = self.quaternion
        o = self.angVel
        dq = 0.5 * np.array(
            [
                -o[0] * q[1] - o[1] * q[2] - o[2] * q[3],
                +o[0] * q[0] + o[1] * q[3] - o[2] * q[2],
                -o[0] * q[3] + o[1] * q[0] + o[2] * q[1],
                +o[0] * q[2] - o[1] * q[1] + o[2] * q[0],
            ]
        )
        nom = 2 * (q[3] * q[2] + q[0] * q[1])
        dnom = 2 * (dq[3] * q[2] + dq[0] * q[1] + q[3] * dq[2] + q[0] * dq[1])
        denom = 1 - 2 * (q[1] * q[1] + q[2] * q[2])
        ddenom = -4 * (q[1] * dq[1] + q[2] * dq[2])
        arg = nom / denom
        darg = (dnom * denom - nom * ddenom) / denom**2
        a = np.arctan2(nom, denom)
        da = darg / (1 + arg * arg)

        # running 5-second average of the head->tail axis = roll axis
        nm = cf.Nm
        d = cf.r[0] - cf.r[nm - 1]
        dn = np.linalg.norm(d) + 1e-21
        self.r_axis.append(np.array([-d[0] / dn, -d[1] / dn, -d[2] / dn,
                                     s.dt]))
        roll_axis = np.zeros(3)
        time_roll = 0.0
        keep = 0
        for entry in reversed(self.r_axis):
            if time_roll + entry[3] > 5.0:
                break
            roll_axis += entry[:3] * entry[3]
            time_roll += entry[3]
            keep += 1
        for _ in range(len(self.r_axis) - keep):
            self.r_axis.popleft()
        time_roll += 1e-21
        roll_axis /= time_roll
        if s.time < 1.0 or time_roll < 1.0:
            return
        o -= (o @ roll_axis) * roll_axis  # kill the roll component
        corr, _ = _clip_quantities(0.025, 1e4, s.dt, a + 0.05 * da, 0.0, 0.0,
                                   0.0)
        o -= corr * roll_axis
        self.angVel = o

    # -- sensors / RL interface (main.cpp:15860-15981) ---------------------

    def _update_sensor_locations(self) -> None:
        cf = self.myFish
        rot = quat_to_rot(self.quaternion)
        to_comp = lambda x: self.position + rot @ x
        cf.sensorLocation[0:3] = to_comp(cf.r[0])
        # station with rS[ss] <= 0.04 L < rS[ss+1] (main.cpp:11438)
        ss = int(np.searchsorted(cf.rS, 0.04 * self.length, side="right")) - 1
        ss = min(max(ss, 1), cf.Nm - 2)
        offset = np.pi / 2 if cf.height[ss] > cf.width[ss] else 0.0
        for idx, theta in ((1, offset), (2, offset + np.pi)):
            p = (
                cf.r[ss]
                + cf.width[ss] * np.cos(theta) * cf.nor[ss]
                + cf.height[ss] * np.sin(theta) * cf.bin[ss]
            )
            cf.sensorLocation[3 * idx: 3 * idx + 3] = to_comp(p)

    def act(self, t_rl_action: float, action) -> None:
        action = list(np.atleast_1d(action))
        if len(action) > 1 and self.bForcedInSimFrame[2]:
            action[1] = 0.0
        cf = self.myFish
        cf.oldrCurv = cf.lastCurv
        cf.lastCurv = float(action[0])
        cf.lastTact = float(t_rl_action)
        cf.execute(self.sim.time, t_rl_action, action)

    def get_learn_t_period(self) -> float:
        return self.myFish.next_period

    def get_phase(self, t: float) -> float:
        cf = self.myFish
        arg = (
            2 * np.pi * ((t - cf.time0) / cf.periodPIDval + cf.timeshift)
            + np.pi * cf.phaseShift
        )
        return float(np.mod(arg, 2 * np.pi))

    def state(self) -> np.ndarray:
        """25-value RL observation (main.cpp:15889-15931)."""
        cf = self.myFish
        Tp, L = cf.Tperiod, self.length
        S = np.zeros(25)
        S[0:3] = self.position
        S[3:7] = self.quaternion
        S[7] = self.get_phase(self.sim.time)
        S[8:11] = self.transVel * Tp / L
        S[11:14] = self.angVel * Tp
        S[14] = cf.lastCurv
        S[15] = cf.oldrCurv
        # reference quirk kept: upper/lower sensors swapped when sampled
        # (main.cpp:15917-15919)
        locs = cf.sensorLocation
        for i, j in ((0, 0), (1, 2), (2, 1)):
            S[16 + 3 * i: 19 + 3 * i] = self.get_shear(
                locs[3 * j: 3 * j + 3]) * (Tp / L)
        return S

    def get_shear(self, pos: np.ndarray) -> np.ndarray:
        """Viscous traction nu (grad u + grad u^T) . n_hat at a point, with
        n_hat the outward normal from -grad(chi) (getShear,
        main.cpp:15933-15981).  Reads a 4^3 patch of the device fields: an
        RL accessor, never called by the step.  On the forest the patch
        lies in the leaf holding ``pos``, finest level first
        (holdingBlockID), clamped to its interior (sensors sit on the
        body's surface, whose blocks are at the finest level, so the
        clamp moves it at most one cell)."""
        s = self.sim
        grid = s.grid
        pos = np.asarray(pos, np.float64)
        if self._is_blocks:
            bs = grid.bs
            slot = -1
            for l in range(grid.tree.cfg.level_max - 1, -1, -1):
                hl = grid.h0 / (1 << l)
                bpos = np.floor(pos / (bs * hl)).astype(int)
                n = grid.tree.blocks_per_dim(l)
                if np.any(bpos < 0) or np.any(bpos >= np.asarray(n)):
                    continue
                sl_ = grid._slot_maps[l][tuple(bpos)]
                if sl_ >= 0:
                    slot, h = int(sl_), hl
                    bcell0 = bpos * bs
                    break
            if slot < 0:
                return np.zeros(3)
            gidx = np.floor(pos / h - 0.5).astype(int)
            lidx = np.clip(gidx - bcell0, 1, bs - 3)
            idx = bcell0 + lidx
            sl = (slot,) + tuple(slice(int(i) - 1, int(i) + 3)
                                 for i in lidx)
        else:
            h = grid.h
            idx = np.clip(np.floor(pos / h - 0.5).astype(int), 1,
                          np.asarray(grid.shape) - 3)
            sl = tuple(slice(int(i) - 1, int(i) + 3) for i in idx)
        pv = s.state["vel"][sl].detach().cpu().numpy().astype(np.float64)
        pc = s.state["chi"][sl].detach().cpu().numpy().astype(np.float64)
        gv = np.stack(np.gradient(pv, h, axis=(0, 1, 2)), axis=-1)[1:3, 1:3, 1:3]
        gc = np.stack(np.gradient(pc, h, axis=(0, 1, 2)), axis=-1)[1:3, 1:3, 1:3]
        frac = np.asarray(pos) / h - 0.5 - idx
        w = np.ones((2, 2, 2))
        for ax in range(3):
            t = np.clip(frac[ax], 0.0, 1.0)
            shape = [1, 1, 1]
            shape[ax] = 2
            w = w * np.array([1 - t, t]).reshape(shape)
        gv_p = np.einsum("xyz,xyzcd->cd", w, gv)  # d u_c / d x_d
        gc_p = np.einsum("xyz,xyzd->d", w, gc)
        n = -gc_p / (np.linalg.norm(gc_p) + 1e-21)
        return s.nu * (gv_p + gv_p.T) @ n
