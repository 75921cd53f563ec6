"""K-step megaloop: K whole timesteps from a device carry, one QoI read
per K steps (port of ``cup3d_tpu/sim/megaloop.py``, the unsharded
bodies).

The per-step loop reads one QoI pack a step (or, pipelined, streams it)
and evaluates the fish midline on the host.  Here K full timesteps — dt
policy, midline kinematics, SDF/chi rasterization, advection-diffusion,
the 6-DOF rigid update, penalization, projection and the surface force
probe — run from a device carry with no QoI read until the end, where the
(K, ROW) block of rows goes out through the QoI stream (stream/qoi.py).

Step semantics are the JAX package's:

- dt comes from the CARRIED umax (one step stale, the same staleness as
  the host chain's freshly consumed pack, so no 1.5x margin), capped by
  the combined advection-diffusion bound and the 1.03x growth limiter;
  the ramp's ``cfl_eff`` column is computed on the host and shipped once
  per megaloop;
- the midline is the frozen-gait device twin
  (models/fish/device_midline.py) at the carried time; rasterization
  snaps the same window as StefanFish.rasterize from the PRE-update rigid
  state;
- umax is measured with the PRE-update uinf, as the per-step emit point;
- the fish row (FISH_ROW) carries everything the consumer needs to
  refresh the host mirrors for each step k.

Where the port differs: JAX's scan is one compiled dispatch and its
Krylov solve ends in a device-side ``while_loop``.  Here the K steps are
a Python loop of eager launches, and the iterative Poisson solve inside
keeps its host read of the residual once per chunk of 4 iterations
(ROADMAP ground rule 6): the one place where the K steps are not free of
host reads.  A CUDA graph of the K steps with device-side Krylov
termination is ROADMAP A4's second part.

The x-slab sharded bodies (``CUP3D_MESH_X=D``, parallel/topology.py):
the field is cut into D x-slabs, a leading axis of one tensor on one
device.  RK3 (and the TGV projection's divergence) read slabs padded by
parallel/ring.pad_slab_vector, whose cross-slab x-ghosts are B14 ring
steps; the global phases (the spectral solve, rasterization, chi, the
momentum integrals, the rigid update, penalization, the fish's
projection and the probe) run once on the gathered field, which on one
device is the unsharded view (parallel/collectives.py).  Every element
sees the solo step's arithmetic, so a sharded megaloop is bitwise the
solo one, and the carry keeps its global shape: dumps, checkpoints and
the QoI rows see the solo layout.
"""

from __future__ import annotations

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import upload
from cup3d_tpu_torch.models.base import (
    RIGID_STATE,
    momentum_integrals_core,
    pack_forces,
    pack_moments,
    quat_to_rot_dev,
    rigid_update_device,
)
from cup3d_tpu_torch.ops import stencils as st
from cup3d_tpu_torch.ops.advection import GHOSTS, rk3_step
from cup3d_tpu_torch.ops.chi import towers_chi
from cup3d_tpu_torch.ops.diagnostics import max_velocity
from cup3d_tpu_torch.ops.penalization import (
    penalize,
    per_obstacle_penalization_force,
)
from cup3d_tpu_torch.ops.projection import project
from cup3d_tpu_torch.parallel import collectives as coll
from cup3d_tpu_torch.parallel import ring
from cup3d_tpu_torch.parallel.compat import shard_view
from cup3d_tpu_torch.sim import dtpolicy

# QoI row layouts.  Fish: rigid pack 0:29 | penal force/torque 29:35 |
# force probe pack 35:52 | [residual, iterations] 52:54 | internal
# quaternion 54:58 | umax 58 | dt 59 | time 60.
FISH_ROW = 61
# TGV (obstacle-free): [residual, iterations] 0:2 | umax 2 | dt 3 | time 4.
TGV_ROW = 5

DEFAULT_SCAN_K = 8


def _solver_stats(dtype, device):
    """Stats of a solver that has none: iterations = -1 (the consumer
    skips them), so the row keeps its layout."""
    return upload(np.array([0.0, -1.0]), dtype, device)


def _scalar(v, dtype, device):
    return upload(np.asarray(v, np.float64), dtype, device)


def init_tgv_carry(s):
    """Obstacle-free carry from the current state: the umax seed measured
    on the device (no read); dt and time from the host scalars, so the
    first dt chains off the last host dt."""
    vel = s.state["vel"]
    return {
        "vel": vel,
        "p": s.state["p"],
        "umax": max_velocity(vel, s.uinf_device()),
        "time": _scalar(s.time, s.dtype, s.device),
        "dt": _scalar(s.dt, s.dtype, s.device),
    }


def init_fish_carry(s, ob):
    """Single-fish carry: fields + the 6-DOF rigid vector + the internal
    quaternion, all on the device.  The umax seed is floored by the host's
    max_body_speed bound (the cold start: fields at rest, the gait about
    to accelerate them)."""
    dtype, dev = s.dtype, s.device
    vel, udef = s.state["vel"], s.state["udef"]
    rigid = upload(ob.rigid_state_vec(), dtype, dev)
    uinf = -rigid[0:3] if ob.bFixFrameOfRef else s.uinf_device()
    umax = torch.maximum(max_velocity(vel, uinf), torch.max(torch.abs(udef)))
    umax = torch.maximum(umax, _scalar(ob.max_body_speed(s.uinf), dtype, dev))
    return {
        "vel": vel,
        "p": s.state["p"],
        "chi": s.state["chi"],
        "udef": udef,
        "rigid": rigid,
        "qint": upload(ob.myFish.quaternion_internal, dtype, dev),
        "umax": umax,
        "time": _scalar(s.time, dtype, dev),
        "dt": _scalar(s.dt, dtype, dev),
    }


def _dt_from_carry(umax, dtprev, cfl_eff, h: float, nu: float):
    """The device dt (sim/dtpolicy.dt_device), grown at most 1.03x over
    the previous dt."""
    dt = dtpolicy.dt_device(umax, cfl_eff, h, nu)
    return torch.where(dtprev > 0, torch.minimum(dt, 1.03 * dtprev), dt)


def _project(grid, vel, dt, solver, chi, udef, p, no_stats):
    """Projection warm-started from p, with the solver's [residual,
    iterations] (``no_stats``, the placeholder, for a solver without)."""
    if no_stats is None:
        vel, p, stats = project(grid, vel, dt, solver, chi, udef, p_init=p,
                                with_stats=True)
        return vel, p, stats.to(vel.dtype)
    vel, p = project(grid, vel, dt, solver, chi, udef, p_init=p)
    return vel, p, no_stats


def _advect(grid, nu: float, slabs):
    """RK3 of the whole field, or with ``slabs`` = D on its D x-slabs:
    ghosts from parallel/ring.pad_slab_vector (B14 ring steps across
    slabs), the result the gathered field (an unsharded view)."""
    if slabs is None:
        return lambda vel, dt, uinf: rk3_step(grid, vel, dt, nu, uinf)

    def pad(u, w):
        return ring.pad_slab_vector(grid, u, w)

    def advect(vel, dt, uinf):
        return coll.all_gather_tiled(rk3_step(
            grid, shard_view(vel, slabs), dt, nu, uinf, pad=pad))

    return advect


def make_tgv_step(s, slabs=None):
    """The obstacle-free step as a function ``one_step(carry, cfl_eff) ->
    (carry', row (TGV_ROW,))``; grid, solver and uinf are frozen.  With
    ``slabs`` = D (make_tgv_step_sharded) RK3 and the projection's
    divergence run on D x-slabs and max|u| reduces per slab then across
    them; the solve and the pressure gradient see the gathered field."""
    grid, nu, dtype, dev = s.grid, s.nu, s.dtype, s.device
    h = float(grid.h)
    solver = s.poisson_solver
    no_stats = (None if getattr(solver, "supports_stats", False)
                else _solver_stats(dtype, dev))
    uinf = s.uinf_device()
    advect = _advect(grid, nu, slabs)

    def project_slabs(vel, dt, p):
        # ops/projection.project with the divergence on padded slabs
        rhs = coll.all_gather_tiled(st.divergence(ring.pad_slab_vector(
            grid, shard_view(vel, slabs), 1), 1, grid.h) / dt)
        p = solver(rhs, p)
        return vel - dt * st.grad(grid.pad_scalar(p, 1), 1, grid.h), p

    def one_step(carry, cfl_eff):
        vel, p = carry["vel"], carry["p"]
        dt = _dt_from_carry(carry["umax"], carry["dt"], cfl_eff, h, nu)
        vel = advect(vel, dt, uinf)
        if slabs is None:
            vel, p, stats = _project(grid, vel, dt, solver, None, None, p,
                                     no_stats)
            umax_new = max_velocity(vel, uinf)
        else:
            vel, p = project_slabs(vel, dt, p)
            stats = no_stats
            umax_new = coll.pmax_axis(torch.amax(
                torch.abs(shard_view(vel, slabs) + uinf), dim=(1, 2, 3, 4)))
        time_new = carry["time"] + dt
        out = {"vel": vel, "p": p, "umax": umax_new, "time": time_new,
               "dt": dt}
        row = torch.cat([stats, umax_new.reshape(1), dt.reshape(1),
                         time_new.reshape(1)])
        return out, row

    return one_step


def _megaloop(one_step):
    def megaloop(carry, cfl_eff):
        rows = []
        for k in range(cfl_eff.shape[0]):
            carry, row = one_step(carry, cfl_eff[k])
            rows.append(row)
        return carry, torch.stack(rows)

    return megaloop


def build_tgv_megaloop(s):
    """(carry, cfl_eff (K,)) -> (carry', rows (K, TGV_ROW)) for the
    obstacle-free uniform pipeline."""
    return _megaloop(make_tgv_step(s))


def _fish_step_parts(s, ob, slabs=None):
    """The single-StefanFish step in two parts around its Frenet
    integration: ``pre(gait, carry, cfl_eff) -> (dt, curvature, rate)``
    and ``post(gait, carry, dt, sol) -> (carry', row)``.  The solo step
    runs the Frenet kernel between them on one midline; the fleet's fish
    lanes run ``pre`` and ``post`` over the lane axis and the kernel
    once on every lane's midline (fleet/batch.py).  Geometry is frozen at
    build time: the rasterization window, the probe window and its slot
    budget, the forced/blocked masks.  The frozen gait is an argument."""
    from cup3d_tpu_torch.models.fish.device_midline import (
        midline_curvature_device,
        midline_from_frenet_device,
    )
    from cup3d_tpu_torch.models.fish.stefanfish import (
        _raster_window_dense,
    )
    from cup3d_tpu_torch.ops.surface import (
        _uniform_window_probe,
        obstacle_probe_budget,
        window_size_cells,
    )

    grid, nu, dtype, dev = s.grid, s.nu, s.dtype, s.device
    cfg = s.cfg
    npd = np.float32 if dtype == torch.float32 else np.float64
    h = float(grid.h)
    hw = float(npd(h))  # the spacing the window snaps and probes use
    solver = s.poisson_solver
    no_stats = (None if getattr(solver, "supports_stats", False)
                else _solver_stats(dtype, dev))

    n = np.asarray(grid.shape)
    grid_shape = tuple(int(v) for v in n)
    window_shape = tuple(ob._window_shape)
    half_win = ob.window_half()
    wp = int(min(window_size_cells(ob.length, grid.h), n.min()))
    half_probe = _scalar(0.5 * wp * grid.h, dtype, dev)
    lim_probe = upload(n - wp, torch.long, dev)
    budget = obstacle_probe_budget(ob, grid.h)
    forced_mask = ob.forced_mask_dev()
    block_mask = ob.block_mask_dev()
    fix_frame = bool(ob.bFixFrameOfRef)
    uinf_const = None if fix_frame else s.uinf_device()
    xc = s.xc
    h3 = grid.h ** 3
    dlm = float(cfg.DLM)
    lam_static = _scalar(cfg.lambda_penalization, dtype, dev)
    advect = _advect(grid, nu, slabs)

    def pre(gait, carry, cfl_eff):
        # dt from the carried umax (one step stale, like the host chain)
        dt = _dt_from_carry(carry["umax"], carry["dt"], cfl_eff, h, nu)
        rK, vK = midline_curvature_device(gait, carry["time"])
        return dt, rK, vK

    def post(gait, carry, dt, sol):
        vel, p = carry["vel"], carry["p"]
        rigid, qint = carry["rigid"], carry["qint"]
        time = carry["time"]
        uinf = -rigid[0:3] if fix_frame else uinf_const
        # shape kinematics + rasterization from the PRE-update rigid state
        # (host order: CreateObstacles runs before UpdateObstacles)
        mid, qint_new = midline_from_frenet_device(gait, sol, dt, qint)
        pos = rigid[6:9]
        rot = quat_to_rot_dev(rigid[15:19])
        sdf, udef = _raster_window_dense(pos, rot, mid, half_win, hw,
                                             grid_shape, window_shape)
        chi = towers_chi(grid.pad_scalar(sdf, 1), grid.h)
        udef = udef * (chi > 0)[..., None]
        vel = advect(vel, dt, uinf)
        # chi-weighted fluid momenta -> 6-DOF rigid update, on the device
        mom = pack_moments(
            momentum_integrals_core(xc, h3, chi, vel, rigid[12:15]))
        out = rigid_update_device(mom, rigid, forced_mask, block_mask,
                                  uinf, dt)
        rigid_new = out[:RIGID_STATE]
        ut, om, cm = out[0:3], out[3:6], out[12:15]
        # penalization toward the updated body velocity field
        ubody = s.ubody(udef, cm, ut, om)
        lam = dlm / dt if dlm > 0 else lam_static
        vel_old = vel
        vel = penalize(vel, chi, ubody, lam, dt)
        PF = -per_obstacle_penalization_force(
            vel, vel_old, (chi,), dt, h3, xc, cm[None])[0]
        # projection, warm-started from the carried pressure
        vel, p, stats = _project(grid, vel, dt, solver, chi, udef, p,
                                 no_stats)
        # surface-probe force QoI around the updated position
        idx0f = torch.minimum(torch.clamp_min(
            torch.floor((out[6:9] - half_probe) / hw).to(torch.long), 0),
            lim_probe)
        F = pack_forces(_uniform_window_probe(
            vel, p, chi, sdf, udef, idx0f, hw, nu, cm, ut, om,
            wcells=wp, max_points=budget))
        # umax with the PRE-update uinf, as the per-step emit point
        umax_new = torch.maximum(max_velocity(vel, uinf),
                                 torch.max(torch.abs(udef)))
        time_new = time + dt
        carry_new = {
            "vel": vel, "p": p, "chi": chi, "udef": udef,
            "rigid": rigid_new, "qint": qint_new,
            "umax": umax_new, "time": time_new, "dt": dt,
        }
        row = torch.cat([out, PF.reshape(-1), F, stats, qint_new,
                         umax_new.reshape(1), dt.reshape(1),
                         time_new.reshape(1)])
        return carry_new, row

    return pre, post


def make_fish_step(s, ob, slabs=None):
    """The single-StefanFish step as a function ``one_step(gait, carry,
    cfl_eff) -> (carry', row (FISH_ROW,))``.  Geometry is frozen at
    build time: the rasterization window, the probe window and its slot
    budget, the forced/blocked masks.  The frozen gait is an argument.
    With ``slabs`` = D (make_fish_step_sharded) RK3 runs on D x-slabs;
    the body phases see the gathered field."""
    from cup3d_tpu_torch.models.fish.device_midline import _frenet_scan_dev

    pre, post = _fish_step_parts(s, ob, slabs)

    def one_step(gait, carry, cfl_eff):
        dt, rK, vK = pre(gait, carry, cfl_eff)
        return post(gait, carry, dt, _frenet_scan_dev(gait["rs"], rK, vK))

    return one_step


def make_fish_lanes_step(s, ob):
    """:func:`make_fish_step` for L fish lanes at once: every carry leaf
    and every gait leaf has a leading lane axis (the frozen gaits stacked
    by fleet/batch.stack_gaits), ``cfl_eff`` is (L,), the rows (L,
    FISH_ROW).  The step's body runs over the lane axis in batched calls
    (``torch.func.vmap``: per-lane FFTs, reductions and windows, each
    lane's rasterization and probe window at its own position, gathered
    and scattered by index) and the Frenet kernel launches once for all
    lanes' midlines.  No operation reduces across lanes."""
    from cup3d_tpu_torch.models.fish.device_midline import _frenet_scan_dev

    pre, post = _fish_step_parts(s, ob)
    vpre, vpost = torch.func.vmap(pre), torch.func.vmap(post)

    def step(gaits, carry, cfl_eff):
        dt, rK, vK = vpre(gaits, carry, cfl_eff)
        sol = _frenet_scan_dev(gaits["rs"].contiguous(), rK.contiguous(),
                               vK.contiguous())
        return vpost(gaits, carry, dt, sol)

    return step


def make_tgv_lanes_step(s):
    """:func:`make_tgv_step` for L lanes at once: carry leaves (L, ...),
    ``cfl_eff`` (L,), rows (L, TGV_ROW); the spectral solve and every
    reduction per lane (``torch.func.vmap`` over the lane axis)."""
    return torch.func.vmap(make_tgv_step(s))


def build_fish_megaloop(s, ob):
    """(carry, cfl_eff (K,)) -> (carry', rows (K, FISH_ROW)) for the
    single-StefanFish uniform pipeline; None when the gait is not
    freezable (device_midline.freeze_gait)."""
    from cup3d_tpu_torch.models.fish.device_midline import freeze_gait

    gait = freeze_gait(ob, s.time, s.dtype, s.device)
    if gait is None:
        return None
    one_step = make_fish_step(s, ob)
    return _megaloop(lambda c, x: one_step(gait, c, x))


# -- the x-slab sharded megaloop ---------------------------------------------


def _slab_specs(keys, axis="x"):
    """The carry's layout on the slab mesh: the field leaves
    (topology.FIELD_KEYS) cut into x-slabs over ``axis``, every other
    leaf whole on every shard (None); the JAX package's shard_map
    specs."""
    from cup3d_tpu_torch.parallel.topology import FIELD_KEYS

    return {k: (axis if k in FIELD_KEYS else None) for k in keys}


def _slab_count(s, mesh, axis):
    """D, the mesh's x-slabs, when the grid cuts into them (nx % D == 0,
    slabs of >= GHOSTS planes); else a warning, one
    ``topology.megaloop_mesh_fallbacks`` and None (the solo megaloop)."""
    import warnings

    from cup3d_tpu_torch.obs import metrics as M
    from cup3d_tpu_torch.parallel import topology as topo

    D = topo.mesh_axis_size(mesh, axis)
    nx = s.grid.shape[0]
    if nx % D or nx // D < GHOSTS:
        warnings.warn(
            f"{D} x-shards cannot slab nx={nx} (need even slabs of >= "
            f"{GHOSTS} planes for the one-hop ring halo): megaloop runs "
            f"unsharded", stacklevel=3)
        M.counter("topology.megaloop_mesh_fallbacks").inc()
        return None
    return D


def _sharded_megaloop(one_step, keys, D, axis):
    specs = _slab_specs(keys, axis)
    loop = _megaloop(one_step)

    def megaloop(carry, cfl_eff):
        for k, ax in specs.items():
            if ax is not None and carry[k].shape[0] % D:
                raise ValueError(f"carry field {k!r} does not cut into "
                                 f"{D} x-slabs")
        return loop(carry, cfl_eff)

    return megaloop


def make_tgv_step_sharded(s, mesh, axis="x"):
    """The obstacle-free step on the mesh's ``axis`` x-slabs (make_tgv_step
    with ``slabs``)."""
    from cup3d_tpu_torch.parallel import topology as topo

    return make_tgv_step(s, slabs=topo.mesh_axis_size(mesh, axis))


def build_tgv_megaloop_sharded(s, mesh, axis="x"):
    """(carry, cfl_eff (K,)) -> (carry', rows (K, TGV_ROW)) on the mesh's
    ``axis`` x-slabs, the carry in its global shape.  None, as in the JAX
    package, for a solver that advertises stats (the iterative ones keep
    the solo path) and, loudly, for a grid that does not cut into the
    slabs."""
    if getattr(s.poisson_solver, "supports_stats", False):
        return None
    D = _slab_count(s, mesh, axis)
    if D is None:
        return None
    return _sharded_megaloop(make_tgv_step_sharded(s, mesh, axis),
                             ("vel", "p", "umax", "time", "dt"), D, axis)


def make_fish_step_sharded(s, ob, mesh, axis="x"):
    """The single-StefanFish step on the mesh's ``axis`` x-slabs
    (make_fish_step with ``slabs``)."""
    from cup3d_tpu_torch.parallel import topology as topo

    return make_fish_step(s, ob, slabs=topo.mesh_axis_size(mesh, axis))


def build_fish_megaloop_sharded(s, ob, mesh, axis="x"):
    """(carry, cfl_eff (K,)) -> (carry', rows (K, FISH_ROW)) on the mesh's
    ``axis`` x-slabs.  None when the gait is not freezable, the solver
    advertises stats, or (loudly) the grid does not cut into the
    slabs."""
    from cup3d_tpu_torch.models.fish.device_midline import freeze_gait

    gait = freeze_gait(ob, s.time, s.dtype, s.device)
    if gait is None:
        return None
    if getattr(s.poisson_solver, "supports_stats", False):
        return None
    D = _slab_count(s, mesh, axis)
    if D is None:
        return None
    one_step = make_fish_step_sharded(s, ob, mesh, axis)
    return _sharded_megaloop(
        lambda c, x: one_step(gait, c, x),
        ("vel", "p", "chi", "udef", "rigid", "qint", "umax", "time", "dt"),
        D, axis)
