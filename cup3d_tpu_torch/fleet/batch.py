"""Lane batching: one dispatch advances L scenarios K steps (port of
``cup3d_tpu/fleet/batch.py``).

The JAX package lays a leading ``lane`` axis over the megaloop's scan
body with ``jax.vmap``.  Here the lane axis is a leading tensor axis of
every carry leaf, and the step bodies take it directly
(sim/megaloop.make_tgv_lanes_step, make_fish_lanes_step,
sim/amr.make_amr_tgv_lanes_step): each operation of the step runs once
for all lanes (``torch.func.vmap`` over the pure parts, the Frenet
kernel with a lane count in its grid, the forest's fused Krylov kernels
over the lanes' stacked blocks), and nothing reduces across lanes.

- the batched carry stacks vel/p (chi/udef, the 6-DOF rigid vector and
  the internal quaternion for fish) per lane, so every lane owns its
  state;
- the (umax, time, dt) chain is (L,): each lane runs its own dt policy
  (stale-umax CFL bound + the 1.03x growth limiter);
- the frozen gaits are stacked into one (L,)-leading pytree
  (:func:`stack_gaits`), so lanes in one batch swim different gaits;
- a per-lane integer ``left`` budget gates the step: a lane with
  ``left == 0`` (finished, retired, padding) recomputes the step and
  keeps its old carry through a lane-wise ``torch.where``, which keeps
  its bits exactly (the isolation contract, fleet/isolate.py).

The carry is never written in place: reseeds and rollbacks return new
tensors, so a carry the QoI stream or a rollback snapshot still holds
stays valid (the JAX package's non-donated carry).

:func:`abstract_advance_args` gives the batched advance's argument
shapes as ``torch.device("meta")`` tensors, from one lane's payload (the
JAX package's avals): ``aot warm`` sizes each group's batch from them
without touching device memory.  The fleet mesh
(``CUP3D_FLEET_MESH=1``, a batch's lanes cut into shards across cards)
is ROADMAP A8b.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cup3d_tpu_torch.models.base import upload
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.sim.megaloop import (  # noqa: F401  (rows re-exported)
    FISH_ROW,
    TGV_ROW,
    init_fish_carry,
    init_tgv_carry,
    make_fish_lanes_step,
    make_tgv_lanes_step,
)

#: carry key holding the per-lane remaining-step budget (int32, (L,))
LEFT = "left"


def init_amr_carry(s):
    """Obstacle-free bucketed-forest lane carry: the (cap, 8, 8, 8) padded
    vel/p forest plus the (umax, time, dt) chain, the keys of
    init_tgv_carry.  umax is max |vel + uinf| over the padded forest
    (padding rows are zero and never win the max)."""
    vel = s.state["vel"]
    return {
        "vel": vel,
        "p": s.state["p"],
        "umax": torch.max(torch.abs(vel + s.uinf_device())),
        "time": upload(np.asarray(s.time, np.float64), s.dtype, s.device),
        "dt": upload(np.asarray(s.dt, np.float64), s.dtype, s.device),
    }


def stack_gaits(gaits, dtype, device=None):
    """Per-lane frozen-gait dicts -> one batched pytree (leading lane
    axis): float leaves become (L,) tensors, array leaves must share
    their shape across lanes (mixed midline discretizations belong in
    different buckets: the server keys assembly on the static
    signature)."""
    keys = sorted(gaits[0])
    for g in gaits:
        if sorted(g) != keys:
            raise ValueError("lane gaits disagree on parameter set")
    if device is None:
        device = next(v.device for v in gaits[0].values()
                      if isinstance(v, torch.Tensor))
    out = {}
    for k in keys:
        leaves = [torch.as_tensor(np.asarray(g[k], np.float64)
                                  if not isinstance(g[k], torch.Tensor)
                                  else g[k]).to(device=device, dtype=dtype)
                  for g in gaits]
        shapes = {tuple(leaf.shape) for leaf in leaves}
        if len(shapes) != 1:
            raise ValueError(
                f"gait leaf {k!r} varies in shape across lanes: {shapes}")
        out[k] = torch.stack(leaves)
    return out


def stack_carries(carries, targets):
    """Stack per-lane solo carries (init_*_carry outputs) into one batched
    carry with the per-lane ``left`` budget.  ``targets[l] <= 0`` marks
    lane l as padding: a clone the gated step freezes from step 0."""
    keys = sorted(carries[0])
    for c in carries:
        if sorted(c) != keys:
            raise ValueError("lane carries disagree on state set")
    out = {k: torch.stack([c[k] for c in carries]) for k in keys}
    dev = out[keys[0]].device
    out[LEFT] = torch.as_tensor(np.maximum(np.asarray(targets, np.int64), 0)
                                .astype(np.int32), device=dev)
    return out


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def abstract_advance_args(carry, gait, B, K, dtype):
    """The arguments of one batched advance call as meta tensors (shapes
    and dtypes, no data): exactly what :func:`stack_carries`, the
    server's ``_cfl_block`` and :func:`stack_gaits` produce for ``B``
    lanes and ``K`` steps, from a SINGLE lane's solo (carry, gait)
    payload (tensors or numpy arrays).  No device memory is touched (the
    JAX package's ``jax.ShapeDtypeStruct`` avals).  Returns
    ``(carry, cfl, gaits_or_None)``."""
    meta = torch.device("meta")

    def batched(v):
        if isinstance(v, torch.Tensor):
            shape, dt = tuple(v.shape), v.dtype
        else:
            arr = np.asarray(v)
            shape, dt = arr.shape, _torch_dtype(arr.dtype)
        return torch.empty((int(B),) + tuple(shape), dtype=dt, device=meta)

    fdt = _torch_dtype(dtype)
    carry_avals = {k: batched(v) for k, v in carry.items()}
    carry_avals[LEFT] = torch.empty((int(B),), dtype=torch.int32, device=meta)
    cfl = torch.empty((int(B), int(K)), dtype=fdt, device=meta)
    gaits = None
    if gait is not None:
        # stack_gaits casts every leaf to the sim dtype and stacks it
        # along a new lane axis (floats become (B,) rows)
        gaits = {k: torch.empty((int(B),) + tuple(
            v.shape if isinstance(v, torch.Tensor) else np.shape(v)),
            dtype=fdt, device=meta) for k, v in gait.items()}
    return carry_avals, cfl, gaits


def _lane_mask(act, v):
    """(L,) lane mask shaped to broadcast over ``v``'s trailing axes."""
    return act.reshape((-1,) + (1,) * (v.dim() - 1))


def _gated(step, has_gait, takes_live=False):
    """The lane step with the per-lane freeze gate: a lane with
    ``left == 0`` recomputes the step and keeps its old carry through a
    lane-wise select (bit-exact freezing); its rows are replays the
    consumer drops by budget.  ``takes_live``: the step also gets the
    gate's mask (``live=``), so that its Krylov solve does not iterate
    for the frozen lanes (the forest body)."""

    def body(gaits, carry, cfl_eff):
        left = carry[LEFT]
        act = left > 0
        inner = {k: v for k, v in carry.items() if k != LEFT}
        if has_gait:
            new, rows = step(gaits, inner, cfl_eff)
        elif takes_live:
            new, rows = step(inner, cfl_eff, live=act)
        else:
            new, rows = step(inner, cfl_eff)
        merged = {k: torch.where(_lane_mask(act, new[k]), new[k], inner[k])
                  for k in inner}
        merged[LEFT] = left - act.to(left.dtype)
        return merged, rows

    return body


def _row_write(v, lane: int, row):
    """A new tensor: ``v`` with lane row ``lane`` replaced by ``row``
    (out of place; every other lane's bits untouched)."""
    idx = torch.tensor([int(lane)], device=v.device)
    return v.index_copy(0, idx, row.to(device=v.device,
                                       dtype=v.dtype).reshape(
                                           (1,) + tuple(v.shape[1:])))


def reseed_lane_carry(carry, lane, solo, nsteps):
    """Splice a solo carry into lane ``lane`` of a batched carry, with
    ``nsteps`` its ``left`` budget: the continuous-batching reseed (and
    the journal/migration resume).  The result is a new carry; the input
    is untouched, so in-flight consumers of the old tensors stay valid.
    One lane's rows are written, every other lane's bits come through.

    On the waiting job's timeline this upload sits inside its
    ``reseed_wait -> reseeded`` interval; ``fleet.reseed_uploads`` counts
    it."""
    M.counter("fleet.reseed_uploads").inc()
    out = {}
    for k, v in carry.items():
        if k == LEFT:
            out[k] = _row_write(v, lane, torch.tensor(int(nsteps)))
        else:
            out[k] = _row_write(v, lane, torch.as_tensor(
                np.asarray(solo[k]) if not isinstance(solo[k], torch.Tensor)
                else solo[k]))
    return out


def reseed_lane_gaits(gaits, lane, gait):
    """Swap one lane's row of the stacked frozen-gait pytree (fish reseed);
    None passes through for gait-free bodies.  The new gait must share
    the batch's parameter set and leaf shapes."""
    if gaits is None:
        return None
    if sorted(gait) != sorted(gaits):
        raise ValueError("reseed gait disagrees with the batch gait set")
    return {k: _row_write(gaits[k], lane, torch.as_tensor(
        np.asarray(gait[k], np.float64)
        if not isinstance(gait[k], torch.Tensor) else gait[k]))
        for k in gaits}


def lane_carry_host(carry, lane):
    """One lane's rows of a batched carry as host numpy copies (the
    journal snapshot and migration payload, the same keys, dtypes and
    shapes as the JAX package's).  The ``left`` budget is dropped:
    placement decides a resumed lane's budget."""
    return {k: v[lane].detach().cpu().numpy().copy()
            for k, v in carry.items() if k != LEFT}


#: lane-track tid stride: lane tids are ``batch_id * LANE_TID_STRIDE +
#: lane``, so concurrent batches never share a Perfetto thread track
LANE_TID_STRIDE = 4096


def lane_track_id(batch_id: int, lane: int) -> int:
    """Stable Perfetto tid of one (batch, lane) occupancy track."""
    return int(batch_id) * LANE_TID_STRIDE + int(lane)


def fleet_mesh():
    """The fleet mesh behind ``CUP3D_FLEET_MESH``: None, the unsharded
    batch.  Cutting a batch's lanes into shards across cards is ROADMAP
    A8b: asking for it raises."""
    if os.environ.get("CUP3D_FLEET_MESH", "0").lower() in (
            "1", "true", "on"):
        raise NotImplementedError(
            "CUP3D_FLEET_MESH: the fleet's lanes cut into shards across "
            "cards are ROADMAP A8b")
    return None


def build_fleet_advance(s, ob=None, kind=None):
    """``(carry_L, cfl (L, K), gaits_L) -> (carry_L', rows (L, K, ROW))``:
    L independent lanes, K steps each, one call.

    ``s`` is the bucket's template simulation (its SimulationData for the
    uniform kinds, the AMRSimulation for ``amr_tgv``), ``ob`` its
    template fish (None: obstacle-free, ``gaits`` passed as None).
    ``kind`` picks the body: "fish", "tgv" or "amr_tgv" (the bucketed
    forest body on the template's frozen padded topology, which the
    server's (capacity, topology-signature) bucket key guarantees every
    lane shares).  ``cfl`` is a host (L, K) array.  The K steps are a
    loop over steps; each step is one batched call over the lanes.  The
    carry is not written in place (see the module docstring)."""
    if kind is None:
        kind = "fish" if ob is not None else "tgv"
    has_gait = kind == "fish"
    if kind == "fish":
        step = make_fish_lanes_step(s, ob)
    elif kind == "amr_tgv":
        from cup3d_tpu_torch.sim.amr import make_amr_tgv_lanes_step

        step = make_amr_tgv_lanes_step(s)
    else:
        step = make_tgv_lanes_step(s)
    body = _gated(step, has_gait, takes_live=kind == "amr_tgv")

    def advance(carry, cfl_eff, gaits):
        dev = carry["vel"].device
        cfl = torch.as_tensor(np.asarray(cfl_eff, np.float64),
                              device=dev).to(carry["vel"].dtype)
        rows = []
        for k in range(cfl.shape[1]):
            carry, r = body(gaits, carry, cfl[:, k].contiguous())
            rows.append(r)
        return carry, torch.stack(rows, dim=1)

    return advance
