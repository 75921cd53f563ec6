"""The 2-D (lanes x space) mesh factory and the megaloop's slab mesh
(port of ``cup3d_tpu/parallel/topology.py``).

- :func:`make_mesh2d` -- the canonical ``("lanes", "x")``
  :class:`~cup3d_tpu_torch.parallel.mesh.Mesh` over a deterministic
  shard order, shaped by explicit arguments, ``CUP3D_MESH="LxX"`` or the
  ``(entries, 1)`` default; a shape that does not multiply out raises.
- :func:`placement_map` / :func:`mesh_state` -- the shard -> device
  table (row-major over the mesh array) and the JSON-able state.
- :func:`megaloop_mesh` -- ``CUP3D_MESH_X=D`` asks the uniform megaloop
  for a ``(1, D)`` mesh of x-slabs (sim/megaloop.py's sharded bodies).
- :func:`shard_carry` -- a megaloop carry placed for the slab mesh.
- :func:`dist_init` / :func:`dist_state` -- the single-process states
  of the JAX package's ``jax.distributed`` bring-up.

On one card the mesh's entries are SHARDS of one device, as the
block-sharded forest's (parallel/forest.BlockMesh): the D slabs are a
leading axis of one tensor and one launch covers them all, with the
x-halos carried by kernel B14 (parallel/ring.pad_slab_vector).  So D is
bounded by the grid, not by a device count: ``nx % D == 0`` and slabs of
at least the three ghost planes the upwind stencil reads (the sharded
builders fall back to the solo megaloop, loudly, otherwise).  Shards on
distinct devices, and a multi-process ``CUP3D_DIST``, raise: transport
between cards is ROADMAP A7's multi-card step.  The fleet's batch mesh
(``fleet_mesh2d``, ``CUP3D_FLEET_MESH=1``), its lanes cut into shards
across cards, is ROADMAP A8b.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cup3d_tpu_torch.parallel.mesh import Mesh, mesh_of, visible_devices

__all__ = [
    "dist_init",
    "dist_state",
    "device_order",
    "make_mesh2d",
    "mesh_axis_size",
    "placement_map",
    "mesh_state",
    "megaloop_mesh",
    "shard_carry",
]

#: mesh axis names, in array order: leading = scenario lanes, trailing =
#: the x slab axis of the spatial domain decomposition
LANE_AXIS = "lanes"
X_AXIS = "x"

#: the last dist_init outcome
_DIST = {"mode": "off", "initialized": False, "error": None,
         "processes": 1, "rank": 0}


def dist_state() -> dict:
    """A copy of the last :func:`dist_init` outcome."""
    return dict(_DIST)


def dist_init(spec: Optional[str] = None) -> dict:
    """The process topology per ``CUP3D_DIST`` (``spec`` overrides it):
    ``0`` / ``off`` / empty (the default) is one process; ``auto`` with
    ``CUP3D_DIST_NPROCS`` <= 1 is one process too.  More than one
    process (``auto`` with a larger count, or ``host:port``) raises
    NotImplementedError: a process a card is ROADMAP A7's multi-card
    step."""
    if spec is None:
        spec = os.environ.get("CUP3D_DIST", "0")
    spec = spec.strip().lower()
    if spec in ("", "0", "off", "false", "no"):
        _DIST.update(mode="off", initialized=False, error=None,
                     processes=1, rank=0)
        return dist_state()
    nprocs = int(os.environ.get("CUP3D_DIST_NPROCS", "1"))
    if spec == "auto" and nprocs <= 1:
        _DIST.update(mode="single", initialized=False, error=None,
                     processes=1, rank=0)
        return dist_state()
    raise NotImplementedError(
        f"CUP3D_DIST={spec!r} with {nprocs} processes: a process a card "
        "(torch.distributed) is ROADMAP A7's multi-card step; the port "
        "runs one process on one device")


def _index(d: torch.device) -> int:
    return 0 if d.index is None else int(d.index)


def device_order(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The canonical shard order every mesh here is built from: sorted
    by (process, device index), stable, so equal entries keep their
    order.  ``None``: every visible CUDA device."""
    if devices is None:
        devices = visible_devices()
    return sorted((torch.device(d) for d in devices),
                  key=lambda d: (0, _index(d)))


def _parse_mesh_env() -> Optional[Tuple[int, int]]:
    """``CUP3D_MESH="LxX"`` -> (lanes, x); None when unset, ``auto`` or
    malformed."""
    v = os.environ.get("CUP3D_MESH", "").strip().lower()
    if not v or v == "auto":
        return None
    try:
        lanes_s, x_s = v.split("x", 1)
        return max(1, int(lanes_s)), max(1, int(x_s))
    except ValueError:
        return None


def make_mesh2d(lanes: Optional[int] = None, x: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """The ``("lanes", "x")`` mesh over the canonical order of
    ``devices`` (one entry a shard).  Shape: the explicit arguments, then
    ``CUP3D_MESH="LxX"``, then ``(entries, 1)``; one axis given derives
    the other (the entry count must divide); a shape that does not
    multiply out to the entry count raises."""
    devs = device_order(devices)
    nd = len(devs)
    if lanes is None and x is None:
        env = _parse_mesh_env()
        if env is not None:
            lanes, x = env
    if lanes is None and x is None:
        lanes, x = nd, 1
    elif lanes is None:
        if nd % x:
            raise ValueError(
                f"{nd} shards do not factor over x={x}: pick an x axis "
                f"dividing the shard count")
        lanes = nd // x
    elif x is None:
        if nd % lanes:
            raise ValueError(f"{nd} shards do not factor over lanes={lanes}")
        x = nd // lanes
    if lanes * x != nd:
        raise ValueError(
            f"mesh shape ({lanes} lanes x {x}) needs {lanes * x} shards, "
            f"{nd} given: fix CUP3D_MESH or the shard list")
    return mesh_of(devs, (lanes, x), (LANE_AXIS, X_AXIS))


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    """Size of one named mesh axis (1 for a name the mesh lacks)."""
    return int(mesh.shape.get(axis, 1))


def placement_map(mesh: Mesh) -> List[dict]:
    """The lane-shard/x-shard -> device table, row-major over the mesh
    array: a pure function of the shard list."""
    shape = mesh.devices.shape
    out = []
    for flat, dev in enumerate(mesh.devices.flat):
        coords = [0] * len(shape)
        rem = flat
        for i in range(len(shape) - 1, -1, -1):
            coords[i] = rem % shape[i]
            rem //= shape[i]
        out.append({
            "lane_shard": int(coords[0]),
            "x_shard": int(coords[-1]) if len(shape) > 1 else 0,
            "device_id": _index(dev),
            "process": 0,
            "platform": dev.type,
        })
    return out


def mesh_state(mesh: Optional[Mesh], fallbacks: int = 0) -> dict:
    """JSON-able mesh state (a health payload's mesh section)."""
    if mesh is None:
        return {"active": False, "axes": [], "shape": [], "devices": 0,
                "fallbacks": int(fallbacks), "dist": dist_state()}
    return {
        "active": True,
        "axes": list(mesh.axis_names),
        "shape": [int(v) for v in mesh.devices.shape],
        "devices": int(mesh.devices.size),
        "fallbacks": int(fallbacks),
        "placement": placement_map(mesh),
        "dist": dist_state(),
    }


def megaloop_mesh(device=None) -> Optional[Mesh]:
    """The solo megaloop's slab mesh: ``CUP3D_MESH_X=D`` gives a (1, D)
    mesh of D x-slabs of ``device`` (the driver's; None: the current
    card).  None when unset, malformed or below 2.  Whether the grid can
    be cut into D slabs is the sharded builders' check."""
    v = os.environ.get("CUP3D_MESH_X", "").strip()
    if not v:
        return None
    try:
        want = int(v)
    except ValueError:
        want = 0
    if want < 2:
        return None
    dist_init()
    if device is None:
        device = torch.device("cuda")
    return make_mesh2d(lanes=1, x=want, devices=[device] * want)


#: megaloop carry keys laid out (nx, ny, nz[, 3]) and cut into x-slabs;
#: every other key (umax/time/dt/rigid/qint) is whole on every shard
FIELD_KEYS = frozenset({"vel", "p", "chi", "udef"})


def shard_carry(carry: Dict[str, torch.Tensor], mesh: Mesh,
                axis: str = X_AXIS) -> Dict[str, torch.Tensor]:
    """A megaloop carry placed for the slab mesh: every leaf on the
    mesh's device, the field leaves in their global layout (the sharded
    step views them as (D, nx/D, ...) slabs), checked to cut evenly
    along x."""
    D = mesh_axis_size(mesh, axis)
    out = {}
    for k, v in carry.items():
        if k in FIELD_KEYS and v.shape[0] % D:
            raise ValueError(f"carry field {k!r} of {v.shape[0]} x-planes "
                             f"does not cut into {D} slabs")
        out[k] = v.to(mesh.device)
    return out
