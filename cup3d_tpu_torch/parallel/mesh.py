"""Meshes of shards on one device, and the shard layout of a uniform
field (port of ``cup3d_tpu/parallel/mesh.py``).

The JAX package shards a uniform field ``(nx, ny, nz[, 3])`` over a 2-D
device ``Mesh("x", "y")`` and lets XLA's partitioner derive the halo
exchange.  The port keeps the shards of a mesh on ONE device, as the
block-sharded forest does (parallel/forest.BlockMesh): a :class:`Mesh`
is an array of device entries, one per shard, all the same device, and
"sharding" a field is viewing it with its shard axes leading
(:func:`shard_field`), so one launch covers every shard.  Shards on
distinct devices raise: transport between cards is ROADMAP A7's
multi-card step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _factor2(n: int,
             divide: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """n -> (a, b), a*b = n, as square as possible, a >= b.

    With ``divide`` = (nx, ny) block counts, only factorizations whose
    axes divide them evenly qualify (either orientation; the squarest
    wins), and a count with no such split raises: a mesh axis that cannot
    cut its grid axis would leave that axis unsharded without a word."""
    if n <= 0:
        raise ValueError(f"cannot factor a mesh over {n} devices")
    pairs = []
    for b in range(int(np.floor(np.sqrt(n))), 0, -1):
        if n % b == 0:
            pairs.append((n // b, b))
    if divide is None:
        return pairs[0]
    for a, b in pairs:
        if divide[0] % a == 0 and divide[1] % b == 0:
            return a, b
        if divide[0] % b == 0 and divide[1] % a == 0:
            return b, a
    raise ValueError(
        f"{n} devices admit no 2-D mesh whose axes divide the "
        f"(x, y) block counts {divide}: factor pairs "
        f"{pairs} all leave a ragged axis"
    )


def visible_devices() -> list:
    """Every visible CUDA device; raises without a GPU (pass the shards'
    devices, e.g. ``[torch.device("cpu")] * 8``, to run on the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device; pass the shards' devices (e.g. "
            "[torch.device('cpu')] * 8) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def _one_device(devices: Sequence) -> list:
    """The entries as torch devices (a bare "cuda" pinned to the current
    card); entries on distinct devices raise."""
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"mesh shards on distinct devices {sorted(set(map(str, devs)))}: "
            "transport between cards is ROADMAP A7's multi-card step; the "
            "port runs every shard of a mesh on one device")
    return devs


@dataclass(frozen=True)
class Mesh:
    """A named N-D array of shard entries, all on one device (the JAX
    ``Mesh``'s ``devices`` / ``axis_names`` / ``shape`` surface)."""

    devices: np.ndarray  # object array of torch.device, one per shard
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        return self.devices.flat[0]


def mesh_of(devices: Sequence, shape: Tuple[int, ...],
            axis_names: Tuple[str, ...]) -> Mesh:
    """The :class:`Mesh` of ``devices`` (one entry a shard) laid out as
    ``shape``."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = _one_device(devices)
    return Mesh(arr.reshape(shape), tuple(axis_names))


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("x", "y"),
              divide: Optional[Tuple[int, int]] = None) -> Mesh:
    """2-D mesh over ``devices`` (one entry a shard; default every
    visible CUDA device), shaped near-square by :func:`_factor2` unless
    ``shape`` is given.  ``divide`` = (nx, ny) grid extents (cells or
    blocks) the axes must divide evenly: a shard count with no such
    split raises."""
    if devices is None:
        devices = visible_devices()
    if shape is None:
        shape = _factor2(len(devices), divide)
    return mesh_of(list(devices), tuple(shape), axis_names)


@dataclass(frozen=True)
class FieldLayout:
    """How a field lies on a mesh: the mesh axis each leading field axis
    is cut over (None: whole on every shard), the port's PartitionSpec."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def field_sharding(mesh: Mesh) -> FieldLayout:
    """(nx, ny, nz, 3) vector field: x and y cut, z and c whole."""
    return FieldLayout(mesh, tuple(mesh.axis_names) + (None, None))


def scalar_sharding(mesh: Mesh) -> FieldLayout:
    """(nx, ny, nz) scalar field: x and y cut."""
    return FieldLayout(mesh, tuple(mesh.axis_names) + (None,))


def shard_field(arr: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A field on the mesh's device, viewed by shard: (nx, ny, ...) ->
    (a, b, nx/a, ny/b, ...) for an (a, b) mesh, entry [i, j] the shard
    (i, j)'s block (a strided view; no copy when the field already lies
    on that device).  The mesh axes must divide the field's."""
    lay = field_sharding(mesh) if arr.ndim == 4 else scalar_sharding(mesh)
    cut = [mesh.shape[a] for a in lay.spec if a is not None]
    arr = torch.as_tensor(arr).to(mesh.device)
    shape = tuple(arr.shape)
    if any(shape[i] % n for i, n in enumerate(cut)):
        raise ValueError(f"mesh {mesh.shape} does not divide field axes "
                         f"{shape[:len(cut)]}")
    split = []
    for i, n in enumerate(cut):
        split += [n, shape[i] // n]
    v = arr.reshape(tuple(split) + shape[len(cut):])
    k = len(cut)
    order = [2 * i for i in range(k)] + [2 * i + 1 for i in range(k)]
    return v.permute(order + list(range(2 * k, v.ndim)))
