"""Field output: XDMF2 + raw-binary snapshots (port of
``cup3d_tpu/io/dump.py``; reference dump(), main.cpp:429-553) for both
layouts, byte for byte the JAX package's files.

The format is the reference's, so its ``tool/post.py`` reader works on
this output:

- ``{prefix}.xyz.raw``   — float32, 8 hexahedron vertices x 3 coords per
  cell (vertex order: the reference's low-x face counterclockwise then
  high-x face, main.cpp:506-537);
- ``{prefix}.{name}.attr.raw`` — float32 cell value, same cell order;
- ``{prefix}.{name}.xdmf2``    — XDMF2 XML with exactly two Binary
  DataItems (geometry + attribute), the shape post.py expects
  (tool/post.py:18-31).

``dump_fields`` is the single-writer version; the drivers write through
``stream/dump.py``, the sharded multi-writer that produces the same
bytes off the step loop.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

# reference vertex ordering (main.cpp:506-537): (u0,v0,w0) (u0,v0,w1)
# (u0,v1,w1) (u0,v1,w0) (u1,v0,w0) (u1,v0,w1) (u1,v1,w1) (u1,v1,w0)
_CORNERS = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
        [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0],
    ],
    np.float32,
)

_XDMF = """<Xdmf
    Version="2.0">
  <Domain>
    <Grid>
      <Time Value="{time:.16e}"/>
      <Topology
          Dimensions="{ncell}"
          TopologyType="Hexahedron"/>
     <Geometry>
       <DataItem
           Dimensions="{nvert} 3"
           Format="Binary">
         {xyz}
       </DataItem>
     </Geometry>
       <Attribute
           Name="{name}"
           Center="Cell">
         <DataItem
             Dimensions="{ncell}"
             Format="Binary">
           {attr}
         </DataItem>
       </Attribute>
    </Grid>
  </Domain>
</Xdmf>
"""


def _write_geometry(path: str, origin: np.ndarray, h: np.ndarray) -> int:
    """origin: (ncell, 3) low corner of every cell; h: (ncell,) spacing.
    Writes 8 float32 vertices per cell; returns ncell."""
    ncell = origin.shape[0]
    xyz = (
        origin[:, None, :] + _CORNERS[None, :, :] * h[:, None, None]
    ).astype(np.float32)
    xyz.tofile(path)
    return ncell


def _cell_geometry_blocks(grid) -> Tuple[np.ndarray, np.ndarray]:
    """BlockGrid -> per-cell (low corner, spacing), block-major, the same
    raveling order as field.reshape(nb, -1)."""
    bs = grid.bs
    loc = np.stack(
        np.meshgrid(*[np.arange(bs)] * 3, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    origin = (
        grid.origin[:, None, :] + loc[None] * grid.h[:, None, None]
    ).reshape(-1, 3)
    h = np.repeat(grid.h, bs**3)
    return origin, h


def _cell_geometry_uniform(grid) -> Tuple[np.ndarray, np.ndarray]:
    idx = np.stack(
        np.meshgrid(*[np.arange(n) for n in grid.shape], indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    origin = idx * grid.h
    h = np.full(origin.shape[0], grid.h)
    return origin, h


def cell_geometry(grid) -> Tuple[np.ndarray, np.ndarray]:
    """grid -> per-cell (low corner (n,3), spacing (n,)), block-major for
    a BlockGrid, C-order for a UniformGrid."""
    if hasattr(grid, "shape"):  # uniform
        return _cell_geometry_uniform(grid)
    return _cell_geometry_blocks(grid)


def dump_fields(
    prefix: str,
    time: float,
    grid,
    fields: Dict[str, np.ndarray],
) -> None:
    """Write one geometry file + one (attr, xdmf2) pair per field.

    grid: UniformGrid or BlockGrid; each field is any array whose size is
    the grid's cell count (raveled C-order)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    origin, h = cell_geometry(grid)
    xyz_path = f"{prefix}.xyz.raw"
    ncell = _write_geometry(xyz_path, origin, h)
    for name, arr in fields.items():
        a = np.asarray(arr, np.float32).reshape(-1)
        if a.size != ncell:
            raise ValueError(
                f"field {name}: {a.size} values vs {ncell} cells"
            )
        attr_path = f"{prefix}.{name}.attr.raw"
        a.tofile(attr_path)
        with open(f"{prefix}.{name}.xdmf2", "w") as f:
            f.write(
                _XDMF.format(
                    time=time,
                    ncell=ncell,
                    nvert=8 * ncell,
                    name=name,
                    xyz=os.path.basename(xyz_path),
                    attr=os.path.basename(attr_path),
                )
            )


class OutputCadence:
    """tdump/fdump dump + saveFreq checkpoint scheduling, shared by both
    drivers (reference advance() dump-by-time, main.cpp:15307-15313).

    ``next_dump`` always advances to the next tdump multiple *above* the
    current time, so a step with dt > tdump (or a restored run) never
    triggers a catch-up burst of one dump per step."""

    def __init__(self, tdump: float, fdump: int, save_freq: int):
        self.tdump = tdump
        self.fdump = fdump
        self.save_freq = save_freq
        self.next_dump = 0.0

    def dump_due(self, time: float, step: int) -> bool:
        due = False
        if self.tdump > 0 and time >= self.next_dump - 1e-12:
            due = True
            # advance past `time` with the same epsilon as the trigger, so
            # one crossed boundary can never fire twice
            while time >= self.next_dump - 1e-12:
                self.next_dump += self.tdump
        if self.fdump > 0 and step % self.fdump == 0:
            due = True
        return due

    def save_due(self, step: int) -> bool:
        return self.save_freq > 0 and step > 0 and step % self.save_freq == 0


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def collect_dump_fields(cfg, state, omega_fn=None) -> Dict[str, np.ndarray]:
    """Assemble the dump dict from the dumpChi/dumpVelocity/dumpOmega flags
    (shared by both drivers; omega_fn: vel -> |curl u| on that layout),
    read to the host."""
    fields: Dict[str, np.ndarray] = {}
    if cfg.dumpChi:
        fields["chi"] = _host(state["chi"])
    if cfg.dumpVelocity:
        v = _host(state["vel"])
        fields.update(velx=v[..., 0], vely=v[..., 1], velz=v[..., 2])
    if cfg.dumpOmega and omega_fn is not None:
        fields["omega"] = _host(omega_fn(state["vel"]))
    return fields


def collect_dump_fields_device(cfg, state, omega_fn=None) -> Dict[str, object]:
    """Device twin of ``collect_dump_fields``: the same flag logic, every
    value a device tensor (component slices and |curl u| are device ops),
    so the drivers hand the set to the staged dump
    (stream/dump.AsyncDumper) without a blocking host read."""
    fields: Dict[str, object] = {}
    if cfg.dumpChi:
        fields["chi"] = state["chi"]
    if cfg.dumpVelocity:
        v = state["vel"]
        fields.update(velx=v[..., 0], vely=v[..., 1], velz=v[..., 2])
    if cfg.dumpOmega and omega_fn is not None:
        fields["omega"] = omega_fn(state["vel"])
    return fields


def read_dump(xdmf_path: str):
    """post.py-style reader: (cell centers (n,3), attr (n,)) from an
    .xdmf2 file (tool/post.py:16-31 logic)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(xdmf_path).getroot()
    xyz_item, attr_item = root.findall('.//DataItem[@Format="Binary"]')
    d = os.path.dirname(xdmf_path)
    xyz = np.fromfile(
        os.path.join(d, xyz_item.text.strip()), np.float32
    ).reshape(-1, 8, 3)
    centers = 0.5 * (xyz[:, 0, :] + xyz[:, 6, :])
    attr = np.fromfile(os.path.join(d, attr_item.text.strip()), np.float32)
    return centers, attr
