"""Uniform dense grid: the single-level fast path (port of
``cup3d_tpu/grid/uniform.py``).

Fields are dense tensors ``(nx, ny, nz[, 3])``, the JAX package's layout.
Boundary conditions mirror the reference's ``BlockLab`` family
(main.cpp:5920-6552):

- ``periodic``  — wrap.
- ``wall``      — ghost = -edge for every velocity component (no-slip),
                  ghost = edge for scalars (zero-gradient).
- ``freespace`` — ghost = -edge for the face-normal velocity component only
                  (no penetration, free slip), ghost = edge otherwise.

Scalar fields always get zero-gradient ghosts on non-periodic faces.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch


class BC(str, enum.Enum):
    periodic = "periodic"
    wall = "wall"
    freespace = "freespace"


@dataclass(frozen=True)
class UniformGrid:
    """Geometry + boundary conditions of one dense uniform level."""

    shape: Tuple[int, int, int]
    extent: Tuple[float, float, float]
    bc: Tuple[BC, BC, BC] = (BC.periodic, BC.periodic, BC.periodic)

    @property
    def h(self) -> float:
        return self.extent[0] / self.shape[0]

    @property
    def hmin(self) -> float:
        return self.h

    @property
    def spacing(self) -> Tuple[float, float, float]:
        return tuple(e / n for e, n in zip(self.extent, self.shape))

    @property
    def ncells(self) -> int:
        return int(np.prod(self.shape))

    def __post_init__(self):
        hs = [e / n for e, n in zip(self.extent, self.shape)]
        if not np.allclose(hs, hs[0], rtol=1e-12):
            raise ValueError(f"anisotropic spacing not supported: {hs}")
        object.__setattr__(self, "bc", tuple(BC(b) for b in self.bc))

    def cell_centers(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """(nx,ny,nz,3) physical coordinates of cell centers."""
        axes = [
            (torch.arange(n, dtype=dtype, device=device) + 0.5) * (e / n)
            for n, e in zip(self.shape, self.extent)
        ]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)

    # -- ghost-cell padding ------------------------------------------------

    def pad_scalar(self, f: torch.Tensor, width: int) -> torch.Tensor:
        """Pad a (nx,ny,nz) scalar with `width` ghost cells on every face."""
        return _pad(f, width, self.bc)

    def pad_vector(self, u: torch.Tensor, width: int) -> torch.Tensor:
        """Pad a (nx,ny,nz,3) velocity with BC-correct ghosts per component."""
        return torch.stack(
            [_pad(u[..., c], width, self.bc, comp=c) for c in range(3)], dim=-1
        )


def _pad(f, width, bcs: Sequence[BC], comp: int | None = None):
    """Pad the axes one after another (x, then y, then z), so corner and
    edge ghosts are built from already-padded planes exactly as the
    JAX package's sequential ``jnp.pad`` does; flip ghost signs where the
    BC and velocity component require it (after each axis).

    comp: velocity component index (None = scalar, zero-gradient ghosts).
    """
    for axis, bc in enumerate(bcs):
        n = f.shape[axis]
        if bc == BC.periodic:
            lo = f.narrow(axis, n - width, width)
            hi = f.narrow(axis, 0, width)
        else:
            lo = f.narrow(axis, 0, 1).expand_as(f.narrow(axis, 0, width))
            hi = f.narrow(axis, n - 1, 1).expand_as(lo)
            if comp is not None and (bc == BC.wall or comp == axis):
                lo, hi = -lo, -hi
        f = torch.cat([lo, f, hi], dim=axis)
    return f
