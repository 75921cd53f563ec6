"""Block-structured AMR fields: the data model + per-cell halo assembly
(port of ``cup3d_tpu/grid/blocks.py``; reference GridBlock/Grid/BlockLab,
main.cpp:815-1080, 3457-4628, 5882-5919).

Every field is one dense ``(nb, bs, bs, bs[, 3])`` tensor ordered by the
cross-level Hilbert key; all irregular topology is precomputed on the
host (numpy, copied from the JAX package's table builder) into integer
gather tables that torch consumes:

- interior: the block's own cells;
- same-level neighbor ghosts: K=1 gather rows;
- finer-neighbor ghosts: K=8 gather rows with 1/8 weights;
- coarser-neighbor ghosts: a per-block coarse scratch filled by K<=8
  gathers, upsampled by the separable quadratic (3-point Lagrange at
  +-1/4) tensor product, and selected by a precomputed mask;
- domain boundaries: periodic wrap in index space; closed faces clamp the
  source cell (zero-gradient) with per-component sign masks (wall: all
  velocity components flip; freespace: the face-normal one).

The lab has edge and corner ghosts, which the refinement prolongation of
grid/adapt.py needs; the operators use the faces-only tables of
grid/faces.py.  The two documented approximations of the JAX tables
(middle-octant sampling two levels finer, constant injection two levels
coarser) are kept, so both packages assemble the same labs.

Gather tables stay int32 on the device (``index_select`` takes them) and
every index is in range: a missing source points at the zero sentinel
appended after the flattened field.  Tables are built for the real
blocks; the bucketed forest pads them (grid/faces.py, grid/flux.py).

The per-cell tables come from the native builder (cup3d_tpu_torch/
native.py, C++ built at first use), bit-identical to the numpy builder
here, which ``CUP3D_NO_NATIVE=1`` selects.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.grid.octree import Key, Octree
from cup3d_tpu_torch.grid.uniform import BC

# quadratic (3-pt Lagrange) interpolation weights at -1/4 and +1/4 of the
# parent cell, exact for quadratics (main.cpp:3485-3488 in closed form)
_WQ = {
    0: (0.15625, 0.9375, -0.09375),  # fine cell on the low side of parent
    1: (-0.09375, 0.9375, 0.15625),  # fine cell on the high side
}


def require_fp32_matmuls(t: torch.Tensor) -> None:
    """The interpolation tensordots run in full f32 on the card (the JAX
    package's Precision.HIGHEST): raise if TF32 is on."""
    if t.is_cuda:
        from cup3d_tpu_torch.ops import precision

        precision.check_fp32_matmul()


@dataclass
class LabTables:
    """Gather tables for one (topology, width) pair on one device."""

    width: int
    ghost_flat: torch.Tensor  # (ng,) int64 flat lab position of each ghost
    g_idx: torch.Tensor  # (nb, ng, 8) int32 into flat field (+sentinel)
    g_w: torch.Tensor  # (nb, ng, 8) f32
    g_sign: torch.Tensor  # (nb, ng, 3) f32 per-component BC sign
    mask_coarse: torch.Tensor  # (nb, ng) bool: take the interpolation path
    s_idx: torch.Tensor  # (nb, ns, 8) int32 coarse-scratch sources
    s_w: torch.Tensor  # (nb, ns, 8) f32
    s_sign: torch.Tensor  # (nb, ns, 3) f32
    interp_w: torch.Tensor  # (L, S) f32 separable quadratic upsample matrix
    any_coarse: bool  # whether any block has a coarser neighbor

    def assemble_scalar(self, field: torch.Tensor, bs: int) -> torch.Tensor:
        return _assemble_comp(field, self, bs, None)

    def assemble_vector(self, field: torch.Tensor, bs: int) -> torch.Tensor:
        return torch.stack([_assemble_comp(field[..., c], self, bs, c)
                            for c in range(3)], dim=-1)

    def assemble_component(self, field: torch.Tensor, bs: int,
                           comp: int) -> torch.Tensor:
        """One velocity component with its BC sign ghosts."""
        return _assemble_comp(field, self, bs, comp)

    def rows(self, rows: np.ndarray) -> "LabTables":
        """The tables of a subset of blocks (indices into the full field
        stay as they are)."""
        r = torch.as_tensor(np.asarray(rows, np.int64),
                            device=self.g_idx.device)
        return LabTables(
            width=self.width, ghost_flat=self.ghost_flat,
            g_idx=self.g_idx[r], g_w=self.g_w[r], g_sign=self.g_sign[r],
            mask_coarse=self.mask_coarse[r], s_idx=self.s_idx[r],
            s_w=self.s_w[r], s_sign=self.s_sign[r],
            interp_w=self.interp_w, any_coarse=self.any_coarse)


class BlockGrid:
    """Geometry + topology of one AMR forest snapshot.

    Adaptation builds a *new* BlockGrid and maps old fields to new
    (grid/adapt.py) instead of editing in place.
    """

    def __init__(self, tree: Octree, extent: Tuple[float, float, float],
                 bc: Tuple[BC, BC, BC] = (BC.periodic,) * 3, bs: int = 8):
        if bs % 2:
            raise ValueError("block size must be even")
        self.tree = tree
        self.bs = bs
        self.bc = tuple(BC(b) for b in bc)
        self.extent = tuple(float(e) for e in extent)
        cfg = tree.cfg
        h0 = self.extent[0] / (cfg.bpd[0] * bs)
        for a in range(3):
            if abs(self.extent[a] / (cfg.bpd[a] * bs) - h0) > 1e-12 * h0:
                raise ValueError("anisotropic base spacing not supported")
        self.h0 = h0

        self.keys: List[Key] = tree.ordered_leaves()
        self.slot: Dict[Key, int] = {k: i for i, k in enumerate(self.keys)}
        self.nb = len(self.keys)
        self.level = np.array([k[0] for k in self.keys], np.int32)
        self.ijk = np.array([k[1:] for k in self.keys], np.int32)
        self.h = (h0 / (1 << self.level.astype(np.int64))).astype(np.float64)
        self.origin = self.ijk * (self.h * bs)[:, None]

        # dense (level, i, j, k) -> slot maps for vectorized owner lookups,
        # plus exact per-level internal-node masks ('covered finer')
        self._slot_maps: List[np.ndarray] = []
        self._int_maps: List[np.ndarray] = []
        for l in range(cfg.level_max):
            n = tree.blocks_per_dim(l)
            self._slot_maps.append(np.full(n, -1, np.int32))
            self._int_maps.append(np.zeros(n, bool))
        for s, (l, i, j, k) in enumerate(self.keys):
            self._slot_maps[l][i, j, k] = s
        for (l, i, j, k) in tree.internal_nodes():
            self._int_maps[l][i, j, k] = True

        self._cache: Dict[tuple, object] = {}
        self._sig = None

    @property
    def signature(self):
        """Hashable identity of this topology (leaves + extent + bc + bs)."""
        if self._sig is None:
            self._sig = (
                self.bs, self.extent, tuple(b.value for b in self.bc),
                self.tree.cfg.level_max, tuple(self.keys),
            )
        return self._sig

    # -- geometry ----------------------------------------------------------

    @property
    def hmin(self) -> float:
        """Spacing at the deepest allowed level (reference hmin,
        main.cpp:15402): the resolution bodies are rasterized at."""
        return self.h0 / (1 << (self.tree.cfg.level_max - 1))

    def cell_centers(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """(nb, bs, bs, bs, 3) physical cell-center coordinates, computed
        in f64 and rounded to ``dtype`` (the JAX package's values)."""
        bs = self.bs
        loc = np.stack(
            np.meshgrid(*[np.arange(bs) + 0.5] * 3, indexing="ij"), axis=-1
        )
        xc = (self.origin[:, None, None, None, :]
              + loc[None] * self.h[:, None, None, None, None])
        np_dtype = np.dtype(str(dtype).replace("torch.", ""))
        return torch.as_tensor(xc.astype(np_dtype), device=device)

    def zeros(self, ncomp: int = 0, dtype=torch.float32,
              device="cpu") -> torch.Tensor:
        shape = (self.nb,) + (self.bs,) * 3 + ((ncomp,) if ncomp else ())
        return torch.zeros(shape, dtype=dtype, device=device)

    def h_column(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """(nb, 1, 1, 1) per-block spacing (f64 rounded to ``dtype``),
        uploaded once per device."""
        key = ("hcol", str(dtype), str(torch.device(device)))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                self.h.reshape(self.nb, 1, 1, 1), dtype=dtype, device=device)
        return self._cache[key]

    # -- halo tables -------------------------------------------------------

    def lab_tables(self, width: int, device="cpu") -> LabTables:
        key = ("lab", width, str(torch.device(device)))
        if key not in self._cache:
            self._cache[key] = _lab_tables_on(self.lab_tables_np(width),
                                              width, device)
        return self._cache[key]

    def lab_tables_np(self, width: int) -> dict:
        """The per-cell tables of ``width`` as host numpy arrays (built
        once): ghost_xyz, g_idx, g_w, g_sign, mask_coarse, s_idx, s_w,
        s_sign, interp_w, any_coarse."""
        np_key = ("lab_np", width)
        if np_key not in self._cache:
            self._cache[np_key] = self._build_lab_tables(width)
        return self._cache[np_key]

    def face_tables(self, width: int, device="cpu"):
        """Faces-only halo tables (grid/faces.py) for axis-stencil
        operators; duck-compatible with LabTables."""
        key = ("faces", width, str(torch.device(device)))
        if key not in self._cache:
            from cup3d_tpu_torch.grid.faces import build_face_tables

            self._cache[key] = build_face_tables(self, width, device)
        return self._cache[key]

    def _cells_per_dim(self, l: int) -> np.ndarray:
        return np.array(
            [b * self.bs << l for b in self.tree.cfg.bpd], np.int64
        )

    def _domainize(self, cell: np.ndarray, l: int):
        """Wrap periodic axes; clamp closed axes (zero-gradient) recording
        per-component sign flips.  cell: (..., 3) level-l cell coords.
        Returns (cell, sign (...,3))."""
        n = self._cells_per_dim(l)
        cell = cell.copy()
        sign = np.ones(cell.shape[:-1] + (3,), np.float32)
        for a in range(3):
            ca = cell[..., a]
            if self.bc[a] == BC.periodic:
                cell[..., a] = np.mod(ca, n[a])
            else:
                out = (ca < 0) | (ca >= n[a])
                cell[..., a] = np.clip(ca, 0, n[a] - 1)
                if np.any(out):
                    if self.bc[a] == BC.wall:
                        sign[out] *= -1.0  # all components flip
                    else:  # freespace: only the face-normal component
                        sign[..., a][out] *= -1.0
        return cell, sign

    def _owner_level_vec(self, l: int, bpos: np.ndarray) -> np.ndarray:
        """Vectorized owner level for block positions (..., 3) at level l:
        l-1, l, or l+1 (in-domain input; covered finer at any depth
        reports l+1, the caller descends again)."""
        sm = self._slot_maps
        i, j, k = bpos[..., 0], bpos[..., 1], bpos[..., 2]
        own = np.full(bpos.shape[:-1], -9, np.int32)
        is_leaf = sm[l][i, j, k] >= 0
        own[is_leaf] = l
        if l > 0:
            par = sm[l - 1][i // 2, j // 2, k // 2] >= 0
            own[~is_leaf & par] = l - 1
        fin = self._int_maps[l][i, j, k]
        own[(own == -9) & fin] = l + 1
        if np.any(own == -9):
            raise KeyError("unresolved owner: tree not 2:1 balanced?")
        return own

    @staticmethod
    def _interp_matrix(L: int, S: int, w: int, cw: int) -> np.ndarray:
        """Separable quadratic upsample matrix (L, S), identical per block."""
        W = np.zeros((L, S), np.float32)
        for f in range(L):
            g = f - w
            p = g // 2 + cw
            par = g & 1
            for d, wq in zip((-1, 0, 1), _WQ[par]):
                W[f, p + d] += wq
        return W

    def _flat_idx(self, l: int, cell: np.ndarray) -> np.ndarray:
        """Flat field index of level-l cell coords (..., 3) owned by level-l
        leaves.  Out-of-tree positions -> sentinel."""
        bs = self.bs
        bpos = cell // bs
        slot = self._slot_maps[l][bpos[..., 0], bpos[..., 1], bpos[..., 2]]
        loc = cell - bpos * bs
        flat = (
            slot.astype(np.int64) * bs**3
            + loc[..., 0] * bs * bs
            + loc[..., 1] * bs
            + loc[..., 2]
        )
        flat[slot < 0] = self.nb * bs**3  # sentinel
        return flat

    def _build_lab_tables(self, w: int) -> dict:
        """The per-cell tables of width ``w`` as numpy arrays: the native
        builder's (the JAX package's order, grid/blocks.py:383-395), or
        the numpy builder's under ``CUP3D_NO_NATIVE=1``."""
        from cup3d_tpu_torch import native

        if not native.enabled():
            return self._build_lab_tables_numpy(w)
        bs = self.bs
        L = bs + 2 * w
        cw = max(2, (w + 1) // 2 + 1)
        S = bs // 2 + 2 * cw
        gg = np.stack(np.meshgrid(*[np.arange(L)] * 3, indexing="ij"), -1)
        interior = np.all((gg >= w) & (gg < w + bs), axis=-1)
        gxyz = gg[~interior]
        out = native.build_lab_tables(self, w, gxyz, cw)
        out["ghost_xyz"] = gxyz
        out["interp_w"] = self._interp_matrix(L, S, w, cw)
        return out

    def _build_lab_tables_numpy(self, w: int) -> dict:
        """The JAX package's numpy table build (the reference of the
        native one), returned as numpy arrays."""
        bs, nb = self.bs, self.nb
        L = bs + 2 * w
        cbs = bs // 2
        # coarse-scratch halo (coarse cells) sized so the quadratic stencil
        # of the deepest fine ghost stays inside: p-1 = floor(-w/2)+cw-1 >= 0
        cw = max(2, (w + 1) // 2 + 1)
        S = cbs + 2 * cw
        sentinel = nb * bs**3

        gg = np.stack(np.meshgrid(*[np.arange(L)] * 3, indexing="ij"), -1)
        interior = np.all((gg >= w) & (gg < w + bs), axis=-1)
        gxyz = gg[~interior]  # (ng, 3)
        ng = gxyz.shape[0]

        g_idx = np.full((nb, ng, 8), sentinel, np.int64)
        g_w = np.zeros((nb, ng, 8), np.float32)
        g_sign = np.ones((nb, ng, 3), np.float32)
        mask_coarse = np.zeros((nb, ng), bool)

        s_idx = np.full((nb, S**3, 8), sentinel, np.int64)
        s_w = np.zeros((nb, S**3, 8), np.float32)
        s_sign = np.ones((nb, S**3, 3), np.float32)

        scoords = np.stack(
            np.meshgrid(*[np.arange(S)] * 3, indexing="ij"), -1
        ).reshape(-1, 3)

        any_coarse = False
        offs = np.stack(
            np.meshgrid(*[np.arange(2)] * 3, indexing="ij"), -1
        ).reshape(-1, 3)  # 8 suboctant offsets

        for l in np.unique(self.level):
            bsel = np.where(self.level == l)[0]
            ijk = self.ijk[bsel].astype(np.int64)  # (m, 3)
            # -- fine path: ghosts at the block's own level ---------------
            cell = ijk[:, None, :] * bs + (gxyz[None, :, :] - w)  # (m,ng,3)
            cell, sign = self._domainize(cell, int(l))
            g_sign[bsel] = sign
            own = self._owner_level_vec(int(l), cell // bs)

            same = own == l
            gi = g_idx[bsel]
            gwt = g_w[bsel]
            gi[same, 0] = self._flat_idx(int(l), cell[same])
            gwt[same, 0] = 1.0

            finer = own == l + 1
            if np.any(finer):
                cf = cell[finer]  # (q, 3) level-l cells covered by l+1
                fine = 2 * cf[:, None, :] + offs[None, :, :]  # (q, 8, 3)
                gi[finer] = self._flat_idx(int(l) + 1, fine)
                gwt[finer] = 0.125

            coarser = own == l - 1
            mask_coarse[bsel] = coarser
            g_idx[bsel] = gi
            g_w[bsel] = gwt

            # -- coarse scratch at level l-1 ------------------------------
            if l == 0 or not np.any(coarser):
                continue
            any_coarse = True
            ccell = ijk[:, None, :] * cbs + (scoords[None, :, :] - cw)
            ccell, csign = self._domainize(ccell, int(l) - 1)
            s_sign[bsel] = csign
            cown = self._owner_level_vec(int(l) - 1, ccell // bs)
            si = s_idx[bsel]
            sw = s_w[bsel]

            csame = cown == l - 1  # copy from the coarse leaf
            si[csame, 0] = self._flat_idx(int(l) - 1, ccell[csame])
            sw[csame, 0] = 1.0

            cfiner = cown == l  # average down 2^3 level-l cells
            if np.any(cfiner):
                cf = ccell[cfiner]
                fine = 2 * cf[:, None, :] + offs[None, :, :]
                # region may be owned at l+1 (two levels finer than the
                # scratch): approximate by the middle octant at l+1
                fown = self._owner_level_vec(int(l), fine // bs)
                deeper = fown == l + 1
                fidx = self._flat_idx(int(l), fine)
                if np.any(deeper):
                    fidx[deeper] = self._flat_idx(int(l) + 1,
                                                  2 * fine[deeper] + 1)
                si[cfiner] = fidx
                sw[cfiner] = 0.125

            ccoarser = cown == l - 2  # far corner: constant injection
            if np.any(ccoarser):
                si[ccoarser, 0] = self._flat_idx(int(l) - 2,
                                                 ccell[ccoarser] // 2)
                sw[ccoarser, 0] = 1.0

            s_idx[bsel] = si
            s_w[bsel] = sw

        return dict(
            ghost_xyz=gxyz, g_idx=g_idx, g_w=g_w, g_sign=g_sign,
            mask_coarse=mask_coarse, s_idx=s_idx, s_w=s_w, s_sign=s_sign,
            interp_w=self._interp_matrix(L, S, w, cw),
            any_coarse=bool(any_coarse),
        )


def _lab_tables_on(t: dict, w: int, device) -> LabTables:
    gx, gy, gz = (t["ghost_xyz"][:, a].astype(np.int64) for a in range(3))
    L = t["interp_w"].shape[0]

    def on(a, dtype):
        return torch.as_tensor(a, device=device).to(dtype)

    return LabTables(
        width=w,
        ghost_flat=on((gx * L + gy) * L + gz, torch.int64),
        g_idx=on(t["g_idx"].astype(np.int32), torch.int32),
        g_w=on(t["g_w"], torch.float32),
        g_sign=on(t["g_sign"], torch.float32),
        mask_coarse=on(t["mask_coarse"], torch.bool),
        s_idx=on(t["s_idx"].astype(np.int32), torch.int32),
        s_w=on(t["s_w"], torch.float32),
        s_sign=on(t["s_sign"], torch.float32),
        interp_w=on(t["interp_w"], torch.float32),
        any_coarse=t["any_coarse"],
    )


# ---------------------------------------------------------------------------
# lab assembly
# ---------------------------------------------------------------------------


def gather_weighted(flat: torch.Tensor, idx: torch.Tensor,
                    wts: torch.Tensor) -> torch.Tensor:
    """sum_k flat[idx[..., k]] * wts[..., k] (every index in range)."""
    vals = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)
    return torch.sum(vals * wts, dim=-1)


def upsample(scratch: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(n, S,S,S) -> (n, L,L,L) separable tensor product with W (L, S)."""
    require_fp32_matmuls(scratch)
    out = scratch
    for axis in (1, 2, 3):
        out = torch.tensordot(out, W, dims=([axis], [1])).movedim(-1, axis)
    return out


def _assemble_comp(comp: torch.Tensor, t: LabTables, bs: int, c) -> torch.Tensor:
    """(nb, bs,bs,bs) -> (nb, L,L,L) lab; ``c`` the velocity component
    whose BC signs apply (None: scalar, zero-gradient ghosts)."""
    flat = torch.cat([comp.reshape(-1), comp.new_zeros(1)])
    return assemble_from(comp, flat, t, bs, c)


def assemble_from(comp: torch.Tensor, flat: torch.Tensor, t: LabTables,
                  bs: int, c) -> torch.Tensor:
    """The lab of ``comp`` with its ghosts gathered from ``flat``, the
    buffer ``t``'s indices address (the flattened field plus its zero
    sentinel; the sharded forest passes its exchanged buffers)."""
    nb = comp.shape[0]
    w = t.width
    L = bs + 2 * w
    ghosts = gather_weighted(flat, t.g_idx, t.g_w)
    if c is not None:
        ghosts = ghosts * t.g_sign[..., c]
    if t.any_coarse:
        scratch = gather_weighted(flat, t.s_idx, t.s_w)
        if c is not None:
            scratch = scratch * t.s_sign[..., c]
        S = t.interp_w.shape[1]
        interp = upsample(scratch.reshape(nb, S, S, S), t.interp_w)
        interp_g = interp.reshape(nb, -1).index_select(1, t.ghost_flat)
        ghosts = torch.where(t.mask_coarse, interp_g, ghosts)
    lab = comp.new_zeros((nb, L, L, L))
    lab[:, w:w + bs, w:w + bs, w:w + bs] = comp
    lab.view(nb, -1).index_copy_(1, t.ghost_flat, ghosts.to(comp.dtype))
    return lab
