"""Conservative flux correction at coarse-fine faces (port of
``cup3d_tpu/grid/flux.py``; reference FluxCorrection, main.cpp:555-802).

Convention: operators emit *outward, per-unit-area* face fluxes as a
``(nb, 6, bs, bs)`` array — faces ordered (-x, +x, -y, +y, -z, +z), the
(bs, bs) plane indexed by the two remaining axes in ascending order.  The
coarse side of every coarse-fine face is corrected by

    out[coarse boundary cell] += (mean of 4 fine fluxes * (-1) - F_coarse)/h_c

where the -1 re-orients the fine blocks' outward flux.  Only the coarse
side is touched (reference FillBlockCases, main.cpp:729-801).

The table build is the JAX package's numpy code.  Its scatter-add has
repeated targets: a coarse edge or corner cell takes one correction from
each of its coarse-fine faces.  A scatter-add with atomics would sum them
in an order that changes from run to run, so the build groups the
corrections by target cell into a fixed ``(ncell, K)`` table and
:func:`apply_flux_correction` sums each group in that order and writes
each target once: reruns are bitwise equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_FACE_AXIS = (0, 0, 1, 1, 2, 2)
_FACE_SIDE = (-1, 1, -1, 1, -1, 1)  # low/high


@dataclass
class FluxTables:
    """Precomputed coarse-side correction (empty tables are valid)."""

    tgt_flux: torch.Tensor  # (nc,) int64 flat index into (nb*6*bs^2) fluxes
    src_flux: torch.Tensor  # (nc, 4) int64 fine-side flux indices
    inv_hc: torch.Tensor  # (nc,) f32 1/h of the corrected (coarse) block
    cells: torch.Tensor  # (ncell,) int64 distinct target cells
    groups: torch.Tensor  # (ncell, K) int64 rows per cell, nc = no row
    ncorr: int

    def apply(self, out: torch.Tensor, fluxes: torch.Tensor) -> torch.Tensor:
        return apply_flux_correction(out, fluxes, self)


def build_flux_tables(grid, device="cpu") -> FluxTables:
    """grid: BlockGrid.  Enumerates every (coarse block, face) whose
    neighbor region is one level finer."""
    bs = grid.bs
    tree = grid.tree
    tgt_cell, tgt_flux, src_flux, inv_hc = [], [], [], []

    jj, kk = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    jj, kk = jj.ravel(), kk.ravel()  # coarse face-cell coords (bs^2,)

    for s, (l, bi, bj, bk) in enumerate(grid.keys):
        for face in range(6):
            ax, side = _FACE_AXIS[face], _FACE_SIDE[face]
            npos = [bi, bj, bk]
            npos[ax] += side
            w = tree.wrap(l, npos)
            if w is None:
                continue
            # a KeyError from owner_level means a broken tree: skipping a
            # coarse-fine face would silently lose conservation
            own = tree.owner_level(l, w)
            if own != l + 1:
                continue
            t1, t2 = [a for a in range(3) if a != ax]
            cell = np.zeros((bs * bs, 3), np.int64)
            cell[:, ax] = 0 if side < 0 else bs - 1
            cell[:, t1] = jj
            cell[:, t2] = kk
            flat_cell = (
                s * bs**3
                + cell[:, 0] * bs * bs
                + cell[:, 1] * bs
                + cell[:, 2]
            )
            flat_flux = s * 6 * bs * bs + face * bs * bs + jj * bs + kk

            # fine blocks: level l+1 positions 2*w + delta, delta[ax] fixed
            # to the side facing back at us
            fine_face = face + (1 if side < 0 else -1)  # their opposite face
            quad1, quad2 = 2 * jj // bs, 2 * kk // bs  # which child
            fpos = np.zeros((bs * bs, 3), np.int64)
            fpos[:, ax] = 2 * w[ax] + (1 if side < 0 else 0)
            fpos[:, t1] = 2 * w[t1] + quad1
            fpos[:, t2] = 2 * w[t2] + quad2
            fslot = grid._slot_maps[l + 1][fpos[:, 0], fpos[:, 1], fpos[:, 2]]
            if np.any(fslot < 0):
                raise KeyError("fine neighbor missing: unbalanced tree")
            fj = (2 * jj) % bs
            fk = (2 * kk) % bs
            quads = []
            for dj in (0, 1):
                for dk in (0, 1):
                    quads.append(
                        fslot.astype(np.int64) * 6 * bs * bs
                        + fine_face * bs * bs
                        + (fj + dj) * bs
                        + (fk + dk)
                    )
            tgt_cell.append(flat_cell)
            tgt_flux.append(flat_flux)
            src_flux.append(np.stack(quads, axis=-1))
            inv_hc.append(np.full(bs * bs, 1.0 / grid.h[s], np.float32))

    if tgt_cell:
        tc = np.concatenate(tgt_cell)
        tf = np.concatenate(tgt_flux)
        sf = np.concatenate(src_flux)
        ih = np.concatenate(inv_hc)
    else:
        tc = tf = np.zeros(0, np.int64)
        sf = np.zeros((0, 4), np.int64)
        ih = np.zeros(0, np.float32)
    nc = tc.shape[0]
    # group the rows by target cell, rows of one cell in table order
    order = np.argsort(tc, kind="stable")
    cells, first, counts = np.unique(tc[order], return_index=True,
                                     return_counts=True)
    K = int(counts.max()) if nc else 1
    groups = np.full((cells.shape[0], K), nc, np.int64)
    for k in range(K):
        has = counts > k
        groups[has, k] = order[first[has] + k]

    def on(a, dtype):
        return torch.as_tensor(a, device=device).to(dtype)

    return FluxTables(
        tgt_flux=on(tf, torch.int64), src_flux=on(sf, torch.int64),
        inv_hc=on(ih, torch.float32), cells=on(cells, torch.int64),
        groups=on(groups, torch.int64), ncorr=nc,
    )


def apply_flux_correction(out: torch.Tensor, fluxes: torch.Tensor,
                          tab: FluxTables) -> torch.Tensor:
    """out: (nb, bs,bs,bs) conservative-operator result; fluxes:
    (nb, 6, bs, bs) outward per-unit-area face fluxes.  Returns corrected
    out (a new tensor)."""
    if tab.ncorr == 0:
        return out
    corr = corrections(fluxes.reshape(-1), tab.src_flux, tab.tgt_flux,
                       tab.inv_hc)
    flat = out.reshape(-1)
    # out of place (the same sums as add_grouped): ``out`` may be one
    # tensor shared by lanes whose fluxes differ (torch.func.vmap)
    flat = flat.index_put((tab.cells,),
                          flat[tab.cells] + grouped_sums(tab.groups, corr,
                                                         flat.dtype))
    return flat.reshape(out.shape)


def corrections(fflat: torch.Tensor, src_flux: torch.Tensor,
                tgt_flux: torch.Tensor, inv_hc: torch.Tensor) -> torch.Tensor:
    """Per correction row: (-(mean of its 4 fine fluxes) - its coarse
    flux) / h_c, the mean an elementwise sum in one fixed order (rows
    round alike whatever the batch, as the sharded forest needs)."""
    q = fflat[src_flux]
    fine_mean = (q[..., 0] + q[..., 1] + q[..., 2] + q[..., 3]) / 4
    return (-fine_mean - fflat[tgt_flux]) * inv_hc


def add_grouped(flat: torch.Tensor, cells: torch.Tensor,
                groups: torch.Tensor, corr: torch.Tensor) -> None:
    """flat[cells] += the corrections of each cell's group, summed in
    table order (``groups`` index ``corr`` along its last axis with one
    zero row appended; every target written once), in place."""
    flat[cells] = flat[cells] + grouped_sums(groups, corr, flat.dtype)


def grouped_sums(groups: torch.Tensor, corr: torch.Tensor,
                 dtype) -> torch.Tensor:
    """Each cell's group of corrections summed in table order."""
    corr = torch.cat([corr, corr.new_zeros(corr.shape[:-1] + (1,))],
                     dim=-1).to(dtype)
    corr = corr.reshape(-1)
    add = None
    for k in range(groups.shape[-1]):
        part = corr[groups[..., k]]
        add = part if add is None else add + part
    return add


#: most coarse-fine faces one coarse cell can border (a block corner)
GROUP_MAX = 3


def pad_flux_tables(t: FluxTables, bs: int, cap: int,
                    device=None) -> FluxTables:
    """Capacity-bucketed padding (grid/bucket.py; the JAX package's
    ``pad_flux_tables``): the correction rows round up their ladder with
    INERT rows, so the table shapes are stable across regrids that stay
    within a bucket; the padded tables land on ``device`` (default:
    ``t``'s).

    Padding rows carry ``inv_hc = 0`` (their correction is exactly 0)
    and read the fluxes of cell 0's face of the last padding block
    (``cap - 1``, which the strict block-capacity ladder guarantees).
    The target cells round up their own ladder: padding groups name that
    block's cell 0 and hold no row, and every group is GROUP_MAX wide,
    so real cells are never touched, not even by a signed zero.  Empty
    tables stay empty (a topology without coarse faces is its own
    bucket class)."""
    from cup3d_tpu_torch.grid import bucket as bk

    n = int(t.ncorr)
    dev = t.tgt_flux.device if device is None else torch.device(device)
    if n == 0:
        return FluxTables(**{k: (v.to(dev) if isinstance(v, torch.Tensor)
                                 else v) for k, v in vars(t).items()})
    c = bk.count_capacity(n)
    ncell = bk.count_capacity(int(t.cells.shape[0]))
    dump_cell = (cap - 1) * bs**3
    dump_flux = (cap - 1) * 6 * bs * bs

    def host(x):
        return x.detach().cpu().numpy()

    groups = host(t.groups).astype(np.int64)
    groups[groups == n] = c  # "no row": the zero row after c corrections
    groups = np.concatenate(
        [groups, np.full((groups.shape[0], GROUP_MAX - groups.shape[1]),
                         c, np.int64)], axis=1)

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    return FluxTables(
        tgt_flux=on(bk.pad_rows(host(t.tgt_flux), c, fill=dump_flux),
                    torch.int64),
        src_flux=on(bk.pad_rows(host(t.src_flux), c, fill=dump_flux),
                    torch.int64),
        inv_hc=on(bk.pad_rows(host(t.inv_hc), c, fill=0.0), torch.float32),
        cells=on(bk.pad_rows(host(t.cells), ncell, fill=dump_cell),
                 torch.int64),
        groups=on(bk.pad_rows(groups, ncell, fill=c), torch.int64),
        ncorr=c,
    )
