"""Sharded face-structured halo assembly (port of
``cup3d_tpu/parallel/faces.py``): the face-slab tables of grid/faces.py
on the block-sharded forest (parallel/forest.py).

- Entries (leaves + shadow nodes) are owned by shards: leaves by the
  Hilbert cut, a shadow by the owner of its first child.  Hilbert
  contiguity makes a node's children nearly always co-resident, so the
  cross-shard pyramid traffic is a handful of boundary entries.
- The pyramid runs bottom-up as on one device, with one entry-granular
  exchange BEFORE each level group carrying the few remote children that
  group needs (the fine-side AverageDownAndFill messages of the
  reference, main.cpp:1832-1905).
- One final exchange fetches the remote face-source entries (same-level
  or shadow neighbours and coarse-window members); then the dense
  face-slab and separable-quadratic math of grid/faces.py runs on the
  remapped tables, over all shards at once.

An exchange is the axis swap of the send buffer (compat.all_to_all) or,
under ``CUP3D_RING_HALO=1``, D-1 ring steps (ring.ring_all_to_all,
kernel B14 on CUDA); the two land bitwise equal.  Degenerate blocks
(coarse windows crossing a CLOSED boundary) raise here, and the forest
takes its per-cell lab tables instead (none on periodic domains).

Address space per shard (entry granularity):
    [0, nbs)                      local leaves
    [nbs, nbs + ns_max)           local shadows (padded)
    [recv ... )                   received rows, one region per exchange
    zero sentinel                 (always-zero entry)
    scratch                       (padding writes land here)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.grid.faces import (_place, _restrict8, _slab,
                                        coarse_halo_rows)
from cup3d_tpu_torch.parallel import ring
from cup3d_tpu_torch.parallel.compat import (all_to_all, put_rows,
                                             shard_view, stacked_rows,
                                             take_rows, unshard_view)

__all__ = ["ShardedFaceTables", "build_sharded_face_tables"]


@dataclass
class _ExchangePlan:
    """One exchange at entry granularity: send_idx[t, s, :] = rows (in
    t's local address space) that shard s needs from t; ``recv_off`` the
    received region's first row.  send_idx None = nothing crosses shards
    for this exchange, and the assembly skips it."""

    send_idx: Optional[np.ndarray]  # (D, D, M) shard-local, host
    send_rows: Optional[torch.Tensor]  # the same rows, stacked, device
    M: int
    recv_off: int


class _EntrySpace:
    """Per-shard entry address bookkeeping for the host table build."""

    def __init__(self, D: int, nbs: int, ns_max: int):
        self.D = D
        self.nbs = nbs
        self.ns_max = ns_max
        self.recv_regions: List[int] = []  # sizes D*M per exchange
        # owner[global_entry] and local slot of each global entry
        self.owner: Dict[int, int] = {}
        self.slot: Dict[int, int] = {}
        # per exchange, per shard: global entry -> recv row index
        self.recv_maps: List[List[Dict[int, int]]] = []
        self._local: Optional[List[Dict[int, int]]] = None

    @property
    def n_recv(self) -> int:
        return sum(self.recv_regions)

    def local_size(self) -> int:
        # + zero sentinel + scratch
        return self.nbs + self.ns_max + self.n_recv + 2

    def zero_row(self) -> int:
        return self.nbs + self.ns_max + self.n_recv

    def scratch_row(self) -> int:
        return self.zero_row() + 1

    def finish(self) -> None:
        """After the last exchange is planned: one map per shard from
        each entry it can read (owned or received) to its local row."""
        local: List[Dict[int, int]] = [dict() for _ in range(self.D)]
        for e, s in self.owner.items():
            local[s][e] = self.slot[e]
        off = self.nbs + self.ns_max
        for size, maps in zip(self.recv_regions, self.recv_maps):
            for s in range(self.D):
                for e, row in maps[s].items():
                    local[s].setdefault(e, off + row)
            off += size
        self._local = local

    def resolve(self, e: int, shard: int, sentinel: int) -> int:
        """Global entry -> shard-local row (owned or received)."""
        if e == sentinel:
            return self.zero_row()
        row = self._local[shard].get(e)
        if row is None:
            raise KeyError(f"entry {e} not routed to shard {shard}")
        return row


def _plan_exchange(space: _EntrySpace, needed: List[set], D: int
                   ) -> Tuple[Optional[np.ndarray], int]:
    """needed[s] = set of global entries shard s must receive.  Returns
    (send_idx (D, D, M), M) and registers the recv region + maps.  When
    NO shard needs anything remote, returns (None, 0) and registers an
    empty region: the assembly skips the exchange."""
    groups = []
    for s in range(D):
        by_src: List[List[int]] = [[] for _ in range(D)]
        for e in sorted(needed[s]):
            t = space.owner[e]
            if t != s:
                by_src[t].append(e)
        groups.append(by_src)
    if not any(g for gs in groups for g in gs):
        space.recv_regions.append(0)
        space.recv_maps.append([dict() for _ in range(D)])
        return None, 0
    M = max([len(g) for gs in groups for g in gs] + [1])
    send_idx = np.zeros((D, D, M), np.int64)
    recv_maps: List[Dict[int, int]] = [dict() for _ in range(D)]
    for s in range(D):
        for t in range(D):
            for j, e in enumerate(groups[s][t]):
                send_idx[t, s, j] = space.slot[e]
                # recv layout after the exchange: rows arrive ordered by
                # source shard t, then j
                recv_maps[s][e] = t * M + j
    space.recv_regions.append(D * M)
    space.recv_maps.append(recv_maps)
    return send_idx, M


def _exchange_entries(ext: torch.Tensor, plan: _ExchangePlan) -> None:
    """Send full entries (rows of each shard's ext) and write them into
    the recv region, in place.  ext: (D, n_local, C, bs, bs, bs)."""
    D = ext.shape[0]
    send = take_rows(ext, plan.send_rows)  # (D_src, D_dst, M, C, bs^3)
    region = ext[:, plan.recv_off:plan.recv_off + D * plan.M]
    if ring.use_ring_halo():
        # the ring steps land each chunk in the recv region themselves
        ring.ring_all_to_all(send, out=region.unflatten(1, (D, plan.M)))
    else:
        region.copy_(all_to_all(send).reshape(region.shape))


@dataclass
class ShardedFaceTables:
    """Duck-typed FaceTables over the sharded forest (see module doc).
    Device tables hold rows of the stacked per-shard buffers
    (compat.stacked_rows); ``*_idx`` host copies keep the shard-local
    rows the JAX package's tables hold."""

    width: int
    bs: int
    D: int
    nbs: int
    ns_max: int
    n_local: int
    zero_row: int
    # pyramid, deepest group first: (dst rows (D, nsg_max), child rows
    # (D, nsg_max, 8), exchange plan)
    groups: Tuple[Tuple[torch.Tensor, torch.Tensor, _ExchangePlan], ...]
    final_plan: _ExchangePlan
    src_idx: np.ndarray  # (D, 6, nbs) shard-local entry rows, host
    src: Tuple[torch.Tensor, ...]  # 6 x (D, nbs) stacked ext rows
    bmask: torch.Tensor  # (6, nb_pad) bool
    bsign: torch.Tensor  # (6, 3) f32
    cf_rows: Tuple[torch.Tensor, ...]  # 6 x (D, ncf_max) stacked slab rows
    cf_src: Tuple[torch.Tensor, ...]  # 6 x (D*ncf_max, 8) stacked ext rows
    cf_toff: Tuple[torch.Tensor, ...]  # 6 x (D*ncf_max, 2)
    interp_t: torch.Tensor
    interp_n_lo: torch.Tensor
    interp_n_hi: torch.Tensor

    # -- protocol ----------------------------------------------------------

    def assemble_scalar(self, field: torch.Tensor, bs: int) -> torch.Tensor:
        return self._assemble(field[..., None], None)[..., 0]

    def assemble_vector(self, field: torch.Tensor, bs: int) -> torch.Tensor:
        return self._assemble(field, (0, 1, 2))

    def assemble_component(self, field: torch.Tensor, bs: int,
                           comp: int) -> torch.Tensor:
        return self._assemble(field[..., None], (comp,))[..., 0]

    def _assemble(self, fields: torch.Tensor,
                  sign_comps: Optional[Tuple[int, ...]]) -> torch.Tensor:
        """(nb_pad, bs,bs,bs, C) -> (nb_pad, L,L,L, C) faces-only labs."""
        bs, w, D, nbs = self.bs, self.width, self.D, self.nbs
        L = bs + 2 * w
        C = fields.shape[-1]
        blk = (C, bs, bs, bs)
        fm = fields.movedim(-1, 1)  # (nb_pad, C, bs,bs,bs)
        ext = fields.new_zeros((D, self.n_local) + blk)
        ext[:, :nbs] = shard_view(fm, D)
        # -- pyramid (deepest group first) ---------------------------------
        for dst, child, plan in self.groups:
            if plan.send_rows is not None:  # else: fully shard-local group
                _exchange_entries(ext, plan)
            ch = take_rows(ext, child)  # (D, nsg, 8, C, bs^3)
            sh = _restrict8(ch.reshape((-1,) + tuple(ch.shape[2:])), bs)
            put_rows(ext, dst, sh)
        # -- final exchange: face sources + coarse windows ----------------
        if self.final_plan.send_rows is not None:
            _exchange_entries(ext, self.final_plan)
        extf = ext.reshape((-1,) + blk)
        # -- dense face assembly (grid/faces.py math) ----------------------
        lab = fields.new_zeros((D * nbs, C) + (L,) * 3)
        lab[:, :, w:w + bs, w:w + bs, w:w + bs] = fm
        for a in range(3):
            for hi in (0, 1):
                fc = 2 * a + hi
                sl = _slab(extf, a, 0, w) if hi else _slab(extf, a, bs - w, w)
                slab = sl.index_select(0, self.src[fc].reshape(-1))
                own = _slab(fm, a, bs - 1 if hi else 0, 1).expand(slab.shape)
                if sign_comps is not None:
                    sgn = self.bsign[fc, list(sign_comps)].to(own.dtype)
                    own = own * sgn.reshape(1, C, 1, 1, 1)
                bm = self.bmask[fc][:, None, None, None, None]
                slab = torch.where(bm, own.to(slab.dtype), slab)
                if self.cf_rows[fc].shape[1]:
                    halo = coarse_halo_rows(
                        extf, fc, self.cf_src[fc], self.cf_toff[fc],
                        self.interp_t, self.interp_n_lo, self.interp_n_hi, bs)
                    # one scratch row per shard absorbs padded rows
                    s2 = shard_view(slab, D)
                    s2 = torch.cat([s2, s2.new_zeros(
                        (D, 1) + tuple(slab.shape[1:]))], dim=1)
                    put_rows(s2, self.cf_rows[fc], halo.to(slab.dtype))
                    slab = unshard_view(s2[:, :nbs])
                _place(lab, slab, a, hi, w, bs)
        return lab.movedim(1, -1)


def build_sharded_face_tables(forest, width: int) -> ShardedFaceTables:
    """Host table build: shard the global FaceTables of ``forest.grid``."""
    g = forest.grid
    t = g.face_tables(width)  # host (CPU) tables
    if t.fb_rows is not None:
        raise ValueError(
            "sharded face tables: topology has degenerate (closed-boundary "
            "deep-coarsening) blocks; use the per-cell lab tables")
    D, nbs = forest.D, forest.nbs
    nb = g.nb
    sentinel = t.n_entries

    # -- ownership ---------------------------------------------------------
    # leaves: Hilbert cut.  shadows: owner of first child (bottom-up).
    child_groups = [c.numpy().astype(np.int64) for c in t.child_idx]
    starts = list(t.shadow_starts)
    owner: Dict[int, int] = {e: min(e // nbs, D - 1) for e in range(nb)}
    for ci, start in zip(child_groups, starts):  # deepest first
        for r in range(ci.shape[0]):
            owner[start + r] = owner[int(ci[r, 0])]

    # per-shard shadow slots (padded to ns_max)
    shadows_of: List[List[int]] = [[] for _ in range(D)]
    for ci, start in zip(child_groups, starts):
        for r in range(ci.shape[0]):
            shadows_of[owner[start + r]].append(start + r)
    ns_max = max([len(sh) for sh in shadows_of] + [1])
    space = _EntrySpace(D, nbs, ns_max)
    space.owner = owner
    for e in range(nb):
        space.slot[e] = e - owner[e] * nbs
    for s in range(D):
        for j, e in enumerate(shadows_of[s]):
            space.slot[e] = nbs + j

    # -- pyramid exchange plans (deepest group first) ----------------------
    plans = []
    for ci, start in zip(child_groups, starts):
        nsg = ci.shape[0]
        # which remote children does each shard need for THIS group
        needed = [set() for _ in range(D)]
        rows_of: List[List[int]] = [[] for _ in range(D)]
        for r in range(nsg):
            s = owner[start + r]
            rows_of[s].append(r)
            for c in ci[r]:
                c = int(c)
                if owner[c] != s:
                    needed[s].add(c)
        send_idx, M = _plan_exchange(space, needed, D)
        nsg_max = max([len(r) for r in rows_of] + [1])
        plans.append((ci, start, send_idx, M, rows_of, nsg_max))

    # -- final exchange: face srcs + coarse windows ------------------------
    src = t.src.numpy().astype(np.int64)  # (6, nb)
    needed_final = [set() for _ in range(D)]
    for fcb in range(6):
        for b in range(nb):
            s = owner[b]
            e = int(src[fcb, b])
            if e != sentinel and owner[e] != s:
                needed_final[s].add(e)
    cf_lists = []
    for fc in range(6):
        rows = t.cf_rows[fc].numpy().astype(np.int64)
        src8 = t.cf_src[fc].numpy().astype(np.int64)
        toff = t.cf_toff[fc].numpy().astype(np.int64)
        cf_lists.append((rows, src8, toff))
        for i, b in enumerate(rows):
            s = owner[int(b)]
            for e in src8[i]:
                e = int(e)
                if owner[e] != s:
                    needed_final[s].add(e)
    final_send, final_M = _plan_exchange(space, needed_final, D)
    space.finish()

    # region offsets now that ALL exchanges are planned
    region_offs = []
    off = nbs + ns_max
    for size in space.recv_regions:
        region_offs.append(off)
        off += size
    n_local = space.local_size()
    dev = forest.device

    def on(a, dtype=torch.int64):
        return torch.as_tensor(a, device=dev).to(dtype)

    def plan_of(send_idx, M, recv_off):
        return _ExchangePlan(
            send_idx=send_idx,
            send_rows=(None if send_idx is None
                       else on(stacked_rows(send_idx, n_local))),
            M=M, recv_off=recv_off)

    # -- remap pyramid tables ----------------------------------------------
    groups = []
    for x, (ci, start, send_idx, M, rows_of, nsg_max) in enumerate(plans):
        dst = np.full((D, nsg_max), space.scratch_row(), np.int64)
        child = np.full((D, nsg_max, 8), space.zero_row(), np.int64)
        for s in range(D):
            for j, r in enumerate(rows_of[s]):
                dst[s, j] = space.slot[start + r]
                for c8 in range(8):
                    child[s, j, c8] = space.resolve(int(ci[r, c8]), s,
                                                    sentinel)
        groups.append((on(stacked_rows(dst, n_local)),
                       on(stacked_rows(child, n_local)),
                       plan_of(send_idx, M, region_offs[x])))

    # -- remap face tables -------------------------------------------------
    src_sh = np.full((D, 6, nbs), space.zero_row(), np.int64)
    bmask_sh = np.zeros((D, 6, nbs), bool)
    bmask_g = t.bmask.numpy()
    for b in range(nb):
        s = owner[b]
        ls = space.slot[b]
        for fc in range(6):
            bmask_sh[s, fc, ls] = bmask_g[fc, b]
            src_sh[s, fc, ls] = space.resolve(int(src[fc, b]), s, sentinel)

    cf_rows_sh, cf_src_sh, cf_toff_sh = [], [], []
    for fc in range(6):
        rows, src8, toff = cf_lists[fc]
        per: List[List[int]] = [[] for _ in range(D)]
        for i, b in enumerate(rows):
            per[owner[int(b)]].append(i)
        ncf_max = max([len(p) for p in per] + [0])
        R = np.full((D, ncf_max), nbs, np.int64)  # nbs = scratch slab row
        S8 = np.full((D, ncf_max, 8), space.zero_row(), np.int64)
        TO = np.zeros((D, ncf_max, 2), np.int64)
        for s in range(D):
            for j, i in enumerate(per[s]):
                R[s, j] = space.slot[int(rows[i])]
                TO[s, j] = toff[i]
                for c8 in range(8):
                    S8[s, j, c8] = space.resolve(int(src8[i, c8]), s,
                                                 sentinel)
        cf_rows_sh.append(on(stacked_rows(R, nbs + 1)))
        cf_src_sh.append(on(stacked_rows(S8, n_local).reshape(-1, 8)))
        cf_toff_sh.append(on(TO.reshape(-1, 2)))

    src_st = stacked_rows(src_sh, n_local)
    return ShardedFaceTables(
        width=width,
        bs=g.bs,
        D=D,
        nbs=nbs,
        ns_max=ns_max,
        n_local=n_local,
        zero_row=space.zero_row(),
        groups=tuple(groups),
        final_plan=plan_of(final_send, final_M, region_offs[-1]),
        src_idx=src_sh,
        src=tuple(on(src_st[:, fc]) for fc in range(6)),
        bmask=on(bmask_sh.transpose(1, 0, 2).reshape(6, D * nbs), torch.bool),
        bsign=t.bsign.to(dev),
        cf_rows=tuple(cf_rows_sh),
        cf_src=tuple(cf_src_sh),
        cf_toff=tuple(cf_toff_sh),
        interp_t=t.interp_t.to(dev),
        interp_n_lo=t.interp_n_lo.to(dev),
        interp_n_hi=t.interp_n_hi.to(dev),
    )
