"""Face-structured halo assembly for axis-stencil labs (port of
``cup3d_tpu/grid/faces.py``; reference BlockLab coarse-fine
interpolation, main.cpp:3457-4628).

Every AMR operator of the step (7-point Laplacian, upwind-5 advection,
centered grad/div/curl, face fluxes) reads only axis-aligned face
ghosts.  The tables here assemble exactly those, by block-granular
gathers and dense math:

- a *shadow* entry per internal octree node holds the 8-to-1 average of
  its children, computed bottom-up (deepest level first); with shadows a
  same-level and a finer neighbor both reduce to copying a face slab of
  one "ext" buffer entry;
- a coarser neighbor interpolates from a 2x2x2 window of coarse entries
  around the face with the separable quadratic of grid/blocks.py;
- closed domain boundaries clamp the block's own edge plane
  (zero-gradient) with per-component sign flips;
- blocks whose coarse interpolation window crosses a closed boundary fall
  back to a row subset of the per-cell LabTables (none on periodic
  domains).

The host build is the JAX package's numpy code; the assembly is torch.
The resulting lab has ZERO edge/corner ghosts.  Every table index is in
range (missing sources point at the zero sentinel entry), so no gather
relies on clamping and no scatter on dropping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.grid.uniform import BC

__all__ = ["FaceTables", "build_face_tables", "pad_face_tables"]


def _cw(w: int) -> int:
    # coarse halo depth, same rule as blocks.py _build_lab_tables
    return max(2, (w + 1) // 2 + 1)


@dataclass
class FaceTables:
    """Device tables for face-slab halo assembly on one (topology, width).

    Duck-compatible with LabTables: ``width``, ``assemble_scalar``,
    ``assemble_vector``, ``assemble_component``.
    """

    width: int
    bs: int
    nb: int
    # restriction pyramid: per level group (deepest first) the (ns_g, 8)
    # child entry indices; group g owns ext slots [starts[g], +ns_g)
    child_idx: Tuple[torch.Tensor, ...]
    shadow_starts: Tuple[int, ...]
    n_entries: int  # nb + total shadows (the zero sentinel is n_entries)
    src: torch.Tensor  # (6, nb) int32 ext entry per face
    bmask: torch.Tensor  # (6, nb) bool: closed-boundary face (clamp rows)
    bsign: torch.Tensor  # (6, 3) f32 per-face, per-component BC signs
    # coarse faces, compacted per face
    cf_rows: Tuple[torch.Tensor, ...]  # 6 x (ncf_f,) int64 block rows
    cf_src: Tuple[torch.Tensor, ...]  # 6 x (ncf_f, 8) int32 window entries
    cf_toff: Tuple[torch.Tensor, ...]  # 6 x (ncf_f, 2) int64 tangential offs
    interp_t: torch.Tensor  # (bs, S) tangential quadratic weights
    interp_n_lo: torch.Tensor  # (w, cw+1) normal weights, low-side face
    interp_n_hi: torch.Tensor  # (w, cw+1) normal weights, high-side face
    # degenerate blocks: row subset of the per-cell tables
    fb_rows: Optional[torch.Tensor]  # (nbi,) int64 or None
    fb_tables: Optional[object]  # LabTables subset (nbi rows) or None

    # the component axis rides through the whole assembly (one
    # restriction pyramid + one gather pipeline for all 3 components)

    def assemble_scalar(self, field: torch.Tensor, bs: int) -> torch.Tensor:
        return _assemble_multi(self, field[..., None], None)[..., 0]

    def assemble_vector(self, field: torch.Tensor, bs: int) -> torch.Tensor:
        return _assemble_multi(self, field, (0, 1, 2))

    def assemble_component(self, field: torch.Tensor, bs: int,
                           comp: int) -> torch.Tensor:
        return _assemble_multi(self, field[..., None], (comp,))[..., 0]


# ---------------------------------------------------------------------------
# host builder
# ---------------------------------------------------------------------------


def build_face_tables(grid, width: int, device="cpu") -> FaceTables:
    """Build FaceTables for ``grid`` (a BlockGrid) at stencil width
    ``width`` on ``device``.  Pure host work, then one upload."""
    from cup3d_tpu_torch.grid.blocks import BlockGrid

    tree = grid.tree
    bs = grid.bs
    w = width
    cw = _cw(w)
    cbs = bs // 2
    S = cbs + 2 * cw
    nb = grid.nb
    L = bs + 2 * w

    # -- shadow slots: internal nodes grouped by level, deepest first ------
    internal = sorted(tree.internal_nodes(), key=lambda k: -k[0])
    shadow_slot = {}
    for i, key in enumerate(internal):
        shadow_slot[key] = nb + i
    ns = len(internal)
    n_entries = nb + ns
    sentinel = n_entries  # zero block

    def entry_of(key):
        """Ext entry of a block position: leaf slot or shadow slot."""
        s = grid.slot.get(key)
        if s is not None:
            return s
        return shadow_slot.get(key)

    child_idx: List[np.ndarray] = []
    shadow_starts: List[int] = []
    i = 0
    while i < ns:
        l = internal[i][0]
        j = i
        while j < ns and internal[j][0] == l:
            j += 1
        rows = np.empty((j - i, 8), np.int32)
        for r, (lv, bi, bj, bk) in enumerate(internal[i:j]):
            for di in (0, 1):
                for dj in (0, 1):
                    for dk in (0, 1):
                        ck = (lv + 1, 2 * bi + di, 2 * bj + dj, 2 * bk + dk)
                        e = entry_of(ck)
                        assert e is not None, f"missing child {ck}"
                        rows[r, di * 4 + dj * 2 + dk] = e
        child_idx.append(rows)
        shadow_starts.append(nb + i)
        i = j

    # -- per-face classification ------------------------------------------
    src = np.full((6, nb), sentinel, np.int32)
    bmask = np.zeros((6, nb), bool)
    bsign = []
    for a in range(3):
        for hi in (0, 1):
            if grid.bc[a] == BC.wall:
                bsign.append((-1.0, -1.0, -1.0))
            elif grid.bc[a] == BC.periodic:
                bsign.append((1.0, 1.0, 1.0))
            else:  # freespace: flip the face-normal component
                s = [1.0, 1.0, 1.0]
                s[a] = -1.0
                bsign.append(tuple(s))

    cf_rows: List[List[int]] = [[] for _ in range(6)]
    cf_src: List[List[List[int]]] = [[] for _ in range(6)]
    cf_toff: List[List[Tuple[int, int]]] = [[] for _ in range(6)]
    irregular: set = set()

    tang = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    for b in range(nb):
        l = int(grid.level[b])
        ijk = grid.ijk[b]
        for a in range(3):
            t1, t2 = tang[a]
            for hi in (0, 1):
                f = 2 * a + hi
                npos = ijk.copy()
                npos[a] += 1 if hi else -1
                wpos = tree.wrap(l, npos)
                if wpos is None:
                    bmask[f, b] = True  # closed boundary: clamp row
                    continue
                own = grid._owner_level_vec(l, np.asarray(wpos)[None])[0]
                if own == l:
                    src[f, b] = grid.slot[(l, *wpos)]
                elif own == l + 1:
                    e = shadow_slot.get((l, *wpos))
                    assert e is not None, "finer neighbor without shadow"
                    src[f, b] = e
                else:  # own == l - 1: coarse face
                    parent = (l - 1, ijk[0] // 2, ijk[1] // 2, ijk[2] // 2)
                    # window base per axis: parent pos, shifted -1 along a
                    # tangential axis when the block sits on the LOW octant
                    base = list(parent[1:])
                    toffs = []
                    for t in (t1, t2):
                        if (ijk[t] & 1) == 0:
                            base[t] -= 1
                            toffs.append(bs - cw)
                        else:
                            toffs.append(cbs - cw)
                    # normal: P side = parent, N side = coarse neighbor
                    ok = True
                    entries = []
                    for side in (0, 1):  # 0 = parent side, 1 = neighbor
                        for o1 in (0, 1):
                            for o2 in (0, 1):
                                p = list(base)
                                p[t1] += o1
                                p[t2] += o2
                                if side:
                                    p[a] += 1 if hi else -1
                                wp = tree.wrap(l - 1, p)
                                if wp is None:
                                    ok = False
                                    break
                                e = entry_of((l - 1, *wp))
                                if e is None:
                                    # region owned >=2 coarser: degenerate
                                    ok = False
                                    break
                                entries.append(e)
                            if not ok:
                                break
                        if not ok:
                            break
                    if not ok:
                        irregular.add(b)
                        continue
                    cf_rows[f].append(b)
                    cf_src[f].append(entries)
                    cf_toff[f].append(tuple(toffs))

    # -- interpolation matrices -------------------------------------------
    W = BlockGrid._interp_matrix(L, S, w, cw)
    Tt = W[w:w + bs, :]  # (bs, S)
    Tn_lo = W[:w, : cw + 1]  # normal coords -cw..0
    Tn_hi = W[w + bs:, S - cw - 1:]  # normal coords cbs-1..cbs+cw-1
    assert not np.any(W[:w, cw + 1:]), "low-face normal support escapes"
    assert not np.any(W[w + bs:, : S - cw - 1]), "hi-face support escapes"

    # -- degenerate blocks: subset of the per-cell tables ------------------
    fb_rows = fb_tables = None
    if irregular:
        rows = np.array(sorted(irregular), np.int64)
        fb_rows = torch.as_tensor(rows, device=device)
        fb_tables = grid.lab_tables(w, device).rows(rows)
        # drop degenerate rows from the dense coarse lists (they are fully
        # overwritten anyway; skipping keeps the window math clean)
        for f in range(6):
            keep = [i for i, r in enumerate(cf_rows[f]) if r not in irregular]
            cf_rows[f] = [cf_rows[f][i] for i in keep]
            cf_src[f] = [cf_src[f][i] for i in keep]
            cf_toff[f] = [cf_toff[f][i] for i in keep]

    def on(x, shape, dtype):
        arr = np.asarray(x, np.int64).reshape(shape)
        return torch.as_tensor(arr, device=device).to(dtype)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return FaceTables(
        width=w, bs=bs, nb=nb,
        child_idx=tuple(on(c, c.shape, torch.int32) for c in child_idx),
        shadow_starts=tuple(shadow_starts),
        n_entries=n_entries,
        src=on(src, src.shape, torch.int32),
        bmask=torch.as_tensor(bmask, device=device),
        bsign=torch.tensor(bsign, dtype=torch.float32, device=device),
        cf_rows=tuple(on(cf_rows[f], (len(cf_rows[f]),), torch.int64)
                      for f in range(6)),
        cf_src=tuple(on(cf_src[f], (len(cf_src[f]), 8), torch.int32)
                     for f in range(6)),
        cf_toff=tuple(on(cf_toff[f], (len(cf_toff[f]), 2), torch.int64)
                      for f in range(6)),
        interp_t=f32(Tt),
        interp_n_lo=f32(Tn_lo),
        interp_n_hi=f32(Tn_hi),
        fb_rows=fb_rows,
        fb_tables=fb_tables,
    )


# ---------------------------------------------------------------------------
# device assembly
# ---------------------------------------------------------------------------


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] along dim 0 for an int32 index of any shape."""
    return arr.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(arr.shape[1:]))


def _restrict8(ch: torch.Tensor, bs: int) -> torch.Tensor:
    """(ns, 8, C, bs,bs,bs) child blocks -> (ns, C, bs,bs,bs) parent
    restriction (exact hierarchical 8-to-1 average).  The 8 fine cells of
    a parent cell are summed by elementwise adds in one fixed order, so
    every parent cell rounds alike whatever the batch (the sharded
    forest restricts per shard what the unsharded one restricts at
    once)."""
    ns, C = ch.shape[0], ch.shape[2]
    h = bs // 2
    acc = None
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                part = ch[..., a::2, b::2, c::2]
                acc = part if acc is None else acc + part
    # (ns, di, dj, dk, C, h,h,h) -> (ns, C, di h, dj h, dk h)
    acc = (acc * 0.125).reshape(ns, 2, 2, 2, C, h, h, h)
    return acc.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(ns, C, bs, bs, bs)


def _ext_buffer(t: FaceTables, fm: torch.Tensor) -> torch.Tensor:
    """(n_entries+1, C, bs, bs, bs): leaves, shadows (bottom-up), zero row."""
    bs = t.bs
    C = fm.shape[1]
    ext = fm.new_zeros((t.n_entries + 1, C, bs, bs, bs))
    ext[: t.nb] = fm
    for ci, start in zip(t.child_idx, t.shadow_starts):
        ext[start:start + ci.shape[0]] = _restrict8(_take(ext, ci), bs)
    return ext


def _slab(arr: torch.Tensor, axis: int, start: int, depth: int):
    """Slab of a block axis, normal axis moved to dim 2: (N, C, d, t1, t2)."""
    return arr.narrow(axis + 2, start, depth).movedim(axis + 2, 2)


def _place(lab: torch.Tensor, slab: torch.Tensor, a: int, hi: int, w: int,
           bs: int) -> None:
    """Write a (nb, C, w, bs, bs) slab into the (nb, C, L,L,L) lab's face
    region, in place."""
    idx = [slice(None)] * 5
    idx[a + 2] = slice(w + bs, w + bs + w) if hi else slice(0, w)
    for t in range(3):
        if t != a:
            idx[t + 2] = slice(w, w + bs)
    lab[tuple(idx)] = slab.movedim(2, a + 2)


def _coarse_halo(t: FaceTables, ext: torch.Tensor, f: int) -> torch.Tensor:
    """(ncf, C, w, bs, bs) interpolated halo slabs for face f's coarse
    rows."""
    return coarse_halo_rows(ext, f, t.cf_src[f], t.cf_toff[f], t.interp_t,
                            t.interp_n_lo, t.interp_n_hi, t.bs)


def coarse_halo_rows(ext: torch.Tensor, f: int, src8: torch.Tensor,
                     toff: torch.Tensor, interp_t: torch.Tensor,
                     interp_n_lo: torch.Tensor, interp_n_hi: torch.Tensor,
                     bs: int) -> torch.Tensor:
    """The coarse halo of face ``f`` for the rows whose 2x2x2 window
    entries are ``src8`` (n, 8) (rows of ``ext``) and whose tangential
    window offsets are ``toff`` (n, 2)."""
    a, hi = f // 2, f % 2
    cw = interp_n_lo.shape[1] - 1
    S = interp_t.shape[1]
    n = src8.shape[0]
    C = ext.shape[1]
    # parent side: ONE plane adjacent to the face; neighbor side: cw planes
    if hi:
        pp = _slab(ext, a, bs - 1, 1)  # parent's last plane
        npl = _slab(ext, a, 0, cw)  # neighbor's first cw planes
    else:
        pp = _slab(ext, a, 0, 1)  # parent's first plane
        npl = _slab(ext, a, bs - cw, cw)  # neighbor's last cw planes

    P = _take(pp, src8[:, 0:4].contiguous())  # (ncf, 4, C, 1, bs, bs)
    N = _take(npl, src8[:, 4:8].contiguous())  # (ncf, 4, C, cw, bs, bs)

    def arrange(x):
        d = x.shape[3]
        y = x.reshape(n, 2, 2, C, d, bs, bs)
        y = y.permute(0, 3, 4, 1, 5, 2, 6)
        return y.reshape(n, C, d, 2 * bs, 2 * bs)

    P16, N16 = arrange(P), arrange(N)
    # ascending coarse normal coordinate
    slab16 = torch.cat([P16, N16] if hi else [N16, P16], dim=2)
    # per-row tangential window: slab16[r, :, :, o0:o0+S, o1:o1+S]
    D = slab16.shape[2]
    ar = torch.arange(S, device=ext.device)
    i0 = (toff[:, 0:1] + ar)[:, None, None, :, None]
    i1 = (toff[:, 1:2] + ar)[:, None, None, None, :]
    win = torch.gather(slab16, 3, i0.expand(n, C, D, S, 2 * bs))
    win = torch.gather(win, 4, i1.expand(n, C, D, S, S))
    Tn = interp_n_hi if hi else interp_n_lo  # (w, cw+1)
    Tt = interp_t  # (bs, S)
    from cup3d_tpu_torch.grid.blocks import require_fp32_matmuls

    require_fp32_matmuls(win)
    # each tensordot appends its output axis:
    # (n,C,d,S,S) -> (n,C,S,S,w) -> (n,C,S,w,bs) -> (n,C,w,bs,bs)
    out = torch.tensordot(win, Tn.to(win.dtype), dims=([2], [1]))
    out = torch.tensordot(out, Tt.to(win.dtype), dims=([2], [1]))
    out = torch.tensordot(out, Tt.to(win.dtype), dims=([2], [1]))
    return out


def _assemble_multi(t: FaceTables, fields: torch.Tensor,
                    sign_comps: Optional[Tuple[int, ...]]) -> torch.Tensor:
    """(nb, bs,bs,bs, C) -> (nb, L,L,L, C) faces-only labs.
    ``sign_comps`` maps each trailing component to its BC-sign component
    (None: scalar semantics, zero-gradient ghosts, no sign flips)."""
    bs, w, nb = t.bs, t.width, t.nb
    L = bs + 2 * w
    C = fields.shape[-1]
    fm = fields.movedim(-1, 1)  # (nb, C, bs,bs,bs)
    ext = _ext_buffer(t, fm)

    lab = fields.new_zeros((nb, C) + (L,) * 3)
    lab[:, :, w:w + bs, w:w + bs, w:w + bs] = fm

    for a in range(3):
        for hi in (0, 1):
            f = 2 * a + hi
            # kind-0: neighbor (leaf or shadow) face slab
            sl = _slab(ext, a, 0, w) if hi else _slab(ext, a, bs - w, w)
            slab = _take(sl, t.src[f])  # (nb, C, w, bs, bs)
            # boundary clamp: own edge plane replicated, with BC sign
            own = _slab(ext[:nb], a, bs - 1 if hi else 0, 1)
            own = own.expand(slab.shape)
            if sign_comps is not None:
                # integer indices: views, no index tensor to upload
                sgn = torch.stack([t.bsign[f, c] for c in sign_comps]
                                  ).to(own.dtype)
                own = own * sgn.reshape(1, C, 1, 1, 1)
            bm = t.bmask[f][:, None, None, None, None]
            slab = torch.where(bm, own.to(slab.dtype), slab)
            # coarse faces: separable quadratic from the coarse window
            if t.cf_rows[f].shape[0]:
                halo = _coarse_halo(t, ext, f)
                slab = slab.index_copy(0, t.cf_rows[f], halo.to(slab.dtype))
            _place(lab, slab, a, hi, w, bs)

    # degenerate rows: the per-cell path, equal to LabTables
    if t.fb_rows is not None:
        from cup3d_tpu_torch.grid import blocks as B

        tb = t.fb_tables
        nfb = t.fb_rows.shape[0]
        for ci in range(C):
            field = fields[..., ci]
            comp = None if sign_comps is None else sign_comps[ci]
            sub = field.index_select(0, t.fb_rows)
            flat = torch.cat([field.reshape(-1), field.new_zeros(1)])
            ghosts = B.gather_weighted(flat, tb.g_idx, tb.g_w)
            if comp is not None:
                ghosts = ghosts * tb.g_sign[..., comp]
            if tb.any_coarse:
                scratch = B.gather_weighted(flat, tb.s_idx, tb.s_w)
                if comp is not None:
                    scratch = scratch * tb.s_sign[..., comp]
                Ssc = tb.interp_w.shape[1]
                interp = B.upsample(scratch.reshape(-1, Ssc, Ssc, Ssc),
                                    tb.interp_w)
                interp_g = interp.reshape(nfb, -1).index_select(
                    1, tb.ghost_flat)
                ghosts = torch.where(tb.mask_coarse, interp_g, ghosts)
            sub_lab = field.new_zeros((nfb,) + (L,) * 3)
            sub_lab[:, w:w + bs, w:w + bs, w:w + bs] = sub
            sub_lab.view(nfb, -1).index_copy_(1, tb.ghost_flat,
                                              ghosts.to(field.dtype))
            lab[t.fb_rows, ci] = sub_lab
    return lab.movedim(1, -1)


# ---------------------------------------------------------------------------
# capacity-bucketed padding (grid/bucket.py): same-shape tables across
# regrids that stay within a bucket
# ---------------------------------------------------------------------------


def pad_face_tables(t: FaceTables, grid, cap: int,
                    device=None) -> FaceTables:
    """Pad ``t`` (built for ``grid``, ``grid.nb`` real blocks) to block
    capacity ``cap`` (> nb) with INERT rows, bucketing every auxiliary
    row count up its own ladder (grid/bucket.py); the padded tables land
    on ``device`` (default: ``t``'s).

    Inertness: padding blocks' face sources point at the zero sentinel
    (their labs assemble to 0); padded shadow-group rows restrict zeros
    into padded shadow slots; padded coarse-face rows interpolate zeros
    and write them into the last padding block (``cap - 1``), whose lab
    is zero anyway; padded fallback rows gather the sentinel and write
    into the same dump block.  The JAX package's ``pad_face_tables``
    (the same entry layout and shadow ordering)."""
    from cup3d_tpu_torch.grid import bucket as bk
    from cup3d_tpu_torch.grid.blocks import LabTables

    nb, bs, w = t.nb, t.bs, t.width
    if cap <= nb:
        raise ValueError(f"capacity {cap} must exceed nb={nb} "
                         "(>= 1 padding block is the dump-target invariant)")
    dev = t.src.device if device is None else torch.device(device)

    def host(x):
        return x.detach().cpu().numpy().astype(np.int64)

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    tree = grid.tree
    level_max = tree.cfg.level_max
    # the build's own expression: the same shadow ordering
    internal = sorted(tree.internal_nodes(), key=lambda k: -k[0])
    counts: dict = {}
    for k in internal:
        counts[k[0]] = counts.get(k[0], 0) + 1
    # one group per possible parent level, deepest first, ALWAYS emitted
    # (empty levels keep shape (0, 8)) so the group order is bucket-stable
    levels = list(range(level_max - 2, -1, -1))
    caps_g = [bk.count_capacity(counts.get(l, 0)) for l in levels]
    starts_new, off = [], 0
    for c in caps_g:
        starts_new.append(cap + off)
        off += c
    n_entries_new = cap + off
    sent_new = n_entries_new

    # old entry index -> padded entry index
    remap = np.empty(t.n_entries + 1, np.int64)
    remap[:nb] = np.arange(nb)
    level_pos = dict(zip(levels, starts_new))
    seen: dict = {}
    for i, key in enumerate(internal):
        l = key[0]
        o = seen.get(l, 0)
        seen[l] = o + 1
        remap[nb + i] = level_pos[l] + o
    remap[t.n_entries] = sent_new

    present = sorted({k[0] for k in internal}, reverse=True)
    child_new = []
    for li, l in enumerate(levels):
        cnt = counts.get(l, 0)
        rows = np.full((caps_g[li], 8), sent_new, np.int64)
        if cnt:
            rows[:cnt] = remap[host(t.child_idx[present.index(l)])]
        child_new.append(on(rows, torch.int32))

    src_new = np.full((6, cap), sent_new, np.int64)
    src_new[:, :nb] = remap[host(t.src)]
    bmask_new = np.zeros((6, cap), bool)
    bmask_new[:, :nb] = t.bmask.cpu().numpy()

    dump_row = cap - 1  # guaranteed padding block
    cf_rows_new, cf_src_new, cf_toff_new = [], [], []
    for f in range(6):
        rows = host(t.cf_rows[f])
        n = rows.shape[0]
        c = bk.count_capacity(n)
        r2 = np.full(c, dump_row, np.int64)
        s2 = np.full((c, 8), sent_new, np.int64)
        o2 = np.zeros((c, 2), np.int64)
        if n:
            r2[:n] = rows
            s2[:n] = remap[host(t.cf_src[f])]
            o2[:n] = host(t.cf_toff[f])
        cf_rows_new.append(on(r2, torch.int64))
        cf_src_new.append(on(s2, torch.int32))
        cf_toff_new.append(on(o2, torch.int64))

    fb_rows = fb_tables = None
    if t.fb_rows is not None:
        old_rows = host(t.fb_rows)
        c = bk.count_capacity(old_rows.shape[0])
        fb_rows = on(bk.pad_rows(old_rows, c, fill=dump_row), torch.int64)
        tb = t.fb_tables
        cell_sent_old = nb * bs**3
        cell_sent_new = cap * bs**3

        def cells(idx):
            v = host(idx)
            v[v >= cell_sent_old] = cell_sent_new
            return on(bk.pad_rows(v, c, fill=cell_sent_new), torch.int32)

        def rows_of(x, fill):
            return on(bk.pad_rows(x.cpu().numpy(), c, fill=fill), x.dtype)

        fb_tables = LabTables(
            width=tb.width, ghost_flat=tb.ghost_flat.to(dev),
            g_idx=cells(tb.g_idx), g_w=rows_of(tb.g_w, 0.0),
            g_sign=rows_of(tb.g_sign, 1.0),
            mask_coarse=rows_of(tb.mask_coarse, False),
            s_idx=cells(tb.s_idx), s_w=rows_of(tb.s_w, 0.0),
            s_sign=rows_of(tb.s_sign, 1.0),
            interp_w=tb.interp_w.to(dev), any_coarse=tb.any_coarse)

    return FaceTables(
        width=w, bs=bs, nb=cap,
        child_idx=tuple(child_new),
        shadow_starts=tuple(starts_new),
        n_entries=n_entries_new,
        src=on(src_new, torch.int32),
        bmask=on(bmask_new, torch.bool),
        bsign=t.bsign.to(dev),
        cf_rows=tuple(cf_rows_new),
        cf_src=tuple(cf_src_new),
        cf_toff=tuple(cf_toff_new),
        interp_t=t.interp_t.to(dev),
        interp_n_lo=t.interp_n_lo.to(dev),
        interp_n_hi=t.interp_n_hi.to(dev),
        fb_rows=fb_rows,
        fb_tables=fb_tables,
    )
