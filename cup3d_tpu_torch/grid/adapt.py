"""Mesh adaptation: tag -> 2:1 validation -> refine/compress -> re-layout
(port of ``cup3d_tpu/grid/adapt.py``; reference MeshAdaptation,
main.cpp:5023-5583).

Adaptation is a layout change.  The host tags blocks from per-block
scores, enforces the reference's 2:1/octet rules (ValidStates), builds a
new Octree + BlockGrid and a TransferPlan of index arrays (numpy, copied
from the JAX package).  Fields move in three batched torch steps:

- copy: gather surviving blocks into their new slots;
- refine: quadratic tensor-product prolongation of each refined block's
  1-ghost lab (grid/blocks.py LabTables, corners included) into 8
  children, three f32 tensordots;
- compress: 2x2x2 average of 8 children into the parent.

The bucketed forest takes the regrid DECISION on the device
(``device_tags``: one int8 tag a slot) and the host decodes the small
tag vector (``states_from_tags``); the unpadded and sharded forests tag
on the host from the scores (``tag_states``), which gives the same
states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.grid.blocks import _WQ, BlockGrid, require_fp32_matmuls
from cup3d_tpu_torch.grid.octree import Key, Octree


# ---------------------------------------------------------------------------
# tagging + 2:1 validation (host)
# ---------------------------------------------------------------------------


def tag_states(grid: BlockGrid, score: np.ndarray, rtol: float, ctol: float,
               level_max_block: Optional[np.ndarray] = None) -> Dict[Key, str]:
    """Per-leaf desired state from per-block scores (TagLoadedBlock,
    main.cpp:5566-5582): 'R' if score > rtol, 'C' if score < ctol, else
    'L'.  level_max_block: optional per-block cap on refinement level."""
    states: Dict[Key, str] = {}
    lm = grid.tree.cfg.level_max
    for s, key in enumerate(grid.keys):
        lvl = key[0]
        cap = lm - 1 if level_max_block is None else int(level_max_block[s])
        if score[s] > rtol and lvl < cap:
            states[key] = "R"
        elif score[s] < ctol and lvl > 0:
            states[key] = "C"
        else:
            states[key] = "L"
    return states


def device_tags(vort: torch.Tensor, near: Optional[torch.Tensor],
                level: torch.Tensor, rtol: float, ctol: float,
                level_max: int, level_max_vort: int,
                chi_inf: bool) -> torch.Tensor:
    """The device mirror of tag_states: per-slot int8 tag (1=R, -1=C,
    0=L).

    Inputs are per-slot tensors over the padded bucket: ``vort`` the
    vorticity score, ``near`` the grad-chi mask (None: no body, all
    False), ``level`` the octree level of each slot (padding slots carry
    level 0 and score 0, so they tag 'L').  As the JAX package's and
    sim/amr.py's host tagging: the per-block level cap is levelMax-1 near
    a body and levelMaxVorticity-1 away from it, the score goes to inf
    near a body only under bAdaptChiGradient (``chi_inf``); comparisons
    are strict in f32 and refine wins over coarsen."""
    score = vort.to(torch.float32)
    nearb = (torch.zeros_like(score, dtype=torch.bool) if near is None
             else near.to(torch.bool))
    if chi_inf:
        score = torch.where(nearb, torch.full_like(score, float("inf")),
                            score)
    cap = torch.where(nearb, level_max - 1, level_max_vort - 1).to(
        level.dtype)
    refine = (score > rtol) & (level < cap)
    coarsen = (score < ctol) & (level > 0)
    one = torch.ones((), dtype=torch.int8, device=score.device)
    return torch.where(refine, one, torch.where(coarsen, -one, 0 * one))


def states_from_tags(grid: BlockGrid, tags: np.ndarray) -> Dict[Key, str]:
    """Decode device_tags output (the real blocks' slots, on the host)
    into the {key: 'R'/'C'/'L'} dict that valid_states/adapt consume."""
    sym = {1: "R", -1: "C", 0: "L"}
    return {key: sym[int(tags[s])] for s, key in enumerate(grid.keys)}


def valid_states(tree: Octree, states: Dict[Key, str]) -> Dict[Key, str]:
    """Enforce refinement/compression legality (ValidStates,
    main.cpp:5330-5492):

    1. refinement propagates: a leaf one level coarser next to a refining
       block must refine too (keeps 26-neighbor 2:1 after refinement);
    2. a refining or finer neighbor vetoes a neighbor's compression;
    3. compression requires the full octet of same-level sibling leaves,
       all marked 'C'.
    """
    st = dict(states)
    levels = sorted({k[0] for k in tree.leaves}, reverse=True)

    # 1: sweep fine -> coarse so forced refinements cascade downward
    for l in levels:
        for key in [k for k in tree.leaves if k[0] == l and st.get(k) == "R"]:
            _, i, j, k_ = key
            for dk in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    for di in (-1, 0, 1):
                        if di == dj == dk == 0:
                            continue
                        w = tree.wrap(l, (i + di, j + dj, k_ + dk))
                        if w is None:
                            continue
                        parent = (l - 1, w[0] // 2, w[1] // 2, w[2] // 2)
                        if l > 0 and parent in tree.leaves:
                            st[parent] = "R"

    # 2+3: compression legality
    for key in list(tree.leaves):
        if st.get(key) != "C":
            continue
        l, i, j, k_ = key
        ok = True
        sibs = tree.siblings(key)
        for s in sibs:
            if s not in tree.leaves or st.get(s) != "C":
                ok = False
                break
        if ok:
            # neighbors of the parent region must end up <= level l
            for dk in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    for di in (-1, 0, 1):
                        if not ok:
                            break
                        if di == dj == dk == 0:
                            continue
                        for s in sibs:
                            w = tree.wrap(l, (s[1] + di, s[2] + dj, s[3] + dk))
                            if w is None:
                                continue
                            nk = (l, *w)
                            if nk in [tuple(x) for x in sibs]:
                                continue
                            # finer coverage at any depth, or a same-level
                            # neighbor that will refine, vetoes
                            if tree.covered_finer(nk):
                                ok = False
                                break
                            if nk in tree.leaves and st.get(nk) == "R":
                                ok = False
                                break
        if not ok:
            for s in sibs:
                if s in tree.leaves and st.get(s) == "C":
                    st[s] = "L"
    return st


# ---------------------------------------------------------------------------
# transfer plan + field movement
# ---------------------------------------------------------------------------


@dataclass
class TransferPlan:
    new_grid: BlockGrid
    copy_src: np.ndarray  # (ncopy,)
    copy_dst: np.ndarray
    ref_src: np.ndarray  # (nref,) old slots to prolong
    ref_dst: np.ndarray  # (nref, 8) new child slots (octant-ordered)
    com_src: np.ndarray  # (ncom, 8) old child slots (octant-ordered)
    com_dst: np.ndarray  # (ncom,) new parent slots
    refine_w: np.ndarray  # (2*bs, bs+2) prolongation matrix


def _octant_children(key: Key) -> List[Key]:
    """Children ordered so octant index = di*4 + dj*2 + dk."""
    l, i, j, k = key
    return [
        (l + 1, 2 * i + di, 2 * j + dj, 2 * k + dk)
        for di in (0, 1)
        for dj in (0, 1)
        for dk in (0, 1)
    ]


def adapt(grid: BlockGrid, states: Dict[Key, str]) -> Optional[TransferPlan]:
    """Build the new grid + transfer plan; None if nothing changes."""
    states = valid_states(grid.tree, states)
    refining = [k for k, s in states.items() if s == "R"]
    compressing = {k for k, s in states.items() if s == "C"}
    if not refining and not compressing:
        return None

    new_tree = Octree(grid.tree.cfg, 0)
    new_tree.leaves.clear()
    ref_children: Dict[Key, List[Key]] = {}
    done_octets: Set[Key] = set()
    com_groups: List[Tuple[Key, List[Key]]] = []  # (parent, children)

    for key in grid.keys:
        s = states.get(key, "L")
        if s == "R":
            kids = _octant_children(key)
            ref_children[key] = kids
            for c in kids:
                new_tree.leaves[c] = None
        elif s == "C":
            l, i, j, k = key
            parent = (l - 1, i // 2, j // 2, k // 2)
            if parent in done_octets:
                continue
            done_octets.add(parent)
            kids = _octant_children(parent)
            com_groups.append((parent, kids))
            new_tree.leaves[parent] = None
        else:
            new_tree.leaves[key] = None

    new_tree.assert_balanced()
    new_grid = BlockGrid(new_tree, grid.extent, grid.bc, grid.bs)

    copy_src, copy_dst = [], []
    for key in grid.keys:
        if states.get(key, "L") == "L" and key in new_grid.slot:
            copy_src.append(grid.slot[key])
            copy_dst.append(new_grid.slot[key])

    ref_src = [grid.slot[k] for k in ref_children]
    ref_dst = [[new_grid.slot[c] for c in kids]
               for kids in ref_children.values()]
    com_src = [[grid.slot[c] for c in kids] for _, kids in com_groups]
    com_dst = [new_grid.slot[p] for p, _ in com_groups]

    bs = grid.bs
    W = np.zeros((2 * bs, bs + 2), np.float32)
    for f in range(2 * bs):
        p = f // 2 + 1  # lab coordinate of the parent cell (1-ghost lab)
        for d, wq in zip((-1, 0, 1), _WQ[f & 1]):
            W[f, p + d] += wq

    def idx(a, shape):
        return np.asarray(a, np.int64).reshape(shape)

    return TransferPlan(
        new_grid=new_grid,
        copy_src=idx(copy_src, (-1,)),
        copy_dst=idx(copy_dst, (-1,)),
        ref_src=idx(ref_src, (-1,)),
        ref_dst=idx(ref_dst, (-1, 8)),
        com_src=idx(com_src, (-1, 8)),
        com_dst=idx(com_dst, (-1,)),
        refine_w=W,
    )


def _upsample3(lab: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(n, bs+2,bs+2,bs+2) labs -> (n, 2bs,2bs,2bs), in full f32."""
    require_fp32_matmuls(lab)
    out = lab
    for axis in (1, 2, 3):
        out = torch.tensordot(out, W, dims=([axis], [1])).movedim(-1, axis)
    return out


def transfer_field(grid: BlockGrid, plan: TransferPlan,
                   field: torch.Tensor) -> torch.Tensor:
    """Move a scalar (nb,bs,bs,bs) or vector (nb,bs,bs,bs,3) field onto the
    adapted layout."""
    if field.ndim == 5:
        return torch.stack([_transfer_scalar(grid, plan, field[..., c], c)
                            for c in range(3)], dim=-1)
    return _transfer_scalar(grid, plan, field, None)


def _transfer_scalar(grid: BlockGrid, plan: TransferPlan,
                     field: torch.Tensor, comp: Optional[int]):
    bs = grid.bs
    dev = field.device

    def on(a):
        return torch.as_tensor(a, device=dev)

    out = field.new_zeros((plan.new_grid.nb, bs, bs, bs))
    out[on(plan.copy_dst)] = field[on(plan.copy_src)]

    if plan.ref_src.shape[0]:
        tab = grid.lab_tables(1, dev)
        lab = (tab.assemble_scalar(field, bs) if comp is None
               else tab.assemble_component(field, bs, comp))
        W = on(plan.refine_w).to(field.dtype)
        fine = _upsample3(lab[on(plan.ref_src)], W)  # (r, 2bs,2bs,2bs)
        ref_dst = on(plan.ref_dst)
        for o in range(8):
            di, dj, dk = o >> 2 & 1, o >> 1 & 1, o & 1
            out[ref_dst[:, o]] = fine[:, di * bs:(di + 1) * bs,
                                      dj * bs:(dj + 1) * bs,
                                      dk * bs:(dk + 1) * bs]

    if plan.com_src.shape[0]:
        kids = field[on(plan.com_src)]  # (c, 8, bs,bs,bs)
        half = bs // 2
        avg = kids.reshape(-1, 8, half, 2, half, 2, half, 2).mean(
            dim=(3, 5, 7))  # (c, 8, half,half,half)
        parent = field.new_zeros((avg.shape[0], bs, bs, bs))
        for o in range(8):
            di, dj, dk = o >> 2 & 1, o >> 1 & 1, o & 1
            parent[:, di * half:(di + 1) * half, dj * half:(dj + 1) * half,
                   dk * half:(dk + 1) * half] = avg[:, o]
        out[on(plan.com_dst)] = parent
    return out
