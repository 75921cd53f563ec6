"""Host-side octree-of-blocks topology (reference Grid/TreePosition/Info,
main.cpp:320-427, 815-1080, and the 2:1 validation logic of
MeshAdaptation::ValidStates, main.cpp:5330-5492).

The tree is pure-Python/NumPy bookkeeping: a set of leaf keys
``(level, i, j, k)`` over a base of ``bpd`` level-0 blocks per dimension.
It never touches device memory — its products are *ordered leaf lists* and
*owner lookups* that the gather-table builder (grid/blocks.py) consumes.

Domain periodicity lives here (block-index wrapping); non-periodic faces
return OUTSIDE from owner lookups and the table builder applies BC rules.

A numpy copy of ``cup3d_tpu/grid/octree.py``: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from cup3d_tpu_torch.grid.sfc import global_order_key

Key = Tuple[int, int, int, int]  # (level, i, j, k)

OUTSIDE = (-1, -1, -1, -1)


@dataclass(frozen=True)
class TreeConfig:
    bpd: Tuple[int, int, int]  # level-0 blocks per dimension
    level_max: int  # number of levels (levels are 0..level_max-1)
    periodic: Tuple[bool, bool, bool]


class _LeafDict(dict):
    """Insertion-ordered leaf set that version-stamps every mutation so the
    derived ancestor set can be rebuilt lazily (callers — adapt.py, tests —
    mutate ``tree.leaves`` directly)."""

    __slots__ = ("version",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.version = 0

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self.version += 1

    def __delitem__(self, k):
        super().__delitem__(k)
        self.version += 1

    def clear(self):
        super().clear()
        self.version += 1

    def pop(self, *a):
        self.version += 1
        return super().pop(*a)

    def update(self, *a, **kw):
        super().update(*a, **kw)
        self.version += 1

    def setdefault(self, *a):
        self.version += 1
        return super().setdefault(*a)

    def popitem(self):
        self.version += 1
        return super().popitem()

    def __ior__(self, other):
        self.version += 1
        return super().__ior__(other)


class Octree:
    """Mutable forest of octrees with 26-neighbor 2:1 balance.

    'Covered finer' queries are answered by exact membership in the set of
    *internal nodes* (strict ancestors of leaves) — the analogue of the
    reference's tree-state CheckFiner (main.cpp:320-330), which is tree
    state, not a corner-child probe.
    """

    def __init__(self, cfg: TreeConfig, level_start: int = 0):
        self.cfg = cfg
        self.leaves: Dict[Key, None] = _LeafDict()  # insertion-ordered set
        self._anc_version = -1
        self._anc_set: set = set()
        if level_start >= cfg.level_max or level_start < 0:
            raise ValueError(f"level_start {level_start} outside levels")
        n = [b << level_start for b in cfg.bpd]
        for i in range(n[0]):
            for j in range(n[1]):
                for k in range(n[2]):
                    self.leaves[(level_start, i, j, k)] = None

    # -- internal-node (ancestor) set --------------------------------------

    def _ancestors(self) -> set:
        """Set of strict ancestors of all leaves, rebuilt on demand."""
        if self._anc_version != self.leaves.version:
            anc: set = set()
            for (l, i, j, k) in self.leaves:
                while l > 0:
                    l, i, j, k = l - 1, i >> 1, j >> 1, k >> 1
                    key = (l, i, j, k)
                    if key in anc:
                        break
                    anc.add(key)
            self._anc_set = anc
            self._anc_version = self.leaves.version
        return self._anc_set

    def covered_finer(self, key: Key) -> bool:
        """True iff the block position is covered by strictly finer leaves
        (i.e. is an internal node of the tree)."""
        return key in self._ancestors()

    def internal_nodes(self) -> Iterable[Key]:
        return self._ancestors()

    # -- geometry helpers --------------------------------------------------

    def blocks_per_dim(self, level: int) -> Tuple[int, int, int]:
        return tuple(b << level for b in self.cfg.bpd)

    def wrap(self, level: int, ijk) -> Optional[Tuple[int, int, int]]:
        """Periodic wrap of block coords; None if outside a closed face."""
        n = self.blocks_per_dim(level)
        out = []
        for a in range(3):
            v = ijk[a]
            if v < 0 or v >= n[a]:
                if not self.cfg.periodic[a]:
                    return None
                v %= n[a]
            out.append(v)
        return tuple(out)

    # -- ownership ---------------------------------------------------------

    def is_leaf(self, key: Key) -> bool:
        return key in self.leaves

    def owner_of(self, level: int, ijk) -> Key:
        """The leaf covering block position (level, ijk): the key itself, its
        parent (coarser), or the key of the *finer* marker (the position is an
        internal node).  Returns OUTSIDE past a closed boundary.  With 2:1
        balance the answer is always within one level (reference TreePosition
        CheckFiner/CheckCoarser, main.cpp:320-330)."""
        w = self.wrap(level, ijk)
        if w is None:
            return OUTSIDE
        key = (level, *w)
        if key in self.leaves:
            return key
        if level > 0:
            parent = (level - 1, w[0] // 2, w[1] // 2, w[2] // 2)
            if parent in self.leaves:
                return parent
        if self.covered_finer(key):
            return key  # covered by finer blocks; caller resolves children
        raise KeyError(f"no owner for block {(level, *w)}: tree not 2:1 balanced?")

    def owner_level(self, level: int, ijk) -> int:
        """-2 outside; level+1 if the position is covered by finer leaves
        (at any depth — the caller descends); else the covering leaf level."""
        w = self.wrap(level, ijk)
        if w is None:
            return -2
        key = (level, *w)
        if key in self.leaves:
            return level
        if level > 0 and (level - 1, w[0] // 2, w[1] // 2, w[2] // 2) in self.leaves:
            return level - 1
        if self.covered_finer(key):
            return level + 1
        raise KeyError(f"no owner for block {(level, *w)}")

    # -- ordering ----------------------------------------------------------

    def ordered_leaves(self) -> List[Key]:
        """Leaves sorted by the cross-level Hilbert key (the reference's
        FillPos global ordering, main.cpp:1030-1060)."""
        keys = list(self.leaves)
        lv = np.array([k[0] for k in keys])
        ijk = np.array([k[1:] for k in keys])
        order = np.argsort(
            global_order_key(lv, ijk, self.cfg.level_max, self.cfg.bpd),
            kind="stable",
        )
        return [keys[int(o)] for o in order]

    # -- topology surgery (used by MeshAdaptation) -------------------------

    def refine(self, key: Key) -> List[Key]:
        """Split a leaf into its 8 children (reference refine_1,
        main.cpp:5227-5271)."""
        level, i, j, k = key
        if level + 1 >= self.cfg.level_max:
            raise ValueError(f"cannot refine {key}: at level_max")
        del self.leaves[key]
        children = [
            (level + 1, 2 * i + di, 2 * j + dj, 2 * k + dk)
            for dk in (0, 1)
            for dj in (0, 1)
            for di in (0, 1)
        ]
        for c in children:
            self.leaves[c] = None
        return children

    def compress(self, key: Key) -> Key:
        """Merge the 8 siblings of `key` (any child of the octet) into the
        parent (reference compress, main.cpp:5272-5328)."""
        level, i, j, k = key
        if level == 0:
            raise ValueError("cannot compress level-0 block")
        parent = (level - 1, i // 2, j // 2, k // 2)
        for dk in (0, 1):
            for dj in (0, 1):
                for di in (0, 1):
                    c = (level, 2 * parent[1] + di, 2 * parent[2] + dj,
                         2 * parent[3] + dk)
                    del self.leaves[c]
        self.leaves[parent] = None
        return parent

    def siblings(self, key: Key) -> List[Key]:
        level, i, j, k = key
        p = (i // 2 * 2, j // 2 * 2, k // 2 * 2)
        return [
            (level, p[0] + di, p[1] + dj, p[2] + dk)
            for dk in (0, 1)
            for dj in (0, 1)
            for di in (0, 1)
        ]

    def assert_balanced(self) -> None:
        """26-neighbor 2:1 balance.  A neighbor region covered finer is only
        legal if every sub-block *touching this leaf* is a leaf at level+1 —
        a touching sub-block that is itself internal means level+2 cells
        adjoin a level-`level` leaf."""
        anc = self._ancestors()
        for key in self.leaves:
            level, i, j, k = key
            for dk in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    for di in (-1, 0, 1):
                        if di == dj == dk == 0:
                            continue
                        w = self.wrap(level, (i + di, j + dj, k + dk))
                        if w is None:
                            continue
                        nk = (level, *w)
                        if nk in self.leaves:
                            continue
                        if level > 0 and (
                            level - 1, w[0] // 2, w[1] // 2, w[2] // 2
                        ) in self.leaves:
                            continue
                        if nk not in anc:
                            raise AssertionError(f"broken tree at {key}: "
                                                 f"neighbor {nk} uncovered")
                        # children of nk facing back at this leaf
                        for oi in ((1,) if di < 0 else (0,) if di > 0 else (0, 1)):
                            for oj in ((1,) if dj < 0 else (0,) if dj > 0 else (0, 1)):
                                for ok in ((1,) if dk < 0 else (0,) if dk > 0 else (0, 1)):
                                    c = (level + 1, 2 * w[0] + oi,
                                         2 * w[1] + oj, 2 * w[2] + ok)
                                    if c in anc:
                                        raise AssertionError(
                                            f"2:1 violation at {key}: touching "
                                            f"neighbor child {c} covered finer")
                                    if c not in self.leaves:
                                        raise AssertionError(
                                            f"broken tree at {key}: child {c} "
                                            f"of {nk} missing")
