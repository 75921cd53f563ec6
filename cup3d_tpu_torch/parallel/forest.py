"""Block-axis sharding of the AMR forest (port of
``cup3d_tpu/parallel/forest.py``; the reference's GridMPI partition,
SynchronizerMPI_AMR halo engine and FluxCorrectionMPI, main.cpp:1515-
3364).

Blocks in cross-level Hilbert order are cut into D contiguous chunks of
``nbs`` blocks, one per shard; every field pads its block axis to
``nb_pad = D * nbs`` with zero rows.  For each (topology, stencil width)
the host computes once which remote cells each shard's halo gathers
touch; an assembly then runs

    local gather (pack) -> exchange -> local gather (unpack)

over all shards at once: the shards are a leading batch axis of one
tensor on one device (parallel/compat.py), the exchange the swap of the
send buffer's two shard axes.  Padding blocks route every halo to the
zero sentinel, so their labs assemble to 0 and the operators of
ops/amr_ops.py, which call only the assembly protocol (``assemble_*``,
``apply``), run unchanged on the duck-typed tables here and give 0 on
padding.  Volume-weighted reductions see ``vol`` = 0 on padding.

This slice puts all D shards on ONE device (``make_block_mesh([dev] *
D)``): it exercises the exchange plans, the shard padding and the ring
routing with kernel B14 (parallel/ring.py), not transport between cards
(ROADMAP A7).  The JAX package's ``ExecutableMemo`` and
``bind_*_executable`` cache compiled XLA executables and have no
counterpart until a compiled store exists (ROADMAP A8): PyTorch runs
eagerly, and :func:`cached_forest` keeps the host-built tables.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.grid import bucket
from cup3d_tpu_torch.grid.blocks import BlockGrid, LabTables, assemble_from
from cup3d_tpu_torch.grid.flux import add_grouped, build_flux_tables, \
    corrections
from cup3d_tpu_torch.parallel.compat import (all_to_all, stacked_rows,
                                             take_rows)

__all__ = ["BlockMesh", "make_block_mesh", "cached_forest", "ShardedForest"]


@dataclass(frozen=True)
class BlockMesh:
    """A 1-D mesh of D shards over the block axis, all on one device."""

    devices: Tuple[torch.device, ...]

    @property
    def D(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_block_mesh(devices: Optional[Sequence] = None) -> BlockMesh:
    """1-D mesh over the block axis.  ``devices``: one entry per shard
    (``[torch.device("cuda")] * 4`` runs four shards on the card);
    ``None`` is every visible CUDA device, as the JAX package's default
    is ``jax.devices()``, and raises without a GPU.  The shards of this
    slice share one device: distinct devices raise."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_block_mesh: no CUDA device; pass the shards' devices "
                "(e.g. [torch.device('cpu')] * 8) to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("make_block_mesh: no devices")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"make_block_mesh: shards on distinct devices {devs}: transport "
            f"between cards is ROADMAP A7's multi-card step; this slice "
            f"runs every shard on one device")
    return BlockMesh(tuple(devs))


#: (octree signature, mesh devices) -> ShardedForest, LRU
_FOREST_MEMO: "OrderedDict[tuple, ShardedForest]" = OrderedDict()
_FOREST_MEMO_MAX = 4


def cached_forest(grid: BlockGrid, mesh: Optional[BlockMesh] = None
                  ) -> "ShardedForest":
    """Signature-keyed ShardedForest memo: a regrid that returns to a
    topology seen before reuses its host-built exchange tables (equal
    signatures give equal tables)."""
    from cup3d_tpu_torch.obs import metrics as obs_metrics

    if mesh is None:
        mesh = make_block_mesh()
    key = (grid.signature, tuple(str(d) for d in mesh.devices))
    forest = _FOREST_MEMO.pop(key, None)
    obs_metrics.counter(
        "forest.memo_hits" if forest is not None else "forest.memo_misses"
    ).inc()
    if forest is None:
        forest = ShardedForest(grid, mesh)
    _FOREST_MEMO[key] = forest
    while len(_FOREST_MEMO) > _FOREST_MEMO_MAX:
        _FOREST_MEMO.popitem(last=False)
    return forest


class _Exchange:
    """Host-built routing for one (flat-array layout, reference set).

    ``unit``: flat entries per block.  Remaps global flat indices (with
    sentinel ``nb*unit``) into each destination shard's local address
    space: [0, nbs*unit) local, [nbs*unit, nbs*unit + D*M) received rows,
    nbs*unit + D*M the zero sentinel."""

    def __init__(self, forest: "ShardedForest", unit: int,
                 ref_lists: Dict[int, np.ndarray]):
        D, nbs = forest.D, forest.nbs
        self.unit = unit
        local_n = nbs * unit
        sent = forest.grid.nb * unit  # global sentinel

        def shard_of(f):
            return np.minimum(f // unit // nbs, D)  # sentinel -> D

        # per destination shard: remote refs grouped by source shard
        groups = []  # groups[s][t] = sorted unique global indices
        for s in range(D):
            refs = ref_lists.get(s)
            if refs is None or refs.size == 0:
                groups.append([np.zeros(0, np.int64)] * D)
                continue
            refs = refs[refs < sent]
            own = shard_of(refs)
            groups.append(
                [np.unique(refs[own == t]) if t != s
                 else np.zeros(0, np.int64) for t in range(D)])
        # keep M >= 1 so the payload shape never degenerates
        M = max([g.size for gs in groups for g in gs] + [1])
        self.M = M
        # send table: send_idx[t, s, :] = local flat indices (on t) of the
        # cells shard s needs from t; padded rows re-read cell 0
        send_idx = np.zeros((D, D, M), np.int64)
        for s in range(D):
            for t in range(D):
                g = groups[s][t]
                send_idx[t, s, : g.size] = g - t * local_n
        self.send_idx = send_idx
        self.groups = groups
        self.local_n = local_n
        self.zero_idx = local_n + D * M
        self.ext_n = local_n + D * M + 1
        self._shard_of = shard_of
        self._sent = sent

    def remap(self, idx: np.ndarray, dst_shard: int) -> np.ndarray:
        """Global flat indices -> dst shard's local address space."""
        D = len(self.groups)
        out = np.full(idx.shape, self.zero_idx, np.int64)
        own = self._shard_of(idx)
        mine = own == dst_shard
        out[mine] = idx[mine] - dst_shard * self.local_n
        for t in range(D):
            if t == dst_shard:
                continue
            g = self.groups[dst_shard][t]
            sel = (own == t) & (idx < self._sent)
            if not np.any(sel) or g.size == 0:
                continue
            pos = np.searchsorted(g, idx[sel])
            out[sel] = self.local_n + t * self.M + pos
        return out


def _exchange_gather(flat: torch.Tensor, send_rows: torch.Tensor
                     ) -> torch.Tensor:
    """flat (D, local_n, C) per-shard values, send_rows (D, D, M) stacked
    send rows -> (D, local_n + D*M + 1, C): local rows, received rows,
    zero sentinel."""
    D = flat.shape[0]
    send = take_rows(flat, send_rows)  # (D_src, D_dst, M, C)
    recv = all_to_all(send).reshape(D, -1, flat.shape[-1])
    zero = flat.new_zeros((D, 1, flat.shape[-1]))
    return torch.cat([flat, recv, zero], dim=1)


class ShardedLabTables:
    """Duck-typed LabTables (the per-cell tables) whose ghosts are
    gathered from each shard's exchanged buffer."""

    def __init__(self, forest: "ShardedForest", inner: LabTables,
                 send_idx: np.ndarray, ext_n: int):
        self.forest = forest
        self.width = inner.width
        self.inner = inner  # indices into the stacked exchanged buffers
        self.send_idx = send_idx  # (D, D, M) shard-local, host
        self.send_rows = torch.as_tensor(
            stacked_rows(send_idx, forest.nbs * forest.grid.bs ** 3),
            device=forest.device)

    def _assemble_comp(self, comp: torch.Tensor, bs: int, c):
        D = self.forest.D
        ext = _exchange_gather(comp.reshape(D, -1, 1), self.send_rows)
        return assemble_from(comp, ext.reshape(-1), self.inner, bs, c)

    def assemble_scalar(self, field: torch.Tensor, bs: int) -> torch.Tensor:
        return self._assemble_comp(field, bs, None)

    def assemble_vector(self, field: torch.Tensor, bs: int) -> torch.Tensor:
        return torch.stack([self._assemble_comp(field[..., c], bs, c)
                            for c in range(3)], dim=-1)

    def assemble_component(self, field: torch.Tensor, bs: int,
                           comp: int) -> torch.Tensor:
        return self._assemble_comp(field, bs, comp)


class ShardedFluxTables:
    """Duck-typed FluxTables: coarse-side corrections applied per shard
    after an exchange of the remote fine-face flux rows
    (FluxCorrectionMPI, main.cpp:2546-2946).  Each shard's corrections
    are grouped by target cell and summed in the unsharded table's row
    order, so the result equals the unsharded apply bitwise."""

    def __init__(self, forest: "ShardedForest", ncorr: int, **tabs):
        self.forest = forest
        self.ncorr = ncorr
        for k, v in tabs.items():
            setattr(self, k, v)

    def apply(self, out: torch.Tensor, fluxes: torch.Tensor) -> torch.Tensor:
        if self.ncorr == 0:
            return out
        D = self.forest.D
        ext = _exchange_gather(fluxes.reshape(D, -1, 1), self.send_rows)
        corr = corrections(ext.reshape(-1), self.src_rows, self.tgt_rows,
                           self.inv_hc)  # (D, ncmax)
        # one scratch cell per shard absorbs the padded groups
        flat = torch.cat([out.reshape(D, -1), out.new_zeros((D, 1))], dim=1)
        flat = flat.reshape(-1)
        add_grouped(flat, self.cell_rows, self.group_rows, corr)
        return flat.reshape(D, -1)[:, :-1].reshape(out.shape)


class ShardedForest:
    """One AMR topology cut into D shards of the block axis (see the
    module docstring)."""

    def __init__(self, grid: BlockGrid, mesh: Optional[BlockMesh] = None):
        if mesh is None:
            mesh = make_block_mesh()
        self.grid = grid
        self.mesh = mesh
        self.D = mesh.D
        self.device = mesh.device
        # per-shard block count up the capacity ladder (base 1: small
        # shards stay exact), as grid/bucket.py's JAX twin
        self.nbs = bucket.count_capacity(-(-grid.nb // self.D), base=1)
        self.nb_pad = self.nbs * self.D
        self.geom = bucket.PaddedGeom(grid, self.nb_pad)
        self._lab_cache: Dict[object, object] = {}
        self._flux_cache: Optional[ShardedFluxTables] = None
        # (nb_pad,1,1,1) cell volume, 0 on padding: volume-weighted
        # reductions ignore the padding blocks
        vol = np.zeros((self.nb_pad, 1, 1, 1), np.float64)
        vol[: grid.nb, 0, 0, 0] = grid.h ** 3
        self.vol = self.pad_aux(torch.as_tensor(vol, dtype=torch.float32))
        pmask = np.zeros((self.nb_pad, 1, 1, 1), np.float32)
        pmask[: grid.nb] = 1.0
        self.pmask = self.pad_aux(torch.as_tensor(pmask))

    # -- field layout ------------------------------------------------------

    def pad(self, field: torch.Tensor) -> torch.Tensor:
        """(nb, ...) -> (nb_pad, ...) zero-padded on the mesh's device
        (a field already nb_pad long passes through)."""
        field = field.to(self.device)
        extra = self.nb_pad - field.shape[0]
        if extra:
            field = torch.cat(
                [field, field.new_zeros((extra,) + tuple(field.shape[1:]))])
        return field

    def pad_aux(self, arr: torch.Tensor) -> torch.Tensor:
        """An nb_pad-long auxiliary array -> the mesh's device."""
        return arr.to(self.device)

    def unpad(self, field: torch.Tensor) -> torch.Tensor:
        return field[: self.grid.nb]

    def shard_rows(self, s: int) -> Tuple[int, int]:
        """[lo, hi) of the real blocks of shard s (empty past nb)."""
        lo = min(s * self.nbs, self.grid.nb)
        return lo, min((s + 1) * self.nbs, self.grid.nb)

    # -- synchronizer setup (host) ----------------------------------------

    def lab_tables(self, width: int) -> ShardedLabTables:
        if width not in self._lab_cache:
            self._lab_cache[width] = self._build_lab(width)
        return self._lab_cache[width]

    def face_tables(self, width: int):
        """The sharded face-slab tables (parallel/faces.py), or the
        per-cell lab tables where the topology has degenerate
        closed-boundary blocks (none on periodic domains)."""
        key = ("face", width)
        if key not in self._lab_cache:
            from cup3d_tpu_torch.parallel.faces import \
                build_sharded_face_tables

            try:
                self._lab_cache[key] = build_sharded_face_tables(self, width)
            except ValueError:
                self._lab_cache[key] = self.lab_tables(width)
        return self._lab_cache[key]

    def _build_lab(self, width: int) -> ShardedLabTables:
        g = self.grid
        t = g.lab_tables_np(width)
        D, nbs = self.D, self.nbs
        unit = g.bs ** 3
        g_idx = np.asarray(t["g_idx"], np.int64)  # (nb, ng, 8)
        s_idx = np.asarray(t["s_idx"], np.int64)
        ref_lists = {}
        for s in range(D):
            lo, hi = self.shard_rows(s)
            ref_lists[s] = np.concatenate(
                [g_idx[lo:hi].ravel(), s_idx[lo:hi].ravel()])
        ex = _Exchange(self, unit, ref_lists)

        ng, ns = g_idx.shape[1], s_idx.shape[1]
        g_re = np.full((self.nb_pad, ng, 8), ex.zero_idx, np.int64)
        s_re = np.full((self.nb_pad, ns, 8), ex.zero_idx, np.int64)
        for s in range(D):
            lo, hi = self.shard_rows(s)
            if lo < hi:
                g_re[lo:hi] = ex.remap(g_idx[lo:hi], s)
                s_re[lo:hi] = ex.remap(s_idx[lo:hi], s)

        def padb(a, fill=0.0):
            a = np.asarray(a)
            pad = np.full((self.nb_pad - g.nb,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, pad])

        def stacked(a):  # shard-local -> rows of the stacked buffers
            return stacked_rows(a.reshape((D, nbs) + a.shape[1:]),
                                ex.ext_n).reshape(a.shape)

        dev = self.device
        gx, gy, gz = (t["ghost_xyz"][:, a].astype(np.int64) for a in range(3))
        L = t["interp_w"].shape[0]

        def on(a, dtype):
            return torch.as_tensor(a, device=dev).to(dtype)

        inner = LabTables(
            width=width,
            ghost_flat=on((gx * L + gy) * L + gz, torch.int64),
            g_idx=on(stacked(g_re), torch.int64),
            g_w=on(padb(t["g_w"]), torch.float32),
            g_sign=on(padb(t["g_sign"], 1.0), torch.float32),
            mask_coarse=on(padb(t["mask_coarse"], False), torch.bool),
            s_idx=on(stacked(s_re), torch.int64),
            s_w=on(padb(t["s_w"]), torch.float32),
            s_sign=on(padb(t["s_sign"], 1.0), torch.float32),
            interp_w=on(t["interp_w"], torch.float32),
            any_coarse=t["any_coarse"])
        return ShardedLabTables(self, inner, ex.send_idx, ex.ext_n)

    @property
    def flux_tables(self) -> ShardedFluxTables:
        if self._flux_cache is None:
            self._flux_cache = self._build_flux()
        return self._flux_cache

    def _build_flux(self) -> ShardedFluxTables:
        g = self.grid
        t = build_flux_tables(g)  # host tables
        D, nbs = self.D, self.nbs
        bs = g.bs
        funit = 6 * bs * bs
        cunit = bs ** 3
        if t.ncorr == 0:
            return ShardedFluxTables(self, 0)

        tgt_flux = t.tgt_flux.numpy()
        src_flux = t.src_flux.numpy()
        inv_hc = t.inv_hc.numpy()
        cells, groups = t.cells.numpy(), t.groups.numpy()
        nc, K = tgt_flux.shape[0], groups.shape[1]
        tgt_cell = np.zeros(nc, np.int64)
        for k in range(K):
            has = groups[:, k] < nc
            tgt_cell[groups[has, k]] = cells[has]
        owner = tgt_cell // cunit // nbs  # shard of the corrected block

        ex = _Exchange(self, funit,
                       {s: src_flux[owner == s].ravel() for s in range(D)})
        counts = [int(np.sum(owner == s)) for s in range(D)]
        ncmax = max(counts)
        TF = np.zeros((D, ncmax), np.int64)
        SF = np.full((D, ncmax, 4), ex.zero_idx, np.int64)
        IH = np.zeros((D, ncmax), np.float32)
        # per shard: its target cells ascending, each cell's rows in the
        # unsharded table's order, padded with the zero row ncmax (and
        # padded cells with the scratch cell nbs*cunit), K as unsharded
        cl_s, gr_s = [], []
        for s in range(D):
            rows = np.flatnonzero(owner == s)  # table order
            n = rows.size
            TF[s, :n] = tgt_flux[rows] - s * nbs * funit
            SF[s, :n] = ex.remap(src_flux[rows], s)
            IH[s, :n] = inv_hc[rows]
            tc = tgt_cell[rows] - s * nbs * cunit
            order = np.argsort(tc, kind="stable")
            cl, first, cnt = np.unique(tc[order], return_index=True,
                                       return_counts=True)
            gr = np.full((cl.size, K), ncmax, np.int64)
            for k in range(K):
                has = cnt > k
                gr[has, k] = order[first[has] + k]
            cl_s.append(cl)
            gr_s.append(gr)
        ncell = max(c.size for c in cl_s)
        CL = np.full((D, ncell), nbs * cunit, np.int64)
        GR = np.full((D, ncell, K), ncmax, np.int64)
        for s in range(D):
            CL[s, : cl_s[s].size] = cl_s[s]
            GR[s, : gr_s[s].shape[0]] = gr_s[s]

        def on(a, dtype=torch.int64):
            return torch.as_tensor(a, device=self.device).to(dtype)

        return ShardedFluxTables(
            self, t.ncorr,
            send_idx=ex.send_idx,
            send_rows=on(stacked_rows(ex.send_idx, ex.local_n)),
            src_rows=on(stacked_rows(SF, ex.ext_n)),
            tgt_rows=on(stacked_rows(TF, ex.ext_n)),
            inv_hc=on(IH, torch.float32),
            cell_rows=on(stacked_rows(CL, nbs * cunit + 1)),
            group_rows=on(stacked_rows(GR, ncmax + 1)))

    # -- solvers -----------------------------------------------------------

    def build_poisson_solver(self, **kw):
        """The sharded getZ-preconditioned BiCGSTAB: the static solver
        front-end (ops/amr_ops.py) with the forest's duck-typed face and
        flux tables, volume weights that are 0 on padding and a padding
        mask; its dot products are sums over the padded fields.  The
        geometry carries no tree, so the getZ is tile-only."""
        from cup3d_tpu_torch.ops import amr_ops

        return amr_ops.build_amr_poisson_solver(
            self.geom, tab=self.face_tables(1), flux_tab=self.flux_tables,
            vol=self.vol, pmask=self.pmask, device=self.device, **kw)

    def build_helmholtz_solver(self, **kw):
        """The sharded implicit-diffusion Helmholtz solve (the distributed
        DiffusionSolver, main.cpp:6896-7146): the forest builder over the
        padded geometry and the duck-typed tables; padding blocks stay
        zero (their labs assemble to zero)."""
        from cup3d_tpu_torch.ops.diffusion import build_amr_helmholtz_solver

        return build_amr_helmholtz_solver(
            self.geom, tab=self.face_tables(1), flux_tab=self.flux_tables,
            device=self.device, **kw)
