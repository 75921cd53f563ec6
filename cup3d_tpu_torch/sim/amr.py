"""AMR simulation driver (port of ``cup3d_tpu/sim/amr.py``; reference
Simulation + adaptMesh, main.cpp:15161-15326).

- the fields live on a block forest as ``(nb, bs, bs, bs[, 3])`` tensors
  that are *re-laid-out* on adaptation (grid/adapt.py);
- the mesh adapts every ``ADAPT_EVERY`` steps and each of the first 10,
  tagging on max |vorticity| per block, with the blocks that touch a
  body's interface forced to the finest level (main.cpp:15314,
  8540-8602), while ``adapt_enabled`` is True (False freezes a converged
  mesh: the static 2-level run of BASELINE config #3);
- startup runs up to 3*levelMax rounds of {adapt; re-create the bodies;
  re-IC} (main.cpp:15172-15177); the IC is Taylor-Green, the coiled
  vorticity (three forest Poisson solves of -curl omega) or rest;
- the host path's step (``_advance_host``) is CreateObstacles (each
  body's SDF on its candidate blocks, the Towers chi from SDF labs
  assembled through the face tables), AdvectionDiffusion (RK3 on width-3
  face labs, or with ``implicitDiffusion`` Euler advection and a
  Helmholtz BiCGSTAB a component, ops/diffusion.py), UpdateObstacles (the
  bodies' moments and the pairwise overlap counts in ONE host read, the
  6x6 solves on the host), Penalization (the collision pass, then
  Brinkman), the forcing (``uMax_forced``, or ``bFixMassFlux``'s
  parabolic profile and its flux.txt row), PressureProjection
  (getZ-preconditioned BiCGSTAB with the block-graph coarse level; under
  ``CUP3D_FUSED=1`` the fused forest driver whose stages are CUDA
  kernels) and ComputeForces (the surface probe on a window of
  finest-level blocks), ending in ONE device-to-host read of the
  penalization forces, the force QoI, the solver's [residual,
  iterations] and max|u| (BASELINE config #4: two StefanFish on the
  adapting forest);
- pipelined (``cfg.pipelined``), the step is one megastep: the same
  operators in the same order with the bodies' rigid update on the
  device (``models/base.rigid_update_bodies``, chained from step to
  step), no collision pass, and the step's QoI pack handed to the QoI
  stream (stream/qoi.py), whose grouped reads trail the stepping.  dt
  comes from a stale max|u| (a 1.5x margin, a 1.03x growth bound, the
  bodies' host speed as a floor) or, obstacle-free and stopped by a step
  count, from the device dt chain (no read at all, ``dtDevice``).  The
  next step's adaptation scores are staged one step early (the scores
  prefetch).  A stale overlap count in a pack latches
  ``_collision_hot``, which routes the steps to the host path until its
  fresh pre-check is clear (the collision fallback).

``simulate()`` runs through the RecoveryEngine (resilience/recovery.py)
unless ``CUP3D_RECOVER=0``, as the uniform driver does: a rollback
restores the snapshot's forest (reusing the live tables when its leaf
keys are the live forest's) and abandons the stream's packs, and the
ladder's tile-only rung drops the block graph, so the fused forest solve
runs the tile-only getZ kernel B10.

The single-device forest is CAPACITY-BUCKETED (grid/bucket.py), as the
JAX package's production path: every block tensor pads up a geometric
capacity ladder (zero padding rows, h = 1 and cell volume 0 there, halos
from the zero sentinel), the padded tables of a topology (face and flux
tables, the block graph, spacing, volumes, centres, the real-block mask,
the pin slot and the per-slot level as device tensors) are memoised by
octree signature (the last four topologies; a ping-pong regrid A -> B ->
A rebuilds nothing), and the bound solver, Helmholtz solve and regrid
decision are cached by bucket key (capacity plus the padded geometry's
shapes).  The regrid decision is taken on the device: an adaptation
reads one int8 tag a slot (grid/adapt.py ``device_tags``), staged one
step early when pipelined.  Eager PyTorch compiles nothing, so the
buckets buy the JAX package's padding contract and numbers, fixed tensor
shapes across regrids (the caching allocator reuses its blocks; a CUDA
graph of the step would need them) and the table memo.
``CUP3D_BUCKET=0`` gives the unpadded forest: exactly ``nb`` blocks,
every regrid rebuilding its tables, tagging on the host from both score
fields.  With ``mesh`` (parallel/forest.make_block_mesh) the forest is
block-sharded instead:
every field is padded to the ShardedForest's ``nb_pad`` rows on every
state-assignment path (zero padding rows), the operators take its
padded geometry and duck-typed face and flux tables (the halo exchange
between shards, on the ring transport under ``CUP3D_RING_HALO=1``), and
the Poisson solve is the static tile-only composition
(``ShardedForest.build_poisson_solver``), as the JAX package's mesh
mode; its pipelined step takes a host dt.  Bodies run on it as in the
JAX package's mesh mode: they rasterize on the real blocks' centres,
their SDF is padded before the Towers chi is taken from labs assembled
through the sharded face tables, and every body stage (UpdateObstacles,
the collision pass, Penalization, the force probe, near-body tagging,
the megastep) reads the padded fields with ``vol`` = 0 and chi = 0 on
padding; a regrid re-shards through ``cached_forest``.  Field dumps
(``tdump``/``fdump``) and periodic checkpoints (``saveFreq``) run off
the step loop, through the same sharded writer and async checkpointer as
the uniform driver (stream/).  Runs on CUDA unless the caller asks for
the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from cup3d_tpu_torch.config import SimulationConfig, parse_factory
from cup3d_tpu_torch.grid import adapt as ad
from cup3d_tpu_torch.grid import bucket as bk
from cup3d_tpu_torch.grid.blocks import BlockGrid
from cup3d_tpu_torch.grid.faces import pad_face_tables
from cup3d_tpu_torch.grid.flux import build_flux_tables, pad_flux_tables
from cup3d_tpu_torch.grid.octree import Octree, TreeConfig
from cup3d_tpu_torch.grid.uniform import BC
from cup3d_tpu_torch.io.logging import BufferedLogger, Profiler
from cup3d_tpu_torch.obs import metrics as obs_metrics
from cup3d_tpu_torch.models.base import (FORCE_PACK, RIGID_PACK,
                                         log_forces,
                                         momentum_integrals_core,
                                         pack_forces, pack_moments,
                                         rigid_update_bodies,
                                         store_force_qoi, unpack_forces,
                                         unpack_moments,
                                         update_penalization_forces, upload)
from cup3d_tpu_torch.obs.flight import FlightRecorder
from cup3d_tpu_torch.obs import costs as obs_costs
from cup3d_tpu_torch.obs import export as obs_export
from cup3d_tpu_torch.obs import profile as obs_profile
from cup3d_tpu_torch.obs.trace import StepObserver
from cup3d_tpu_torch.ops import amr_ops, krylov
from cup3d_tpu_torch.ops.chi import towers_chi
from cup3d_tpu_torch.ops.penalization import (penalize,
                                              per_obstacle_penalization_force)
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.resilience.recovery import (RecoveryEngine,
                                                 SimulationFailure)
from cup3d_tpu_torch.sim.data import (SimulationData,
                                      load_obstacle_state_numpy,
                                      obstacle_state_to_numpy)
from cup3d_tpu_torch.sim.simulation import resolve_device
from cup3d_tpu_torch.stream.qoi import PackPolicy, QoIStream

ADAPT_EVERY = 20  # reference cadence (main.cpp:15314)
FIELDS = ("vel", "p")
#: the fields a run with bodies adds: the combined chi and udef
BODY_FIELDS = ("chi", "udef")
_EPS = 1e-6
#: topologies whose padded tables the bucketed forest keeps (LRU)
TABLE_MEMO_ENTRIES = 4


class BucketGeo(NamedTuple):
    """One topology's padded geometry on the device (the JAX package's
    ``_geo_args`` bundle): face tables of widths 1 and 3, flux tables,
    the padded geometry view (nb = capacity, h = 1 on padding), cell
    volume (0 on padding), cell centres (None without bodies), the
    real-block mask, the block graph (None: tile-only getZ), the pin
    slot (0-dim long) and the per-slot octree level (0 on padding)."""

    tab1: object
    tab3: object
    ftab: object
    geom: bk.PaddedGeom
    vol: torch.Tensor
    xc: Optional[torch.Tensor]
    mask: torch.Tensor
    graph: Optional[object]
    slot0: torch.Tensor
    level: torch.Tensor


def _leaves(obj):
    """The leaves of a geometry bundle in a fixed order: its tensors and
    its integer layout data (the padded geometry by its block count)."""
    if obj is None or isinstance(obj, (torch.Tensor, bool, int, float, str)):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _leaves(o)
    elif isinstance(obj, bk.PaddedGeom):
        yield obj.nb
    else:
        for _, v in sorted(vars(obj).items()):
            yield from _leaves(v)


def bucket_tables(g: BlockGrid, cfg: SimulationConfig, dt, dev,
                  with_bodies: bool, coarse: bool) -> tuple:
    """(capacity, BucketGeo) of ``g``: its tables built on the host and
    padded onto ``dev`` (grid/faces.py, grid/flux.py, ops/krylov.py),
    h = 1 and volume 0 on padding.  With ``dev`` the CPU it makes no
    CUDA call (the compile service's worker builds there)."""
    cap = bk.capacity(g.nb)
    vol = np.zeros((cap, 1, 1, 1), np.float64)
    vol[: g.nb, 0, 0, 0] = g.h ** 3
    mask = np.zeros((cap, 1, 1, 1), np.float32)
    mask[: g.nb] = 1.0
    xc = None
    if with_bodies:
        xc = bk.pad_field(g.cell_centers(dt, dev), cap)
    # the corner pin slot of mean_constraint 1/3, a device index
    slot0 = 0
    if cfg.bMeanConstraint in (1, 3):
        slot0 = int(np.lexsort((g.ijk[:, 2], g.ijk[:, 1], g.ijk[:, 0]))[0])
    level = np.zeros(cap, np.int32)
    level[: g.nb] = g.level
    geo = BucketGeo(
        tab1=pad_face_tables(g.face_tables(1), g, cap, device=dev),
        tab3=pad_face_tables(g.face_tables(3), g, cap, device=dev),
        ftab=pad_flux_tables(build_flux_tables(g), g.bs, cap, device=dev),
        geom=bk.PaddedGeom(g, cap),
        vol=torch.as_tensor(vol, dtype=dt, device=dev),
        xc=xc,
        mask=torch.as_tensor(mask, dtype=dt, device=dev),
        graph=(krylov.block_graph_tables(g, dev, cap=cap) if coarse
               else None),
        slot0=torch.tensor(slot0, dtype=torch.long, device=dev),
        level=torch.as_tensor(level, device=dev))
    return cap, geo


def tables_content_sig(octree_sig, g: BlockGrid, cfg: SimulationConfig, dt,
                       nu: float, with_bodies: bool, coarse: bool,
                       shards) -> tuple:
    """The compiled store's content key of one topology's tables: the JAX
    package's ``_aot_content_sig`` (the octree signature, block size,
    dtype, nu, extent, the solver's and the Helmholtz solve's
    tolerances, the mean-constraint and mass-flux switches, the pressure
    order's switch step, the mesh layout) plus what the port's table
    build reads and the JAX key lacks: the mean-constraint mode (the pin
    slot of modes 1 and 3), the bodies (the cell centres) and the coarse
    correction (the block graph)."""
    return (
        octree_sig,
        int(g.bs),
        str(torch.empty((), dtype=dt).numpy().dtype),
        float(nu),
        tuple(float(v) for v in g.extent),
        float(cfg.poissonTol),
        float(cfg.poissonTolRel),
        bool(cfg.bMeanConstraint),
        bool(cfg.implicitDiffusion),
        float(cfg.diffusionTol),
        float(cfg.diffusionTolRel),
        bool(cfg.bFixMassFlux),
        int(cfg.step_2nd_start),
        (("blocks", int(shards)),) if shards is not None else None,
        ("port", int(cfg.bMeanConstraint), bool(with_bodies), bool(coarse)),
    )


def tables_payload(cap: int, geo) -> dict:
    """One topology's (capacity, BucketGeo) as a ``tables`` record's host
    payload (aot/store.py ``to_host``: numpy arrays, dtypes and bits
    kept)."""
    from cup3d_tpu_torch.aot import store as aot_store

    return {"cap": int(cap), "geo": aot_store.to_host(geo)}


def initial_grid(cfg: SimulationConfig) -> BlockGrid:
    """The forest a driver of ``cfg`` starts from (before init's
    adaptation rounds): pure host work."""
    periodic = tuple(b == "periodic" for b in cfg.bc)
    tree = Octree(TreeConfig((cfg.bpdx, cfg.bpdy, cfg.bpdz), cfg.levelMax,
                             periodic), cfg.levelStart)
    return BlockGrid(tree, cfg.extents, tuple(BC(b) for b in cfg.bc),
                     cfg.block_size)


def host_tables_build(cfg: SimulationConfig, fp: Optional[dict] = None):
    """A background build of the tables of ``cfg``'s initial forest: built
    on the CPU (no CUDA call; the tables are built by numpy and torch on
    the host, which chip_smoke.py phase 37 holds bitwise to a build on
    the card) and put into the active store under the key a driver of
    ``cfg`` looks up.  ``fp``: the fingerprint of the environment that
    loads the record (the service's helper process writes for its
    parent and initialises no CUDA to take its own; default this
    process's).  Returns the record's path or None."""
    from cup3d_tpu_torch.aot import store as aot_store

    st = aot_store.active_store()
    if st is None:
        return None
    g, dt, with_bodies, coarse = _initial_knobs(cfg)
    memo = bucket_tables(g, cfg, dt, "cpu", with_bodies, coarse)
    obs_metrics.counter("bucket.table_builds").inc()
    return st.put(tables_key(tables_content_sig(
        g.signature, g, cfg, dt, cfg.nu, with_bodies, coarse, None)),
        tables_payload(*memo), name="forest.tables", fp=fp)


def host_tables_build_child(cfg: SimulationConfig, host,
                            timeout: Optional[float] = None):
    """:func:`host_tables_build` in the compile service's helper process
    (aot/compiler.py ``HostProcess``): the worker thread waits on it with
    the GIL released, so the table build (Python loops, mostly) does not
    convoy the dispatch thread's launches.  The helper's own counters
    stay in its process: the build and the write are counted here, in
    ``bucket.table_builds`` and ``aot.store_writes``.  Raises when the
    helper fails (the service then fails the build and the driver builds
    inline)."""
    from cup3d_tpu_torch.aot import store as aot_store
    from cup3d_tpu_torch.aot.compiler import BUILD_TIMEOUT_S

    path = host.call("cup3d_tpu_torch.sim.amr:host_tables_build",
                     (cfg, aot_store.fingerprint()),
                     BUILD_TIMEOUT_S if timeout is None else timeout)
    if path is None:
        raise RuntimeError("table build: the store refused the record")
    obs_metrics.counter("bucket.table_builds").inc()
    obs_metrics.counter("aot.store_writes").inc()
    return path


def _initial_knobs(cfg: SimulationConfig) -> tuple:
    """(initial grid, dtype, bodies, coarse level) of a fresh
    single-device driver of ``cfg``: what its first table build reads."""
    coarse = (krylov.use_coarse_correction()
              and cfg.bMeanConstraint not in (1, 3))
    return (initial_grid(cfg), getattr(torch, cfg.dtype),
            bool(cfg.resolved_factory_content()), coarse)


def initial_tables_sig(cfg: SimulationConfig) -> tuple:
    """The ``tables`` record key of ``cfg``'s initial forest on the
    single-device bucketed driver (what :func:`host_tables_build` puts)."""
    g, dt, with_bodies, coarse = _initial_knobs(cfg)
    return tables_key(tables_content_sig(
        g.signature, g, cfg, dt, cfg.nu, with_bodies, coarse, None))


def tables_key(content_sig) -> tuple:
    """The compiled store's key of one topology's ``tables`` record."""
    return ("forest", "tables", content_sig)


class AMRSimulation:
    def __init__(self, cfg: SimulationConfig, tree: Optional[Octree] = None,
                 device=None, mesh=None):
        self.cfg = cfg
        #: the 1-D block mesh (parallel/forest.BlockMesh) or None
        self.mesh = mesh
        self.forest = None
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.grid = (initial_grid(cfg) if tree is None else
                     BlockGrid(tree, cfg.extents,
                               tuple(BC(b) for b in cfg.bc), cfg.block_size))
        self.state: Dict[str, torch.Tensor] = {}
        #: the bodies (models/), built by init() from the factory lines
        self.obstacles: List = []
        self._with_bodies = bool(cfg.resolved_factory_content())
        #: steps whose collision pass fired
        self.collisions = 0
        self._dlm_dev_cache = None
        self._lambda_dev_cache = None
        self._lambda_dev_val = None
        self.time = 0.0
        self.step_idx = 0
        self.dt = 0.0
        self.uinf = np.asarray(cfg.uinf, np.float64)
        self.lambda_penal = cfg.lambda_penalization
        self._uinf_src = None
        self._uinf_cache = None
        #: the frame velocity the megastep chains on the device
        self._uinf_dev = None
        self.nu = cfg.nu
        self.logger = BufferedLogger(cfg.path4serialization)
        self.profiler = Profiler()
        #: False freezes the mesh (no tagging, no re-layout)
        self.adapt_enabled = True
        self._pending_parts: List = []
        self._umax_next: Optional[float] = None
        #: one dict per finished step: step, time, dt, umax, resid, iters,
        #: wall_s, nb (steps a rollback abandoned included)
        self.step_log: List[dict] = []
        #: host seconds of the table builds of each topology (_rebuild)
        self.table_build_s: List[float] = []
        self.flight = FlightRecorder(directory=cfg.path4serialization,
                                     run_config=cfg,
                                     state_probe=self._flight_state)
        self._obs = StepObserver(self.flight, kind="amr")
        # capture windows at the loop top (CUP3D_PROFILE) and the
        # /metrics exporter (CUP3D_METRICS_PORT): both off by default
        obs_profile.CONTROLLER.default_directory(cfg.path4serialization,
                                                 device=self.device)
        self._obs_profile = obs_profile.CONTROLLER
        obs_export.ensure_exporter()
        self._last_umax: Optional[float] = None
        #: the RecoveryEngine while simulate() runs one (None otherwise)
        self._resilience: Optional[RecoveryEngine] = None
        # the Poisson ladder's overrides: None = the CUP3D_COARSE default
        self._poisson_two_level: Optional[bool] = None
        self._poisson_maxiter = 1000
        # off-critical-path output (stream/dump.py, stream/checkpoint.py)
        from cup3d_tpu_torch.io.dump import OutputCadence
        from cup3d_tpu_torch.stream.checkpoint import AsyncCheckpointer
        from cup3d_tpu_torch.stream.dump import AsyncDumper

        self._cadence = OutputCadence(cfg.tdump, cfg.fdump, cfg.saveFreq)
        self._dumper = AsyncDumper()
        self._checkpointer = AsyncCheckpointer()
        # pipelined stepping: the step packs' reader (grouped, deferred),
        # the device dt chain's max|u| and time, the frame velocity
        # chained from the megastep, the collision fallback's latch and
        # the next adaptation's staged scores
        self._pack_reader = QoIStream(
            self._consume_entry,
            policy=PackPolicy.for_cells(self.grid.nb * self.grid.bs ** 3),
            profiler=self.profiler)
        self._dt_chain = False
        self._umax_dev: Optional[torch.Tensor] = None
        self._time_dev: Optional[torch.Tensor] = None
        self._collision_hot = False
        #: pipelined steps the collision fallback routed to the host path
        self.collision_fallbacks = 0
        self._scores_prefetch = None
        #: adaptations that used the staged scores, and pipelined ones that
        #: computed them anew (none staged, or the forest changed since)
        self.prefetch = {"hits": 0, "misses": 0}
        #: host bytes each adaptation read for its decision: the staged or
        #: read tags (bucketed), or both score fields
        self.adapt_bytes: List[int] = []
        # capacity bucketing (module doc): single-device only; the
        # JAX package's own switch
        self._bucketing = (mesh is None
                           and os.environ.get("CUP3D_BUCKET", "1") != "0")
        self._cap: Optional[int] = None
        #: octree signature -> BucketGeo + capacity (LRU, move-to-back)
        self._table_memo: Dict = {}
        #: bucket key -> the bound operators of a bucket
        self._exec_cache: Dict = {}
        self._device_tags = None
        self._pmask: Optional[torch.Tensor] = None
        self._build_solver_core()
        self._rebuild()
        self._alloc_fields()

    def _flight_state(self) -> dict:
        """Driver state for a postmortem (called only at dump time)."""
        g = self.grid
        return {"driver": "amr", "blocks": int(g.nb),
                "bucket_capacity": int(self._cap or g.nb),
                "bucketing": bool(self._bucketing),
                "table_memo_entries": len(self._table_memo),
                "exec_cache_entries": len(self._exec_cache),
                "levels": sorted(set(int(v) for v in g.level)),
                "shards": 1 if self.mesh is None else self.mesh.D,
                "step": self.step_idx, "time": self.time, "dt": self.dt,
                "obstacles": [type(ob).__name__ for ob in self.obstacles],
                "collision_hot": bool(self._collision_hot),
                "stream": self._pack_reader.snapshot(),
                "checkpointer": self._checkpointer.health(),
                "dumper": self._dumper.health()}

    # -- topology-dependent tables -----------------------------------------

    def _coarse(self) -> bool:
        """Whether the solve runs the block-graph coarse level."""
        if self.mesh is not None:
            return False  # the padded geometry carries no tree
        two = (krylov.use_coarse_correction()
               if self._poisson_two_level is None
               else bool(self._poisson_two_level))
        return two and self.cfg.bMeanConstraint not in (1, 3)

    def _build_solver_core(self) -> None:
        cfg = self.cfg
        self._solver_core = amr_ops.build_amr_poisson_solver_dynamic(
            self.grid.bs, tol_abs=cfg.poissonTol, tol_rel=cfg.poissonTolRel,
            maxiter=self._poisson_maxiter, mean_constraint=cfg.bMeanConstraint)

    def _rebuild(self) -> None:
        """Tables, coarse graph and solver binding of the current grid."""
        g, cfg, dev = self.grid, self.cfg, self.device
        t0 = time.perf_counter()
        if self.mesh is not None:
            from cup3d_tpu_torch.parallel.forest import cached_forest

            fo = self.forest = cached_forest(
                g, self.mesh, store_sig=self._aot_content_sig(g.signature))
            self._geom = fo.geom
            self._tab1 = fo.face_tables(1)
            self._tab3 = fo.face_tables(3)
            self._ftab = fo.flux_tables
            self._graph = None
            self.table_build_s.append(time.perf_counter() - t0)
            self._vol = fo.vol.to(self.dtype)
            self._pmask = fo.pmask
            # the bodies' spacing and cell centres, padded with zero rows
            # (the JAX mesh driver's): the Towers chi of a padding block's
            # all-zero SDF lab is 0 at h = 0, and vol = 0 weighs it out
            self._h_col = self._pad(g.h_column(self.dtype, dev))
            self._xc = (self._pad(g.cell_centers(self.dtype, dev))
                        if self._with_bodies else None)
            self._slot0 = 0
            self._build_physics()
            self._bind_solver()
            return
        if self._bucketing:
            return self._rebuild_bucketed()
        self._geom = g
        self._pmask = None
        self._tab1 = g.face_tables(1, dev)
        self._tab3 = g.face_tables(3, dev)
        self._ftab = build_flux_tables(g, dev)
        self._graph = (krylov.block_graph_tables(g, dev) if self._coarse()
                       else None)
        self.table_build_s.append(time.perf_counter() - t0)
        # cell volume h^3 in f64 rounded to the field dtype (the JAX
        # bucketed driver's values)
        self._vol = torch.as_tensor((g.h ** 3).reshape(g.nb, 1, 1, 1),
                                    dtype=self.dtype, device=dev)
        # the bodies' per-block spacing and cell centres (f64 rounded to
        # the field dtype, the JAX package's values)
        self._h_col = g.h_column(self.dtype, dev)
        self._xc = (g.cell_centers(self.dtype, dev) if self._with_bodies
                    else None)
        self._slot0 = 0
        if cfg.bMeanConstraint in (1, 3):
            self._slot0 = int(np.lexsort(
                (g.ijk[:, 2], g.ijk[:, 1], g.ijk[:, 0]))[0])
        self._build_physics()
        self._bind_solver()

    # -- the capacity-bucketed forest (the single-device default) ----------

    def _rebuild_bucketed(self) -> None:
        """The bucketed twin of the unpadded rebuild (JAX
        ``_rebuild_bucketed``): the padded tables from the memo (a miss
        builds them), then the bucket's bound operators from the cache
        (a miss builds them), bound to this topology."""
        g = self.grid
        sig = g.signature
        memo = self._table_memo.pop(sig, None)
        if memo is not None:
            self._table_memo[sig] = memo  # move-to-back (LRU)
        obs_metrics.counter("bucket.table_memo_hits" if memo is not None
                            else "bucket.table_memo_misses").inc()
        if memo is None:
            memo = self._stored_tables(sig)
            if memo is None:
                t0 = time.perf_counter()
                memo = self._bucket_tables()
                self.table_build_s.append(time.perf_counter() - t0)
                obs_metrics.counter("bucket.table_builds").inc()
                self._put_tables(sig, memo)
            self._table_memo[sig] = memo
            while len(self._table_memo) > TABLE_MEMO_ENTRIES:
                self._table_memo.pop(next(iter(self._table_memo)))
        self._cap, geo = memo
        self._geo = geo
        self._geom, self._tab1, self._tab3 = geo.geom, geo.tab1, geo.tab3
        self._ftab, self._graph, self._vol = geo.ftab, geo.graph, geo.vol
        self._xc, self._pmask = geo.xc, geo.mask
        self._slot0 = geo.slot0
        self._h_col = geo.geom.h_column(self.dtype, self.device)
        key = self._bucket_key()
        ops = self._exec_cache.get(key)
        obs_metrics.counter("bucket.exec_cache_hits" if ops is not None
                            else "bucket.exec_cache_misses").inc()
        if ops is None:
            ops = self._exec_cache[key] = self._build_bucket_ops()
        obs_metrics.gauge("bucket.capacity").set(self._cap)
        obs_metrics.gauge("amr.blocks").set(g.nb)
        self._build_physics()
        self._bind_bucket_ops(ops)

    def _bucket_tables(self) -> tuple:
        """(capacity, BucketGeo) of the current grid (:func:`bucket_tables`
        on this driver's device, dtype and knobs)."""
        return bucket_tables(self.grid, self.cfg, self.dtype, self.device,
                             self._with_bodies, self._coarse())

    def _aot_content_sig(self, octree_sig) -> tuple:
        """The compiled store's content key of this layout's tables (JAX
        ``_aot_content_sig``): the octree signature plus every config knob
        the closures capture, plus what the port's table build reads
        (:func:`tables_content_sig`)."""
        return tables_content_sig(
            octree_sig, self.grid, self.cfg, self.dtype, self.nu,
            self._with_bodies, self._coarse(),
            self.mesh.D if self.mesh is not None else None)

    def _stored_tables(self, sig):
        """(capacity, BucketGeo) of topology ``sig`` from the compiled
        store's ``tables`` record (loaded onto this driver's device), or
        None: no store, a miss, or a rejected record."""
        from cup3d_tpu_torch.aot import store as aot_store

        st = aot_store.active_store()
        if st is None:
            return None
        payload = st.get(tables_key(self._aot_content_sig(sig)),
                         name="forest.tables", device=self.device)
        if payload is None:
            return None
        obs_metrics.counter("bucket.table_store_hits").inc()
        return int(payload["cap"]), payload["geo"]

    def _put_tables(self, sig, memo) -> None:
        """Put a live-built topology's tables into the compiled store."""
        from cup3d_tpu_torch.aot import store as aot_store

        st = aot_store.active_store()
        if st is not None:
            st.put(tables_key(self._aot_content_sig(sig)),
                   tables_payload(*memo), name="forest.tables")

    def memo_bytes(self) -> int:
        """Device bytes the table memo holds (every tensor of every
        memoised topology, once)."""
        tensors = {id(t): t for _, geo in self._table_memo.values()
                   for t in _leaves(geo) if isinstance(t, torch.Tensor)}
        return sum(t.numel() * t.element_size() for t in tensors.values())

    def _bucket_key(self) -> tuple:
        """(capacity, the shapes, dtypes and layout data of the geometry
        bundle): equal keys share one bound-operator bundle, the JAX
        package's compiled-step cache key."""
        return (self._cap, tuple(
            (tuple(t.shape), str(t.dtype)) if isinstance(t, torch.Tensor)
            else t for t in _leaves(self._geo)))

    def _build_bucket_ops(self) -> dict:
        """The topology-free operators of a bucket (JAX
        ``_build_bucket_executables``; eager PyTorch has nothing to
        compile): each takes the geometry bundle at call time.  "solver"
        the dynamic Poisson core, "helm" the forest Helmholtz solve
        (implicitDiffusion), "tags" the on-device regrid decision."""
        cfg, core = self.cfg, self._solver_core

        def solver(rhs, x0, geo, **kw):
            kw.setdefault("tab_arg", geo.tab1)
            kw.setdefault("flux_arg", geo.ftab)
            return core(rhs, x0, geom=geo.geom, vol=geo.vol, pmask=geo.mask,
                        graph=geo.graph, slot0=geo.slot0, **kw)

        def tags(vel, chi, geo):
            vort = amr_ops.vorticity_score(geo.geom, vel, geo.tab1)
            near = (None if chi is None
                    else amr_ops.gradchi_mask(geo.geom, chi, geo.tab1))
            return ad.device_tags(vort, near, geo.level, cfg.Rtol, cfg.Ctol,
                                  cfg.levelMax, cfg.levelMaxVorticity,
                                  bool(cfg.bAdaptChiGradient))

        ops = {"solver": solver, "tags": tags, "helm": None}
        if cfg.implicitDiffusion:
            from cup3d_tpu_torch.ops import diffusion as dif

            # the tables it closes over are fallbacks: every call passes
            # the topology's own (tab_arg, flux_arg, geom)
            geo = self._geo
            ops["helm"] = dif.build_amr_helmholtz_solver(
                geo.geom, tol_abs=cfg.diffusionTol,
                tol_rel=cfg.diffusionTolRel, tab=geo.tab1,
                flux_tab=geo.ftab, device=self.device)
        return ops

    def _bind_bucket_ops(self, ops: dict) -> None:
        """Bind a bucket's operators to the current topology (JAX
        ``_bind_bucket_executables``): ``_solver``, ``_helm`` and
        ``_device_tags``."""
        geo = self._geo

        def solver(rhs, x0=None, **kw):
            return ops["solver"](rhs, x0, geo, **kw)

        solver.supports_stats = True
        solver.maxiter = self._solver_core.maxiter
        self._solver = self._arm_costs(solver)
        if ops["helm"] is not None:
            inner = ops["helm"]

            def helm(u, nudt):
                out = inner(u, nudt, tab_arg=geo.tab1, flux_arg=geo.ftab,
                            geom=geo.geom)
                helm.last_stats = inner.last_stats
                return out

            helm.last_stats = []
            self._helm = helm
        self._device_tags = lambda vel, chi: ops["tags"](vel, chi, geo)

    def _build_physics(self) -> None:
        """The topology's implicit-diffusion Helmholtz solve and
        FixMassFlux profile (the reference's avgUx_nonUniform and
        parabolic add, main.cpp:12199-12249: the volume-weighted mean of
        u + uinf over ``vol_total``, then u += delta * 6 eta (1 - eta),
        eta = y/H, zero on padding rows; bucketed, ``vol_total`` is the
        device sum of the padded volumes, as the JAX package's bucketed
        path).  The bucketed forest binds its Helmholtz solve from the
        bucket's operators instead (``_bind_bucket_ops``)."""
        g, cfg = self.grid, self.cfg
        self._helm = None
        if cfg.implicitDiffusion and not self._bucketing:
            kw = dict(tol_abs=cfg.diffusionTol, tol_rel=cfg.diffusionTolRel)
            if self.forest is not None:
                self._helm = self.forest.build_helmholtz_solver(**kw)
            else:
                from cup3d_tpu_torch.ops import diffusion as dif

                self._helm = dif.build_amr_helmholtz_solver(
                    g, tab=self._tab1, flux_tab=self._ftab,
                    device=self.device, **kw)
        self._flux_profile = None
        if cfg.bFixMassFlux:
            self._vol_total = float(np.sum(g.h ** 3) * g.bs ** 3)
            eta = g.cell_centers(self.dtype, self.device)[..., 1] / \
                g.extent[1]
            self._flux_profile = self._pad(6.0 * eta * (1.0 - eta))
            if self.forest is None and self._bucketing:
                self._vol_total = torch.sum(self._vol) * g.bs ** 3
                self._flux_profile = self._flux_profile * self._pmask

    def _bind_solver(self) -> None:
        """``self._solver``: the solver core bound to this topology (the
        sharded forest's static solver on a mesh).  Bucketed, a new core
        invalidates every bucket's operators: they are built anew with it
        and bound."""
        if self.forest is None and self._bucketing:
            self._exec_cache.clear()
            ops = self._exec_cache[self._bucket_key()] = \
                self._build_bucket_ops()
            self._bind_bucket_ops(ops)
            return
        if self.forest is not None:
            cfg = self.cfg
            self._solver = self._arm_costs(self.forest.build_poisson_solver(
                tol_abs=cfg.poissonTol, tol_rel=cfg.poissonTolRel,
                maxiter=self._poisson_maxiter,
                mean_constraint=cfg.bMeanConstraint))
            return
        core, geom = self._solver_core, self.grid
        vol, graph, slot0 = self._vol, self._graph, self._slot0

        def solver(rhs, x0=None, **kw):
            return core(rhs, x0, geom=geom, vol=vol, graph=graph,
                        slot0=slot0, **kw)

        solver.supports_stats = True
        solver.maxiter = core.maxiter
        self._solver = self._arm_costs(solver)

    def _arm_costs(self, solver):
        """The forest bind seam's cost row under ``CUP3D_COSTS=1``
        (obs/costs.py; where the JAX package arms it on the forest's
        bound executables): the first solve on this topology fills the
        row ``forest.poisson`` by the fused and legacy traffic models of
        ops/fused_amr_bicgstab.py (bytes a cell an iteration, times the
        solve's rows of cells, times the iterations it executed) and the
        allocator's peak around it."""
        if not obs_costs.enabled():
            return solver
        from cup3d_tpu_torch.ops import fused_amr_bicgstab as fab

        cells = self._geom.nb * self.grid.bs ** 3
        two = self._graph is not None
        cost = obs_costs.model_cost(
            (fab.bytes_model(two_level=two)["total"] * cells,
             lambda: fab.iterations["executed"]),
            (fab.legacy_bytes_model(two) * cells,
             lambda: krylov.iterations["executed"]))
        return obs_costs.harvest_on_first_call(solver, "forest.poisson",
                                               cost)

    def _alloc_fields(self) -> None:
        g = self.grid
        kw = dict(dtype=self.dtype, device=self.device)
        self.state = {"vel": self._pad(g.zeros(3, **kw)),
                      "p": self._pad(g.zeros(0, **kw))}
        if self._with_bodies:
            self.state["chi"] = self._pad(g.zeros(0, **kw))
            self.state["udef"] = self._pad(g.zeros(3, **kw))

    # -- the surface the bodies address as their ``sim`` ---------------------

    @property
    def step(self) -> int:
        """The step counter under SimulationData's name (the fish's PID)."""
        return self.step_idx

    @property
    def xc(self) -> torch.Tensor:
        """The real blocks' cell centres (nb, bs, bs, bs, 3) on the
        device: the bodies rasterize on them (padded by CreateObstacles)."""
        return self._unpad(self._xc)

    def ubody(self, udef, cm, ut, om) -> torch.Tensor:
        """Rigid + deformation body velocity u_t + om x (x - cm) + udef on
        the whole (padded) forest; the chi that weighs it is 0 on
        padding."""
        xc = self._xc
        return ut + torch.linalg.cross(om.expand_as(xc), xc - cm) + udef

    # the uniform grid's, over this forest's lambda caches
    lambda_device = SimulationData.lambda_device

    def _pad(self, field: torch.Tensor) -> torch.Tensor:
        """Block-axis padding with zero rows: to the sharded forest's
        nb_pad rows on a mesh, to the bucket's capacity on the bucketed
        forest; the identity on the unpadded one (a field already padded
        passes through)."""
        if self.forest is not None:
            return self.forest.pad(field)
        if self._bucketing:
            return bk.pad_field(field, self._cap)
        return field

    def _unpad(self, field: torch.Tensor) -> torch.Tensor:
        """The real blocks' rows."""
        if self.forest is not None or self._bucketing:
            return field[: self.grid.nb]
        return field

    def uinf_device(self) -> torch.Tensor:
        """Device copy of the frame velocity, uploaded when ``uinf`` is
        reassigned (identity check) and reused otherwise."""
        if self._uinf_src is not self.uinf:
            self._uinf_cache = torch.as_tensor(self.uinf, dtype=self.dtype,
                                               device=self.device)
            self._uinf_src = self.uinf
        return self._uinf_cache

    def _maxu(self) -> torch.Tensor:
        """max|u + uinf| over the fluid and, with bodies, max|udef| (the
        body kinematics bound the CFL at once)."""
        vel = self._unpad(self.state["vel"])
        umax = torch.max(torch.abs(vel + self.uinf_device()))
        if self.obstacles:
            umax = torch.maximum(umax,
                                 torch.max(torch.abs(self.state["udef"])))
        return umax

    # -- adaptation ----------------------------------------------------------

    def scores(self):
        """(nb,) max |vorticity| per block and, with bodies, (nb,) bool:
        the block's chi lab has a gradient (it touches an interface;
        None without bodies), on the device; the real blocks' rows."""
        vort = self._unpad(amr_ops.vorticity_score(
            self._geom, self.state["vel"], self._tab1))
        if not self.obstacles:
            return vort, None
        return vort, self._unpad(amr_ops.gradchi_mask(
            self._geom, self.state["chi"], self._tab1))

    def adapt_mesh(self) -> bool:
        """Tag on max |vorticity| per block, the blocks at a body's
        interface forced to refine (bAdaptChiGradient) up to levelMax,
        the others capped at levelMaxVorticity; apply the validated
        states.  Bucketed, the decision is the device's (``device_tags``,
        the same states) and the host reads one int8 tag a slot; else
        both score fields.  Either comes from the pipelined step's
        prefetch when it was staged on a forest of this block count (the
        JAX package's key), else it is computed and read now.  Its bytes
        go to ``adapt_bytes``."""
        g, cfg = self.grid, self.cfg
        pf, self._scores_prefetch = self._scores_prefetch, None
        if pf is not None and pf[1] != g.nb:
            pf = None  # staged on another forest: decide anew
        if pf is not None:
            self.prefetch["hits"] += 1
            vals = pf[0].values()
            self.adapt_bytes.append(pf[0].nbytes)
        else:
            if cfg.pipelined:
                self.prefetch["misses"] += 1
            flat = self._decision_flat()
            vals = flat.cpu().numpy().astype(np.float64)
            self.adapt_bytes.append(flat.numel() * flat.element_size())
        if self._device_tags is not None:
            # the device's decision: one tag a slot, decoded exactly
            return self._apply_states(ad.states_from_tags(
                g, np.rint(vals[: g.nb]).astype(np.int64)))
        score = vals[: g.nb]
        near = (vals[g.nb:] > 0.5 if vals.shape[0] > g.nb
                else np.zeros(g.nb, bool))
        if cfg.bAdaptChiGradient and near.any():
            score = np.where(near, np.inf, score)
        cap = np.where(near, cfg.levelMax - 1, cfg.levelMaxVorticity - 1)
        return self._apply_states(
            ad.tag_states(g, score, cfg.Rtol, cfg.Ctol, cap))

    def _decision_flat(self) -> torch.Tensor:
        """What the host reads for an adaptation: the bucketed forest's
        (capacity,) int8 tags, else both score fields."""
        if self._device_tags is not None:
            return self._device_tags(self.state["vel"], self.state.get("chi"))
        return self._scores_flat()

    def _scores_flat(self) -> torch.Tensor:
        """The real blocks' vorticity scores and, with bodies, their
        near-body flags after them, as one device vector."""
        vort, near = self.scores()
        if near is None:
            return vort
        return torch.cat([vort, near.to(vort.dtype)])

    def _apply_states(self, states) -> bool:
        """Plan -> transfer -> rebuild; False when nothing changes.  Every
        field of the state is carried, the bodies' chi and udef too (the
        next CreateObstacles rasterizes them anew)."""
        g = self.grid
        plan = ad.adapt(g, states)
        if plan is None:
            return False
        for k in self.state:
            self.state[k] = ad.transfer_field(g, plan,
                                              self._unpad(self.state[k]))
        self.grid = plan.new_grid
        self._rebuild()  # on a mesh: a new ShardedForest (a re-shard)
        for k in self.state:
            self.state[k] = self._pad(self.state[k])
        return True

    # -- bodies ----------------------------------------------------------------

    def _add_obstacles(self) -> None:
        content = self.cfg.resolved_factory_content()
        if not content:
            return
        from cup3d_tpu_torch.models.factory import make_obstacles

        self.obstacles = make_obstacles(self, parse_factory(content))

    def create_obstacles(self, dt: float = 0.0, combine: bool = True) -> None:
        """The reference's CreateObstacles (main.cpp:13589-13621) on the
        forest: each body's shape kinematics and SDF on its blocks, its
        Towers chi from the SDF lab assembled through the face tables
        (the ghosts interpolated across coarse-fine faces), its udef
        masked to chi > 0, then the chi-weighted combined fields (the
        megastep combines them itself: ``combine=False``)."""
        if not self.obstacles:
            return
        fixed = [ob for ob in self.obstacles if ob.bFixFrameOfRef]
        if fixed:
            self.uinf = -np.mean([ob.transVel for ob in fixed], axis=0)
        bs = self.grid.bs
        chis, udefs = [], []
        for ob in self.obstacles:
            ob.update_shape(self.time, dt)
            sdf, udef = ob.rasterize(self.time)  # the real blocks' rows
            # padded BEFORE the chi: the padded tables assemble padded
            # labs, and the Towers chi of the all-zero padding SDF is 0
            sdf = self._pad(sdf)
            if udef is not None:
                udef = self._pad(udef)
            chi = towers_chi(self._tab1.assemble_scalar(sdf, bs),
                             self._h_col)
            if udef is None:
                udef = torch.zeros_like(self._xc)
            else:
                udef = udef * (chi > 0)[..., None]
            ob.sdf, ob.chi, ob.udef = sdf, chi, udef
            chis.append(chi)
            udefs.append(udef)
        if not combine:
            return
        stack = torch.stack(chis)
        self.state["chi"] = torch.amax(stack, dim=0)
        den = torch.clamp_min(torch.sum(stack, dim=0), _EPS)[..., None]
        self.state["udef"] = torch.sum(
            stack[..., None] * torch.stack(udefs), dim=0) / den

    def _body_velocity(self) -> torch.Tensor:
        """The chi-weighted combined body velocity field."""
        chis = torch.stack([ob.chi for ob in self.obstacles])
        num = sum(ob.chi[..., None] * ob.body_velocity_field()
                  for ob in self.obstacles)
        den = torch.clamp_min(torch.sum(chis, dim=0), _EPS)[..., None]
        return num / den

    def _update_obstacles(self, dt: float) -> dict:
        """UpdateObstacles: every body's 19 moments and the pairwise
        overlap counts (the collision pre-check) in ONE host read, then
        the host 6x6 solves and rigid updates.  Returns the pre-check
        counts by pair."""
        from cup3d_tpu_torch.models.collisions import overlap_count

        obs, vel = self.obstacles, self.state["vel"]
        n = len(obs)
        cms = upload(np.stack([ob.centerOfMass for ob in obs]), self.dtype,
                     self.device)
        parts = [pack_moments(momentum_integrals_core(
            self._xc, self._vol, ob.chi, vel, cms[i]))
            for i, ob in enumerate(obs)]
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        parts += [overlap_count(obs[i].chi, obs[j].chi).to(self.dtype)
                  .reshape(1) for i, j in pairs]
        vals = torch.cat(parts).cpu().numpy().astype(np.float64)
        precheck = {p: float(v) for p, v in zip(pairs, vals[n * 19:])}
        for ob, row in zip(obs, vals[: n * 19].reshape(n, 19)):
            ob.compute_velocities(unpack_moments(row))
            ob.update(dt)
        return precheck

    def _penalization(self, dt: float, dt_dev, precheck: dict) -> None:
        """The collision pass (more than one body), then Brinkman toward
        the combined body velocity and the penalization forces (their
        rows join the step's read)."""
        s, obs = self.state, self.obstacles
        if len(obs) > 1:
            from cup3d_tpu_torch.models.collisions import (
                prevent_colliding_obstacles)

            def gradchi(chi):
                lab = self._tab1.assemble_scalar(chi, self.grid.bs)
                return amr_ops.grad_blocks(self._geom, lab, self._tab1.width)

            if prevent_colliding_obstacles(
                    obs, [ob.body_velocity_field() for ob in obs], gradchi,
                    self._xc, dt, precheck_counts=precheck):
                self.collisions += 1
        vel_old = s["vel"]
        s["vel"] = penalize(vel_old, s["chi"], self._body_velocity(),
                            self.lambda_device(dt_dev), dt_dev)

        def penal_force(vn, vo, chis, dt_, cms):
            return per_obstacle_penalization_force(vn, vo, chis, dt_,
                                                   self._vol, self._xc, cms)

        PF = update_penalization_forces(obs, penal_force, s["vel"], vel_old,
                                        dt_dev, self.dtype)
        self._pending_parts.append(("penal", PF.reshape(-1)))

    def _compute_forces(self) -> None:
        """ComputeForces: each body's force/torque/power QoI from the
        surface probe on a window of finest-level blocks (reference
        ComputeForces, main.cpp:12250-12503); the rows join the step's
        read."""
        from cup3d_tpu_torch.ops.surface import (
            force_integrals_probe_blocks, obstacle_probe_budget)

        s, obs = self.state, self.obstacles
        h_fine = float(self.grid.h.min())
        kin = upload(np.stack([np.stack([ob.centerOfMass, ob.transVel,
                                         ob.angVel]) for ob in obs]),
                     self.dtype, self.device)
        rows = [pack_forces(force_integrals_probe_blocks(
            self.grid, s["vel"], s["p"], ob.chi, ob.sdf, ob.udef, self.nu,
            ob.position, ob.length, kin[i, 0], kin[i, 1], kin[i, 2],
            max_points=obstacle_probe_budget(ob, h_fine)))
            for i, ob in enumerate(obs)]
        self._pending_parts.append(("forces", torch.stack(rows).reshape(-1)))

    # -- initialization ------------------------------------------------------

    def _ic(self) -> None:
        """Taylor-Green, the coiled vorticity (reference IC_vorticity,
        main.cpp:12506-12668: omega from the coil, then u_d =
        lap^-1(-(curl omega)_d) by three forest Poisson solves), or zero
        velocity for any other initCond (the JAX driver's rule)."""
        g, kw = self.grid, dict(dtype=self.dtype, device=self.device)
        if self.cfg.initCond == "taylorGreen":
            from cup3d_tpu_torch.utils.flows import taylor_green_2d

            self.state["vel"] = self._pad(taylor_green_2d(g, **kw))
        elif self.cfg.initCond == "vorticity":
            from cup3d_tpu_torch.utils.flows import coil_vorticity

            om = self._pad(coil_vorticity(g.cell_centers(**kw)))
            curl = amr_ops.curl_blocks(
                self._geom, self._tab1.assemble_vector(om, g.bs),
                self._tab1.width)
            self.state["vel"] = torch.stack(
                [self._solver(-curl[..., d], tab_arg=self._tab1,
                              flux_arg=self._ftab) for d in range(3)],
                dim=-1)
        else:
            self.state["vel"] = self._pad(g.zeros(3, **kw))
        self.state["p"] = self._pad(g.zeros(0, **kw))

    def init(self) -> None:
        """The bodies, the IC, then up to 3*levelMax rounds of {adapt;
        re-create the bodies; re-IC} to converge the initial grid onto
        them (main.cpp:15163-15178).  Pipelined, a roll-corrected fish is
        refused (its host angVel correction cannot ride the device rigid
        chain)."""
        self._add_obstacles()
        if self.cfg.pipelined:
            for ob in self.obstacles:
                if getattr(ob, "bCorrectRoll", False):
                    raise ValueError(
                        "pipelined mode cannot run roll-corrected "
                        "obstacles (host-side angVel mutation) — run "
                        "without -pipelined")
        self.create_obstacles()
        self._ic()
        for _ in range(3 * self.cfg.levelMax):
            changed = self.adapt_mesh()
            self.create_obstacles()
            self._ic()
            if not changed:
                break
        self._dt_chain = self._use_device_dt()
        self.prefetch = {"hits": 0, "misses": 0}  # count the steps' only

    # -- stepping ------------------------------------------------------------

    def _use_device_dt(self) -> bool:
        """The device dt chain: pipelined obstacle-free runs on the
        unsharded forest stopped by a step count, with no fixed dt, no
        diagnostics or flux.txt rows and no dump cadence by time (the
        uniform driver's rule; the JAX package keeps the sharded forest on
        the host dt).  ``dtDevice`` -1 turns it on for the card, 1
        everywhere, 0 nowhere."""
        cfg = self.cfg
        if not cfg.pipelined or self.obstacles or self.forest is not None:
            return False
        if cfg.dt > 0 or cfg.tend > 0 or cfg.nsteps <= 0:
            return False
        if cfg.tdump > 0 or cfg.bFixMassFlux:
            return False
        if cfg.freqDiagnostics > 0 or cfg.dtDevice == 0:
            return False
        return cfg.dtDevice == 1 or self.device.type == "cuda"

    def _runaway(self, umax: float) -> None:
        self.logger.flush()
        reason = ("nan-velocity" if not np.isfinite(umax)
                  else "runaway-velocity")
        extra = {"step": self.step_idx, "umax": umax}
        self.flight.trigger(reason, extra=extra)
        raise SimulationFailure(
            reason, f"runaway velocity: max|u|={umax:.3g}", extra)

    def _calc_dt_device(self) -> torch.Tensor:
        """The CFL dt from the previous step's DEVICE max|u|: the
        non-pipelined one-step-lag policy (no margin, no growth bound),
        with no read.  The runaway abort checks the freshest consumed
        host mirror (an abort tolerates lag; the dt does not)."""
        from cup3d_tpu_torch.sim import dtpolicy

        cfg = self.cfg
        if faults.fire("step.nan_velocity", self.step_idx):
            self._umax_next = float("nan")
        um = self._umax_next
        if um is not None and (not np.isfinite(um) or um > cfg.uMax_allowed):
            self._runaway(um)
        if self._umax_dev is None:
            self._umax_dev = self._maxu()
        if self._time_dev is None:
            self._time_dev = upload(np.float64(self.time), self.dtype,
                                    self.device)
        cfl = dtpolicy.ramped_cfl(cfg.CFL, self.step_idx, cfg.rampup)
        hmin = float(self.grid.h.min())
        if cfg.implicitDiffusion:
            dt = dtpolicy.dt_device_implicit(self._umax_dev, cfl, hmin,
                                             self.nu, self.step_idx > 10)
        else:
            dt = dtpolicy.dt_device(self._umax_dev, cfl, hmin, self.nu)
        eng = self._resilience
        if eng is not None and eng.dt_scale != 1.0:
            # retry halving on the device, floored as scale_dt floors
            dt = torch.maximum(dt * eng.dt_scale,
                               torch.clamp_max(dt, eng.dt_floor))
        self._last_umax = um
        return dt

    def calc_max_timestep(self):
        """CFL dt with the diffusive cap and log ramp-up, from max|u| read
        at the end of the previous step (or read now); aborts on a NaN or
        runaway velocity and on a collapsed dt.  Pipelined, max|u| is the
        latest consumed one (floored by the bodies' host speed) with a
        1.5x staleness margin and a 1.03x growth bound; on the device dt
        chain the dt is a device tensor (no read)."""
        from cup3d_tpu_torch.sim import dtpolicy

        cfg = self.cfg
        if self._dt_chain:
            return self._calc_dt_device()
        hmin = float(self.grid.h.min())
        if faults.fire("step.nan_velocity", self.step_idx):
            self._umax_next = float("nan")
        if self._umax_next is not None:
            umax = self._umax_next
            if not cfg.pipelined:
                self._umax_next = None
            else:
                # keep the latest consumed max|u| (the reader may still be
                # in flight), floored by the fresh host body speed: a gait
                # spin-up outruns the stale mirror
                for ob in self.obstacles:
                    umax = max(umax, ob.max_body_speed(self.uinf))
        else:
            umax = float(self._maxu())
        self._last_umax = umax
        if not np.isfinite(umax) or umax > cfg.uMax_allowed:
            self._runaway(umax)
        if cfg.dt > 0:
            self.dt = cfg.dt
        else:
            prev_dt = self.dt
            if cfg.pipelined:
                # the stale-max|u| margin (see sim/simulation.py)
                umax = 1.5 * umax
            self.dt = dtpolicy.dt_host(hmin, self.nu, umax, cfg.CFL,
                                       self.step_idx, cfg.rampup,
                                       cfg.implicitDiffusion)
            if cfg.pipelined and prev_dt > 0:
                self.dt = min(self.dt, 1.03 * prev_dt)
            if cfg.tend > 0:
                self.dt = min(self.dt, cfg.tend - self.time)
        if self._resilience is not None:
            self.dt = self._resilience.scale_dt(self.dt)
        if faults.fire("dt.collapse", self.step_idx):
            self.dt = float("nan")
        if not np.isfinite(self.dt) or self.dt <= 0:
            extra = {"step": self.step_idx, "dt": self.dt, "umax": umax}
            self.flight.trigger("dt-collapse", extra=extra)
            raise SimulationFailure(
                "dt-collapse", f"dt policy collapse: dt={self.dt:.3g}",
                extra)
        if cfg.DLM > 0:
            self.lambda_penal = cfg.DLM / self.dt
        return self.dt

    # -- output ------------------------------------------------------------

    def _maybe_dump_save(self) -> None:
        if self._cadence.dump_due(self.time, self.step_idx):
            self.flush_packs()  # host mirrors current before output
            self.dump_fields()
        if self._cadence.save_due(self.step_idx):
            self.flush_packs()
            with self.profiler("Checkpoint"):
                self._save_checkpoint_guarded()

    def _save_checkpoint_guarded(self) -> None:
        """The uniform driver's policy (stream/checkpoint.py
        ``save_guarded``)."""
        from cup3d_tpu_torch.stream.checkpoint import save_guarded

        save_guarded(self._checkpointer, self)

    def dump_fields(self) -> None:
        """Stage this step's forest fields (block-major, the real blocks'
        rows) for the sharded writer; chi is zero without bodies, as the
        JAX package's obstacle-free forest's."""
        import os

        from cup3d_tpu_torch.io import dump as dmp

        vel = self._unpad(self.state["vel"])
        chi = self.state.get("chi")
        view = {"vel": vel, "chi": (torch.zeros_like(vel[..., 0])
                                    if chi is None else self._unpad(chi))}

        def omega_mag(_vel):
            om = amr_ops.curl_blocks(
                self._geom,
                self._tab1.assemble_vector(self.state["vel"], self.grid.bs),
                self._tab1.width)
            return self._unpad(torch.sqrt(torch.sum(om * om, dim=-1)))

        fields = dmp.collect_dump_fields_device(self.cfg, view, omega_mag)
        if fields:
            prefix = os.path.join(self.cfg.path4serialization,
                                  f"dump_{self.step_idx:07d}")
            with self.profiler("Dump"):
                # the grid handed over is this step's: adaptation replaces
                # the BlockGrid, never mutates it
                self._dumper.submit(prefix, self.time, self.grid, fields,
                                    step=self.step_idx)

    def drain_streams(self) -> None:
        """Join all pending dumps and checkpoints (run end, and anything
        that must observe the files on disk)."""
        from cup3d_tpu_torch.stream.checkpoint import drain

        drain(self._dumper, self._checkpointer, self)

    # -- the step ----------------------------------------------------------

    def advance(self, dt) -> None:
        """One step: the pipelined megastep (with or without bodies) unless
        the collision fallback is latched, else the host path.  ``dt`` a
        host float, or the device dt of the dt chain."""
        if self.cfg.pipelined and not self._collision_hot:
            if self.obstacles:
                return self.advance_pipelined(dt)
            return self.advance_pipelined_free(dt)
        if self.cfg.pipelined and self.obstacles:
            self.collision_fallbacks += 1
        return self._advance_host(dt)

    def _advance_host(self, dt: float) -> None:
        """One step of the host path (JAX ``_advance_host``); also the
        collision fallback of pipelined stepping."""
        if self.cfg.pipelined or self._pack_reader:
            # entering the host path from pipelined stepping: the mirrors
            # must be current and the device chains dropped (also when a
            # flush has already emptied the stream)
            self.flush_packs()
            for ob in self.obstacles:
                ob._dev_rigid = None
            self._uinf_dev = None
        s, prof = self.state, self.profiler
        t0 = time.perf_counter()
        self._maybe_dump_save()
        dt_dev = torch.tensor(dt, dtype=self.dtype, device=self.device)
        # the frame velocity of the step's start: CreateObstacles moves
        # the swimming frame for the rigid update, not for the advection
        # (the JAX host path's order)
        uinf = self.uinf_device()
        if self._adapt_due(self.step_idx):
            with prof("AdaptMesh"):
                self.adapt_mesh()
        if self.obstacles:
            with prof("CreateObstacles"):
                self.create_obstacles(dt)
        g, geom = self.grid, self._geom
        with prof("AdvectionDiffusion"):
            s["vel"] = self._advdiff(s["vel"], dt_dev, uinf)
        overlap_now = False
        if self.obstacles:
            with prof("UpdateObstacles"):
                precheck = self._update_obstacles(dt)
                overlap_now = any(v > 0 for v in precheck.values())
            with prof("Penalization"):
                self._penalization(dt, dt_dev, precheck)
        if self.cfg.bFixMassFlux or self.cfg.uMax_forced > 0:
            with prof("FixMassFlux" if self.cfg.bFixMassFlux
                      else "ExternalForcing"):
                s["vel"], u_msr = self._forcing(s["vel"], self.uinf_device(),
                                                dt)
                if u_msr is not None:
                    self._log_flux(self.step_idx, self.time, float(u_msr))
        with prof("PressureProjection"):
            # warm start from the previous pressure; after step_2nd_start
            # the reference's increment form (main.cpp:15087-15100)
            s["vel"], s["p"], psolve = amr_ops.project_blocks(
                geom, s["vel"], dt_dev, self._solver, self._tab1, self._ftab,
                chi=s.get("chi") if self.obstacles else None,
                udef=s.get("udef") if self.obstacles else None,
                p_init=s["p"],
                second_order=self.step_idx >= self.cfg.step_2nd_start,
                with_stats=True)
            self._pending_parts.append(("psolve", psolve))
        if self.obstacles:
            with prof("ComputeForces"):
                self._compute_forces()
        self._log_diagnostics()
        with prof("SyncQoI"):
            # ONE blocking read of everything the step produced: the
            # penalization forces, the force QoI, the solver's [residual,
            # iterations] and max|u| for the next dt
            parts = self._pending_parts + [("umax", self._maxu().reshape(1))]
            self._pending_parts = []
            self._consume_entry(self._pack_reader.pack_parts(
                parts, self.dtype, time=self.time, step=self.step_idx,
                nb=g.nb, dt=dt, umax_dt=self._last_umax, wall_s=None))
            self.step_log[-1]["wall_s"] = time.perf_counter() - t0
        # the collision fallback: the host path just measured fresh
        # overlap counts; resume the pipelined step once they are clear
        if self._collision_hot:
            latched = any(ob.collision_counter > 0 for ob in self.obstacles)
            if not latched and not overlap_now:
                self._collision_hot = False
        self.step_idx += 1
        self.time += dt

    def _adapt_due(self, step: int) -> bool:
        return self.adapt_enabled and (step < 10 or step % ADAPT_EVERY == 0)

    # -- the stages the host path and the megastep share ---------------------

    def _advdiff(self, vel: torch.Tensor, dt, uinf) -> torch.Tensor:
        """AdvectionDiffusion: RK3, or with ``implicitDiffusion`` Euler
        advection and the Helmholtz solve a component."""
        if self._helm is not None:
            from cup3d_tpu_torch.ops import diffusion as dif

            return dif.implicit_step_blocks(self._geom, vel, dt, self.nu,
                                            uinf, self._tab3, self._helm)
        return amr_ops.rk3_step_blocks(self._geom, vel, dt, self.nu, uinf,
                                       self._tab3, self._ftab)

    def _forcing(self, vel: torch.Tensor, uinf, dt):
        """FixMassFlux, or the constant streamwise acceleration of
        ``uMax_forced`` (ExternalForcing, main.cpp:10581-10596; padding
        rows stay 0).  Returns (vel, the measured
        bulk velocity as a 0-dim tensor, or None)."""
        cfg = self.cfg
        if cfg.bFixMassFlux:
            u_target = 2.0 / 3.0 * cfg.uMax_forced
            u_msr = torch.sum((vel[..., 0] + uinf[0]) * self._vol) / \
                self._vol_total
            add = (u_target - u_msr) * self._flux_profile
            return torch.cat([vel[..., :1] + add[..., None], vel[..., 1:]],
                             dim=-1), u_msr
        if cfg.uMax_forced > 0:
            H = self.grid.extent[1]
            add = 8.0 * self.nu * cfg.uMax_forced / (H * H) * dt
            if self._pmask is not None:
                add = add * self._pmask.reshape(-1, 1, 1, 1)
                return torch.cat([vel[..., :1] + add[..., None],
                                  vel[..., 1:]], dim=-1), None
            return torch.cat([vel[..., :1] + add, vel[..., 1:]],
                             dim=-1), None
        return vel, None

    def _log_flux(self, step: int, t: float, u_msr: float) -> None:
        """flux.txt row ``step time u_bulk target`` (the producing step's
        index and time on both paths)."""
        u_target = 2.0 / 3.0 * self.cfg.uMax_forced
        self.logger.write("flux.txt",
                          f"{step} {t:.8e} {u_msr:.8e} {u_target:.8e}\n")

    # -- pipelined stepping: the megastep and the QoI stream ----------------

    def _prefetch_scores(self) -> None:
        """Stage the next step's adaptation scores when it adapts: their
        compute and host copy overlap this step's host work."""
        if self._adapt_due(self.step_idx + 1):
            self._scores_prefetch = (
                self._pack_reader.stage(self._decision_flat()), self.grid.nb)

    def _emit(self, parts: list, dt, dt_dev, t0: float) -> None:
        """The step's QoI pack into the stream, the step counter and, off
        the dt chain, the host time advanced.  On the chain the pack
        carries the step's dt and the time after it."""
        if isinstance(dt, torch.Tensor):
            self._time_dev = self._time_dev + dt_dev
            parts += [("dt", dt_dev.reshape(1)),
                      ("time", self._time_dev.reshape(1))]
        entry = self._pack_reader.pack_parts(
            parts, self.dtype, time=self.time, step=self.step_idx,
            nb=self.grid.nb, umax_dt=self._last_umax,
            dt=None if isinstance(dt, torch.Tensor) else dt,
            wall_s=time.perf_counter() - t0)
        self._pack_reader.emit(entry)
        self.step_idx += 1
        if not isinstance(dt, torch.Tensor):
            self.time += dt

    def _megastep_free(self, vel, p, uinf, dt):
        """The obstacle-free megastep: advection, forcing, projection and
        max|u|.  Returns (vel, p, pack parts)."""
        vel = self._advdiff(vel, dt, uinf)
        vel, flux_msr = self._forcing(vel, uinf, dt)
        vel, p, psolve = amr_ops.project_blocks(
            self._geom, vel, dt, self._solver, self._tab1, self._ftab,
            p_init=p, second_order=self.step_idx >= self.cfg.step_2nd_start,
            with_stats=True)
        umax = torch.max(torch.abs(self._unpad(vel) + uinf)).reshape(1)
        return vel, p, self._pack_tail(flux_msr, umax, psolve, vel)

    def _pack_tail(self, flux_msr, umax, psolve, like) -> list:
        flux = (torch.zeros(1, dtype=like.dtype, device=like.device)
                if flux_msr is None else flux_msr.reshape(1))
        return [("flux", flux), ("umax", umax), ("psolve", psolve)]

    def advance_pipelined_free(self, dt) -> None:
        """The obstacle-free pipelined step: one megastep, its pack into
        the stream, the next adaptation's scores staged."""
        s = self.state
        t0 = time.perf_counter()
        dt_dev = (dt if isinstance(dt, torch.Tensor) else
                  torch.tensor(dt, dtype=self.dtype, device=self.device))
        self._maybe_dump_save()
        if self._adapt_due(self.step_idx):
            with self.profiler("AdaptMesh"):
                self.adapt_mesh()
        with self.profiler("Megastep"):
            uinf = (self._uinf_dev if self._uinf_dev is not None
                    else self.uinf_device())
            s["vel"], s["p"], parts = self._megastep_free(
                s["vel"], s["p"], uinf, dt_dev)
            # the device dt chain: the next step's CFL scale, never read
            self._umax_dev = dict(parts)["umax"][0]
            self._prefetch_scores()
        self._log_diagnostics()
        with self.profiler("SyncQoI"):
            self._emit(parts, dt, dt_dev, t0)

    def _megastep(self, vel, p, chis, udefs, sdfs, rigid, forced, blocked,
                  fixmask, windows, budgets, uinf, dt, lam):
        """The megastep with bodies (JAX ``mega``): advection, every
        body's rigid update on the device, Brinkman penalization toward
        the combined body velocity, forcing, projection, the surface
        probe of each body, the pairwise overlap counts and the next
        step's frame velocity.  Returns (vel, p, chi, udef, uinf_next,
        pack parts)."""
        n = chis.shape[0]
        xc, vol = self._xc, self._vol
        chi = torch.amax(chis, dim=0)
        den = torch.clamp_min(torch.sum(chis, dim=0), _EPS)[..., None]
        udef = torch.sum(chis[..., None] * udefs, dim=0) / den

        vel = self._advdiff(vel, dt, uinf)

        cms = rigid[:, 12:15]
        M = torch.stack([pack_moments(momentum_integrals_core(
            xc, vol, chis[i], vel, cms[i])) for i in range(n)])
        out = rigid_update_bodies(M, rigid, forced, blocked, uinf, dt)
        cm_new = out[:, 12:15]
        ub = torch.stack([self.ubody(udefs[i], out[i, 12:15], out[i, 0:3],
                                     out[i, 3:6]) for i in range(n)])
        ubody = torch.sum(chis[..., None] * ub, dim=0) / den

        vel_old = vel
        vel = penalize(vel, chi, ubody, lam, dt)
        PF = -per_obstacle_penalization_force(
            vel, vel_old, tuple(chis[i] for i in range(n)), dt, vol, xc,
            cm_new)

        vel, flux_msr = self._forcing(vel, uinf, dt)

        vel, p, psolve = amr_ops.project_blocks(
            self._geom, vel, dt, self._solver, self._tab1, self._ftab, chi,
            udef, p_init=p,
            second_order=self.step_idx >= self.cfg.step_2nd_start,
            with_stats=True)

        from cup3d_tpu_torch.models.collisions import overlap_count
        from cup3d_tpu_torch.ops.surface import probe_blocks_core

        F = torch.stack([pack_forces(probe_blocks_core(
            vel, p, chis[i], sdfs[i], udefs[i], slots, shape, b0, h,
            self.nu, cm_new[i], out[i, 0:3], out[i, 3:6],
            max_points=budgets[i]))
            for i, (slots, shape, b0, h) in enumerate(windows)])
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        overlaps = (torch.stack([overlap_count(chis[i], chis[j])
                                 .to(self.dtype) for i, j in pairs])
                    if pairs else torch.zeros(0, dtype=self.dtype,
                                              device=self.device))
        # the next step's frame velocity from the NEW rigid state
        nfix = torch.sum(fixmask)
        mean_tv = torch.sum(out[:, 0:3] * fixmask[:, None], dim=0) / \
            torch.clamp_min(nfix, 1.0)
        uinf_next = torch.where(nfix > 0, -mean_tv, uinf)
        umax = torch.maximum(torch.max(torch.abs(vel + uinf_next)),
                             torch.max(torch.abs(udef))).reshape(1)
        parts = [("rigid", out.reshape(-1)),
                 ("penal", PF.reshape(-1).to(self.dtype)),
                 ("forces", F.reshape(-1)), ("overlap", overlaps)]
        parts += self._pack_tail(flux_msr, umax, psolve, vel)
        return vel, p, chi, udef, uinf_next, parts

    def advance_pipelined(self, dt: float) -> None:
        """The pipelined step with bodies: CreateObstacles, one megastep,
        its pack into the stream (read a few steps later), the bodies'
        rigid state chained on the device, the next adaptation's scores
        staged; when the host mirrors show two bodies near contact, an
        early read."""
        from cup3d_tpu_torch.ops.surface import (block_window_slots,
                                                 obstacle_probe_budget)

        s, obs = self.state, self.obstacles
        t0 = time.perf_counter()
        dt_dev = torch.tensor(dt, dtype=self.dtype, device=self.device)
        self._maybe_dump_save()
        if self._adapt_due(self.step_idx):
            with self.profiler("AdaptMesh"):
                # no flush: the packs stay readable after a re-layout and
                # the rigid chains do not depend on the field layout
                self.adapt_mesh()
        with self.profiler("CreateObstacles"):
            self.create_obstacles(dt, combine=False)
        with self.profiler("Megastep"):
            g = self.grid
            h_fine = float(g.h0 / (1 << (len(g._slot_maps) - 1)))
            # the probe's slot budgets of this step (the JAX package
            # retraces its megastep when they move)
            budgets = tuple(obstacle_probe_budget(ob, h_fine) for ob in obs)
            windows = []
            for ob in obs:
                slots, b0, h = block_window_slots(
                    g, np.asarray(ob.position), ob.length)
                windows.append((upload(slots.reshape(-1), torch.long,
                                       self.device), slots.shape, b0,
                                float(np.float32(h))))
            rigid = torch.stack([ob.rigid_state_dev(self.dtype)
                                 for ob in obs])
            forced = torch.stack([ob.forced_mask_dev() for ob in obs])
            blocked = torch.stack([ob.block_mask_dev() for ob in obs])
            fixmask = upload(np.array([1.0 if ob.bFixFrameOfRef else 0.0
                                       for ob in obs]), self.dtype,
                             self.device)
            uinf = (self._uinf_dev if self._uinf_dev is not None
                    else self.uinf_device())
            (s["vel"], s["p"], s["chi"], s["udef"], self._uinf_dev,
             parts) = self._megastep(
                s["vel"], s["p"], torch.stack([ob.chi for ob in obs]),
                torch.stack([ob.udef for ob in obs]),
                torch.stack([ob.sdf for ob in obs]), rigid, forced, blocked,
                fixmask, windows, budgets, uinf, dt_dev,
                self.lambda_device(dt_dev))
            out = dict(parts)["rigid"].reshape(len(obs), RIGID_PACK)
            for i, ob in enumerate(obs):
                row = out[i]
                ob._dev_rigid = {"step": self.step_idx, "pack": row,
                                 "trans": row[0:3], "ang": row[3:6],
                                 "cm": row[12:15]}
                ob._ubody_cache = None
            self._prefetch_scores()
        self._log_diagnostics()
        with self.profiler("SyncQoI"):
            self._emit(parts, dt, dt_dev, t0)
            # the overlap counts in the packs are read a few steps late:
            # when the (stale) mirrors put two bodies within a few fine
            # cells of contact, start the read now
            if len(obs) > 1 and self._mirrors_near_contact():
                self._pack_reader.kick()

    def _mirrors_near_contact(self, margin_cells: float = 6.0) -> bool:
        h_fine = float(self.grid.h.min())
        obs = self.obstacles
        for i in range(len(obs)):
            for j in range(i + 1, len(obs)):
                half = 0.5 * (obs[i].length + obs[j].length)
                d = np.abs(np.asarray(obs[i].position)
                           - np.asarray(obs[j].position))
                if np.all(d < half + margin_cells * h_fine):
                    return True
        return False

    def flush_packs(self) -> None:
        """Drain the in-flight reads and pending packs so the host mirrors
        are current (output, snapshots, the host path's entry)."""
        self._pack_reader.flush()

    def _consume_entry(self, entry: dict) -> None:
        """Apply one step's pack (read now on the host path, by the stream
        when pipelined): the bodies' rigid mirrors (the device chain
        kept), their forces and force log, the collision latch, the
        flux.txt row and the solver stats of the PRODUCING step, max|u|
        for the next dt and, on the dt chain, the host dt and time; then
        the step's ``step_log`` row and flight record."""
        vals = entry.get("vals")
        if vals is None:
            vals = entry["pack"].cpu().to(torch.float64).numpy()
        obs = self.obstacles
        step = int(entry["step"])
        row = {"step": step, "time": entry["time"], "dt": entry["dt"],
               "nb": entry["nb"], "wall_s": entry["wall_s"]}
        off = 0
        for name, size in entry["layout"]:
            seg = vals[off:off + size]
            off += size
            if name == "rigid":
                for i, ob in enumerate(obs):
                    ob.apply_rigid_pack(
                        seg[RIGID_PACK * i:RIGID_PACK * (i + 1)],
                        clear_dev=False)
            elif name == "penal":
                for i, ob in enumerate(obs):
                    ob.penal_force = seg[6 * i:6 * i + 3]
                    ob.penal_torque = seg[6 * i + 3:6 * i + 6]
            elif name == "forces":
                for i, ob in enumerate(obs):
                    store_force_qoi(ob, unpack_forces(
                        seg[FORCE_PACK * i:FORCE_PACK * (i + 1)]))
                    log_forces(self.logger, i, entry["time"], ob)
            elif name == "overlap":
                if np.any(seg > 0):
                    # a stale contact signal: the host path (its fresh
                    # pre-check and collision pass) until it is clear
                    self._collision_hot = True
            elif name == "flux":
                if self.cfg.bFixMassFlux:
                    self._log_flux(step, entry["time"], float(seg[0]))
            elif name == "umax":
                self._umax_next = row["umax"] = float(seg[0])
            elif name == "psolve":
                row["resid"], row["iters"] = float(seg[0]), float(seg[1])
                self._obs.note_solver(
                    step, row["iters"], row["resid"],
                    cap=getattr(self._solver, "maxiter", None))
            elif name == "dt":
                self.dt = row["dt"] = float(seg[0])
            elif name == "time":
                self.time = float(seg[0])
                row["time"] = self.time - row["dt"]
        # the host frame velocity from the mirrors a pipelined pack
        # refreshed (logs, dumps; the host path keeps the one its
        # CreateObstacles set)
        fixed = [ob for ob in obs if ob.bFixFrameOfRef]
        if fixed and entry["layout"][0][0] == "rigid":
            self.uinf = -np.mean([ob.transVel for ob in fixed], axis=0)
        self.step_log.append(row)
        self.flight.record_step({"step": step, "t": row["time"],
                                 "dt": row["dt"], "umax": entry["umax_dt"],
                                 "nb": row["nb"], "wall_s": row["wall_s"],
                                 "solver": self._obs.last_solver})

    def _log_diagnostics(self) -> None:
        """div.txt/energy.txt rows every freqDiagnostics steps."""
        freq = self.cfg.freqDiagnostics
        if freq <= 0 or self.step_idx % freq:
            return
        with self.profiler("Diagnostics"):
            g, vel = self._geom, self.state["vel"]
            total, peak = amr_ops.divergence_norms_blocks(g, vel, self._tab1)
            self.logger.write(
                "div.txt",
                f"{self.step_idx} {self.time:.8e} {float(total):.8e}"
                f" {float(peak):.8e}\n")
            d = amr_ops.dissipation_blocks(g, vel, self.nu, self._tab1)
            self.logger.write(
                "energy.txt",
                f"{self.time:.8e} {float(d['kinetic_energy']):.8e} "
                f"{float(d['enstrophy']):.8e}"
                f" {float(d['dissipation_rate']):.8e}\n")

    # -- resilience hooks (resilience/recovery.py driver contract) ---------

    def _resilience_restore(self, payload: dict) -> None:
        """In-place rollback to a ``build_payload``-shaped snapshot: the
        forest of its leaf keys (the live grid and its tables when the
        keys are the live forest's, else a rebuild), its fields cloned in
        (the snapshot survives repeated restores), its scalars, and its
        bodies unpickled from their host state, their chi/udef/sdf
        rebuilt by CreateObstacles(0.0)."""
        import pickle

        keys = [tuple(int(v) for v in k) for k in payload["leaves"]]
        if keys != self.grid.keys:
            self.grid = grid_from_keys(self.grid, keys)
            self._rebuild()  # bucketed: a memo hit when seen lately
        nb = len(keys)
        self.state = {k: self._pad(torch.clone(v[:nb]))
                      for k, v in payload["fields"].items()}
        self.time = float(payload["time"])
        self.step_idx = int(payload["step"])
        self.dt = float(payload["dt"])
        self.uinf = np.asarray(payload["uinf"], np.float64)
        self.lambda_penal = float(payload["lambda_penal"])
        self._cadence.next_dump = float(payload["next_dump"])
        obstacles = payload.get("obstacles") or []
        if isinstance(obstacles, bytes):
            obstacles = pickle.loads(obstacles)
        self.obstacles = list(obstacles)
        for ob in self.obstacles:
            ob.sim = self
        self._pending_parts = []
        self._umax_next = None
        self._last_umax = None
        self._umax_dev = self._time_dev = self._uinf_dev = None
        self._scores_prefetch = None
        self._collision_hot = False
        # packs of the abandoned trajectory must never apply
        self._pack_reader.abandon()
        if self.obstacles:
            self.create_obstacles(0.0)

    def _resilience_zero_pressure(self) -> None:
        """Ladder stage 'zero-guess': the next solve starts from p = 0."""
        self.state["p"] = torch.zeros_like(self.state["p"])

    def _resilience_rebuild_poisson(self, two_level=None,
                                    maxiter_mult: int = 1) -> None:
        """Ladder stages 'tile-only' / 'iter-bump': rebuild the solver
        with the block graph dropped (the fused forest solve then runs the
        tile-only getZ kernel B10) and/or a bigger iteration budget.  The
        face and flux tables do not depend on the solver and stay on the
        unpadded forest; the bucketed one clears both caches (the memo
        carries the graph, the bucket's operators the solver) and
        rebuilds, as the JAX package does."""
        self._poisson_two_level = two_level
        self._poisson_maxiter = 1000 * int(maxiter_mult)
        self._build_solver_core()
        if self.forest is None and self._bucketing:
            self._exec_cache.clear()
            self._table_memo.clear()
            self._rebuild()
            return
        if not self._coarse():
            self._graph = None
        elif self._graph is None:  # (never on a mesh: no coarse level)
            self._graph = krylov.block_graph_tables(self.grid, self.device)
        self._bind_solver()

    def simulate(self) -> None:
        """loop { calc_max_timestep; advance } to ``tend`` or ``nsteps``,
        through the RecoveryEngine unless ``CUP3D_RECOVER=0``; only
        SimulationFailures of a recoverable reason are retried.
        Pipelined, the stream is drained before each snapshot (the
        snapshot pickles the host mirrors, which must equal the device
        chains' state) and at the end."""
        cfg = self.cfg
        eng = RecoveryEngine.install(self)
        try:
            while True:
                # the capture-window hook (disarmed: one branch)
                self._obs_profile.on_step(self.step_idx)
                if (eng is not None and cfg.pipelined
                        and eng.snapshot_due(self.step_idx)):
                    try:
                        self.flush_packs()
                    except Exception as e:
                        if eng.handle_failure(e):
                            continue
                        raise
                if eng is not None and eng.on_loop_top():
                    continue  # rolled back: restart the iteration
                try:
                    dt = self.calc_max_timestep()
                    if cfg.verbose:
                        print(f"cup3d_tpu_torch[amr]: step: {self.step_idx},"
                              f" time: {self.time:f}, dt: {float(dt):.3e}, "
                              f"blocks: {self.grid.nb}")
                    with self._obs.step(self.step_idx, self.time, dt,
                                        nb=int(self.grid.nb)):
                        self.advance(dt)
                except Exception as e:
                    if eng is not None and eng.handle_failure(e):
                        continue  # rolled back: retry from the snapshot
                    raise
                done_t = cfg.tend > 0 and self.time >= cfg.tend - 1e-12
                done_n = cfg.nsteps > 0 and self.step_idx >= cfg.nsteps
                if done_t or done_n:
                    break
            self.flush_packs()
            self.drain_streams()
            self.logger.flush()
        finally:
            if eng is not None:
                eng.uninstall()


# ---------------------------------------------------------------------------
# carrying an AMR state between the packages
# ---------------------------------------------------------------------------


def tree_from_keys(tree_cfg: TreeConfig, keys) -> Octree:
    """The balanced octree whose leaves are ``keys`` (level, i, j, k)."""
    tree = Octree(tree_cfg, 0)
    tree.leaves.clear()
    for k in keys:
        tree.leaves[tuple(int(v) for v in k)] = None
    tree.assert_balanced()
    return tree


def grid_from_keys(like: BlockGrid, keys) -> BlockGrid:
    """A BlockGrid of ``like``'s extent, BCs and block size on the forest
    of ``keys``, which must be in its Hilbert slot order."""
    keys = [tuple(int(v) for v in k) for k in keys]
    grid = BlockGrid(tree_from_keys(like.tree.cfg, keys), like.extent,
                     like.bc, like.bs)
    if grid.keys != keys:
        raise ValueError("keys are not in the forest's Hilbert slot order")
    return grid


def state_to_numpy(sim: AMRSimulation):
    """(arrays, scalars) in the form :func:`load_state_numpy` takes: the
    octree's leaf keys in slot order ``keys`` (nb, 4) and the block
    fields (``vel``/``p``, and ``chi``/``udef`` with bodies), plus
    time/step/dt/uinf and, with bodies, ``bodies``: their host state
    (sim/data.obstacle_state_to_numpy: rigid mirrors, gait, PID)."""
    arrays = {k: sim._unpad(v).detach().cpu().numpy()
              for k, v in sim.state.items()}
    arrays["keys"] = np.asarray(sim.grid.keys, np.int64).reshape(-1, 4)
    scalars = {"time": sim.time, "step": sim.step_idx, "dt": sim.dt,
               "uinf": np.array(sim.uinf, dtype=np.float64)}
    if sim.obstacles:
        scalars["bodies"] = obstacle_state_to_numpy(sim)
    return arrays, scalars


def load_state_numpy(sim: AMRSimulation, arrays: Dict[str, np.ndarray],
                     scalars: Dict[str, object]) -> None:
    """Set ``sim``'s forest, fields and bodies from numpy, e.g. a JAX
    run's ``keys = np.asarray(jax_sim.grid.keys)``, its unpadded
    ``[:nb]`` rows of ``vel``/``p`` (and ``chi``/``udef`` when ``sim``
    has bodies), in its slot order, its time/step/dt/uinf and, with
    bodies, ``scalars["bodies"]`` =
    ``sim.data.obstacle_state_to_numpy(jax_sim)``.  The keys rebuild the
    octree; the fields must be in the order of those keys, which is the
    Hilbert order both packages use.  The bodies' own chi/udef/sdf are
    rebuilt by the next step's CreateObstacles."""
    grid = grid_from_keys(sim.grid, np.asarray(arrays["keys"]))
    bs = grid.bs
    names = FIELDS + (BODY_FIELDS if sim._with_bodies else ())
    want = {"vel": (grid.nb, bs, bs, bs, 3), "p": (grid.nb, bs, bs, bs),
            "chi": (grid.nb, bs, bs, bs), "udef": (grid.nb, bs, bs, bs, 3)}
    for name in names:
        a = np.asarray(arrays[name])
        if a.shape != want[name]:
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{want[name]}")
    sim.grid = grid
    sim._rebuild()
    for name in names:
        sim.state[name] = sim._pad(torch.tensor(
            np.asarray(arrays[name]), dtype=sim.dtype, device=sim.device))
    sim.time = float(scalars["time"])
    sim.step_idx = int(scalars["step"])
    sim.dt = float(scalars["dt"])
    sim.uinf = np.asarray(scalars["uinf"], dtype=np.float64).reshape(3)
    if scalars.get("bodies") is not None:
        load_obstacle_state_numpy(sim, scalars["bodies"])
    sim._umax_next = None
    sim._umax_dev = sim._time_dev = sim._uinf_dev = None
    sim._scores_prefetch = None


# -- the fleet's forest lanes (JAX sim/amr.make_amr_tgv_step) -----------------


def _amr_step_parts(sim: AMRSimulation):
    """What the obstacle-free forest step closes over: the bucket's
    padded geometry bundle (frozen: the fleet's forest lanes never
    regrid), the finest spacing of the dt chain, uinf and the pressure
    order."""
    if not sim._bucketing or sim.forest is not None:
        raise ValueError("the fleet's forest lanes run on the bucketed "
                         "single-device forest")
    return (sim._geo, sim.nu, float(np.min(sim.grid.h)), sim.uinf_device(),
            sim.cfg.step_2nd_start == 0)


def _amr_dt(umax, dtprev, cfl_eff, h_fine: float, nu: float):
    """The dt chain on the finest spacing (elementwise: a lane each)."""
    cap_dt = (h_fine * h_fine / 6.0) / (nu + (h_fine / 6.0) * umax)
    dt = torch.minimum(cfl_eff * h_fine / (umax + 1e-8), cap_dt)
    return torch.where(dtprev > 0, torch.minimum(dt, 1.03 * dtprev), dt)


def make_amr_tgv_step(sim: AMRSimulation):
    """The obstacle-free bucketed-forest step as ``one_step(carry,
    cfl_eff) -> (carry', row (TGV_ROW,))`` on a frozen padded topology
    (JAX ``make_amr_tgv_step``): carry ``vel`` (cap, 8, 8, 8, 3), ``p``
    (cap, 8, 8, 8) and the (umax, time, dt) chain; dt from the carried
    umax on the finest spacing, capped by the advection-diffusion bound
    and the 1.03x growth limiter; umax of the padded forest (padding
    rows are zero)."""
    geo, nu, h_fine, uinf, so = _amr_step_parts(sim)
    solver = sim._solver

    def one_step(carry, cfl_eff):
        vel, p = carry["vel"], carry["p"]
        dt = _amr_dt(carry["umax"], carry["dt"], cfl_eff, h_fine, nu)
        vel = amr_ops.rk3_step_blocks(geo.geom, vel, dt, nu, uinf, geo.tab3,
                                      geo.ftab)
        vel, p, stats = amr_ops.project_blocks(
            geo.geom, vel, dt, solver, geo.tab1, geo.ftab, p_init=p,
            second_order=so, with_stats=True)
        umax_new = torch.max(torch.abs(vel + uinf))
        time_new = carry["time"] + dt
        out = {"vel": vel, "p": p, "umax": umax_new, "time": time_new,
               "dt": dt}
        row = torch.cat([stats.to(vel.dtype), umax_new.reshape(1),
                         dt.reshape(1), time_new.reshape(1)])
        return out, row

    return one_step


def make_amr_tgv_lanes_step(sim: AMRSimulation):
    """:func:`make_amr_tgv_step` for L lanes at once on the same frozen
    topology: every carry leaf has a leading lane axis ((L, cap, ...) and
    (L,)), ``cfl_eff`` is (L,), the rows (L, TGV_ROW).  RK3, the pressure
    rhs and gradient run on every lane's blocks in one batched call
    (``torch.func.vmap`` over the lane axis); the Poisson solve is one
    lane-batched solve (ops/amr_ops ``lanes``: the fused kernels launch
    once for all lanes, each lane its own Krylov scalars).  ``live`` ((L,)
    bool, the fleet gate's ``left > 0``) marks the lanes whose step is
    kept: the others' solves do not iterate, so a finished or padding
    lane never holds the live lanes to its iteration count.  No operation
    reduces across lanes."""
    geo, nu, h_fine, uinf, so = _amr_step_parts(sim)
    core = sim._solver_core
    geom, tab1, tab3, ftab = geo.geom, geo.tab1, geo.tab3, geo.ftab
    bs = geom.bs
    vmap = torch.func.vmap

    def rk3(v, d):
        return amr_ops.rk3_step_blocks(geom, v, d, nu, uinf, tab3, ftab)

    def rhs_of(v, d):
        return amr_ops.pressure_rhs_blocks(geom, v, d, tab1, ftab)

    def lap(x):
        return amr_ops.laplacian_blocks(geom, x, tab1, ftab)

    def correct(v, p, d):
        gp = amr_ops.grad_blocks(geom, tab1.assemble_scalar(p, bs),
                                 tab1.width)
        return v - d * gp

    def one_step(carry, cfl_eff, live=None):
        vel, p = carry["vel"], carry["p"]
        L = vel.shape[0]
        dt = _amr_dt(carry["umax"], carry["dt"], cfl_eff, h_fine, nu)
        vel = vmap(rk3)(vel, dt)
        rhs = vmap(rhs_of)(vel, dt)
        ref = torch.sqrt(torch.sum((rhs * rhs).reshape(L, -1), dim=1,
                                   dtype=torch.float32))
        kw = dict(tab_arg=tab1, flux_arg=ftab, rnorm_ref=ref, geom=geom,
                  vol=geo.vol, pmask=geo.mask, graph=geo.graph,
                  slot0=geo.slot0, with_stats=True, lanes=True, live=live)
        if so:
            dp, stats = core(rhs - vmap(lap)(p), None, **kw)
            p = p + dp
        else:
            p, stats = core(rhs, p, **kw)
        vel = vmap(correct)(vel, p, dt)
        umax_new = torch.amax(torch.abs(vel + uinf).reshape(L, -1), dim=1)
        time_new = carry["time"] + dt
        out = {"vel": vel, "p": p, "umax": umax_new, "time": time_new,
               "dt": dt}
        rows = torch.cat([stats.to(vel.dtype), umax_new[:, None],
                          dt[:, None], time_new[:, None]], dim=1)
        return out, rows

    return one_step
