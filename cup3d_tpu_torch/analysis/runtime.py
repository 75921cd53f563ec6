"""Runtime sanitizers of the port (port of ``cup3d_tpu/analysis/runtime.py``).

The lint (``analysis/lint.py``) reads the source; these context managers
check the same invariants while the program runs:

- :func:`no_implicit_transfers` runs its body under CUDA's sync debug
  mode set to ``"error"``: an operation that makes the host wait for the
  device raises where it is called, unless it runs inside a
  :func:`sanctioned_transfer` block.  Those blocks name the designed
  host<->device transfers (``dt-upload``, ``qoi-read``,
  ``krylov-chunk-read``, ...) and count them in :data:`TRANSFER_SITES`
  and the registry's ``transfers.sanctioned{site=tag}``; :data:`ALLOWLIST`
  is the table of every tag, its cadence, and the JAX package's site or
  why it has none.
- :class:`RecompileCounter` counts the port's builds over its context.
  Eager PyTorch compiles nothing; what the port builds is its nvcc
  libraries, the forest's tables and the fleet's lane-batched advances,
  each counted in the registry already.  A steady step builds nothing.
- :func:`debug_nans` raises ``FloatingPointError`` at the first aten op
  (or hand-written kernel) whose floating output is not finite.

What CUDA's sync debug mode catches (checked on an NVIDIA H100 80GB HBM3
with torch 2.11, ``runs/``-style probe of chip_smoke.py's sanitizer
phase): ``.item()``, ``float/int/bool(tensor)``, ``.cpu()``,
``.tolist()``, a blocking device->host copy, any upload from pageable
host memory (``torch.tensor(x, device=cuda)``, ``torch.as_tensor(array,
device=cuda)``, ``t.to(cuda)`` of an unpinned tensor) and a blocking one
from pinned memory, ``nonzero``, boolean-mask indexing, ``unique``, and
``torch.cuda.current_stream().synchronize()``.  What it misses:
``torch.cuda.synchronize()``, ``Event.synchronize()``, non-blocking
copies to and from pinned memory (:func:`upload`, the QoI stream's
group copy), ``torch.full/zeros/arange(..., device=cuda)`` (a
fill kernel, no copy), and every kernel launched through ctypes
(``ops/cuda_lib.py``).  So a sanctioned site that does not wait
(``Site.waits`` False: the uploads and the stream's copies) is counted
and leaves the mode at ``"error"``: a blocking copy put in its place
raises.  Only the reads open the mode.  A wait the mode misses (an
event or device synchronize) is held to by the lint (JX001) instead.

Threads.  JAX's transfer guard is per thread; CUDA's sync debug mode is
one setting of the process (checked on the card: a second thread's
``.item()`` raises while the first holds the mode).  So while a guard is
on, only the thread that opened it may touch CUDA: the fleet's dispatch
loop and the drivers' step loops run on that thread.  The threads that
may run beside it make no CUDA call: the metrics exporter
(obs/export.py, host counters and ``torch.cuda.memory_stats``, which
does not synchronize), the compile service's worker (aot/compiler.py:
host tables, its CUDA builds in a helper process), the dump and
checkpoint writers (host arrays already read).  A sanctioned read
opens the mode for the whole process for its duration; the allowlist
is per thread, as in JAX.

On the CPU torch has no sync debug mode (``torch.cuda.set_sync_debug_mode``
raises in a CPU build); there :func:`no_implicit_transfers` keeps the
allowlist and the counters only, and catches no sync.  ``device="cuda"``
on a machine with no CUDA raises instead of passing silently.

Typical use (tests/test_torch_sanitizers.py, chip_smoke.py)::

    d = Simulation(cfg); d.init(); d.advance(d.calc_max_timestep())
    with RecompileCounter() as rc:
        with no_implicit_transfers(allow=ALLOWLIST):
            d.advance(d.calc_max_timestep())
    rc.assert_steady_state(budget=0)
"""

from __future__ import annotations

import threading
import warnings
from contextlib import contextmanager
from typing import Dict, Iterable, NamedTuple, Optional, Set

import numpy as np
import torch

from cup3d_tpu_torch.obs import metrics as M


class Site(NamedTuple):
    """One sanctioned tag: how often it fires, the JAX package's site of
    the same transfer (None: a port-only site, ``why`` says why the JAX
    package has none), and whether the transfer makes the host wait.  A
    site that does not wait (a pinned non-blocking copy, a fill kernel)
    is counted and stays under the guard: a blocking copy put in its
    place raises."""

    cadence: str
    jax: Optional[str]
    why: str = ""
    waits: bool = True


#: every sanctioned transfer tag of the port.  The first eight are the
#: JAX package's (fired at the counterparts of its sites); the rest are
#: the port's own, each with the reason the JAX package has no such site.
ALLOWLIST: Dict[str, Site] = {
    "dt-upload": Site(
        "once a per-step step (host dt chain)",
        "cup3d_tpu/sim/simulation.py:446, sim/amr.py:1985",
        waits=False),
    "umax-read": Site(
        "the first step of a driver; every step of a host-dt pipelined "
        "run until its stream's first group is read",
        "cup3d_tpu/sim/simulation.py:282, sim/amr.py:1790"),
    "qoi-read": Site(
        "once a non-pipelined step (its QoI pack); once a pack a "
        "stream flush",
        "cup3d_tpu/sim/simulation.py:580, sim/amr.py:2314, :2384"),
    "uinf-upload": Site(
        "when the frame velocity is reassigned (a fish with "
        "bFixFrameOfRef: every step)",
        "cup3d_tpu/sim/data.py:167, sim/amr.py:357",
        waits=False),
    "scalar-upload": Site(
        "once a value (DLM, lambda, the body masks)",
        "cup3d_tpu/sim/data.py:140, :146, models/base.py:319, :330, "
        "sim/amr.py:370, :376, :1742",
        waits=False),
    "moments-read": Site(
        "once a forest step with bodies (the rigid moments)",
        "cup3d_tpu/sim/amr.py:2028, :2036"),
    "scan-carry-upload": Site(
        "once a megaloop dispatch (its CFL ramp); the carry at each "
        "entry into the megaloop",
        "cup3d_tpu/sim/simulation.py:496, :513",
        waits=False),
    "resilience-snapshot": Site(
        "once a recovery snapshot on a device dt chain",
        "cup3d_tpu/resilience/recovery.py:243"),
    "krylov-chunk-read": Site(
        "once an ITER_CHUNK (4) Krylov iterations",
        None,
        "the JAX loop is a lax.while_loop on the device "
        "(cup3d_tpu/ops/krylov.py:834); the port's eager loop reads its "
        "predicate on the host once a chunk (ops/krylov.py::iterate)"),
    "mirror-upload": Site(
        "a few a body step (rigid state, kinematics, centres of mass, "
        "positions), a few a forest set-up or regrid",
        None,
        "the JAX package uploads the same host mirrors as implicit "
        "jnp.asarray calls with no tag (its fish step is not clean "
        "under its own guard: cup3d_tpu/models/fish/stefanfish.py:167); "
        "the port uploads them through pinned non-blocking copies "
        "(upload), which do not wait",
        waits=False),
    "table-upload": Site(
        "once a built operator's constants on a device (the fused "
        "uniform solve builds its coarse tables each solve)",
        None,
        "the JAX package bakes these constants into its jitted "
        "executables; the port uploads them through pinned memory "
        "(ops/krylov.py::DeviceConsts)",
        waits=False),
    "stream-copy": Site(
        "once a QoI stream group (every read_every emissions, or "
        "earlier under backpressure) and once a staged forest score read",
        None,
        "the JAX stream starts the same copy with copy_to_host_async, an "
        "explicit transfer its guard admits without a tag; the port's "
        "is a non-blocking copy into pinned memory behind an event",
        waits=False),
    "regrid-read": Site(
        "once a forest adaptation check (the first 10 steps, then every "
        "ADAPT_EVERY) that has no staged prefetch",
        None,
        "the JAX forest reads its tags with np.asarray in its adaptation "
        "path, untagged"),
    "flux-read": Site(
        "once a host-path step with FixMassFlux (the flux.txt row)",
        None,
        "the JAX package makes the same read with float() under a lint "
        "annotation (cup3d_tpu/sim/operators.py:124, sim/amr.py:2419), "
        "not a sanctioned block"),
    "diagnostics-read": Site(
        "once every freqDiagnostics steps (div.txt, energy.txt)",
        None,
        "the JAX package reads them with float() under lint annotations "
        "(cup3d_tpu/sim/operators.py:192-216), not a sanctioned block"),
    "body-read": Site(
        "once a step with several bodies on the uniform grid (moments, "
        "forces) and once a pair in contact (the collision pass)",
        None,
        "the JAX package's multi-body host path reads with np.asarray, "
        "untagged"),
    "fleet-read": Site(
        "once a journaled lane snapshot (snap_every), a flushed pack or "
        "a lane_state call",
        None,
        "the JAX fleet reads with np.asarray outside any sanctioned "
        "block; it never runs under its guard"),
}

#: the port-only tags (no JAX site)
PORT_ONLY = frozenset(t for t, s in ALLOWLIST.items() if s.jax is None)

#: the registry counters that count the port's builds
BUILD_COUNTERS = ("kernels.nvcc_builds", "bucket.table_builds",
                  "forest.table_builds", "fleet.executable_builds")

#: tag -> fire count of every sanctioned site since the process started
TRANSFER_SITES: Dict[str, int] = {}

_local = threading.local()
#: CUDA guards open in the process (the sync debug mode is process-wide)
_cuda_guards = [0]
#: debug_nans contexts open in the process (the launch wrappers' check)
NAN_CHECKS = [0]


def _allowed_tags() -> Optional[Set[str]]:
    """None: no restriction (every sanctioned site may open the guard)."""
    return getattr(_local, "allowed_tags", None)


def _set_mode(mode) -> None:
    with warnings.catch_warnings():
        # "a prototype feature" at every set: known, and said above
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode(mode)


def _guard_device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no_implicit_transfers(device='cuda'): this "
                           "machine has no CUDA device")
    return dev


@contextmanager
def no_implicit_transfers(allow: Optional[Iterable[str]] = None,
                          device=None):
    """Run the body with CUDA's sync debug mode at ``"error"``: a host
    sync outside a :func:`sanctioned_transfer` block raises at the call
    that made it (the module docstring lists what the mode catches).
    ``allow`` restricts which sanctioned tags may fire while it is active
    (None: any); an unknown tag raises at its site.  ``device`` None
    guards the card when there is one; on a CPU device the context keeps
    only the allowlist and the counters.  Contexts nest: each restores
    the mode it found."""
    dev = _guard_device(device)
    prev_allow = _allowed_tags()
    _local.allowed_tags = set(allow) if allow is not None else None
    cuda = dev.type == "cuda"
    if cuda:
        prev_mode = torch.cuda.get_sync_debug_mode()
        _set_mode("error")
        _cuda_guards[0] += 1
    try:
        yield
    finally:
        if cuda:
            _cuda_guards[0] -= 1
            _set_mode(prev_mode)
        _local.allowed_tags = prev_allow


@contextmanager
def _opened():
    """The sync debug mode back at ``"default"`` for the body when a
    guard is on (restored after), else nothing."""
    if not _cuda_guards[0]:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    _set_mode("default")
    try:
        yield
    finally:
        _set_mode(prev)


@contextmanager
def sanctioned_transfer(tag: str):
    """Mark a designed transfer: count it under ``tag``, and let it sync
    if its site waits (:data:`ALLOWLIST`; a tag not listed there counts
    as one that waits).  Outside a guard this costs one thread-local read
    and a counter bump; under one, a waiting site also sets the sync
    debug mode back to ``"default"`` for the body and restores the mode
    it found (blocks nest).  A site that does not wait leaves the mode
    as it is."""
    allowed = _allowed_tags()
    if allowed is not None and tag not in allowed:
        raise RuntimeError(
            f"transfer site {tag!r} is not in the active allowlist "
            f"{sorted(allowed)}; either the hot loop grew a new sync "
            "point (fix it) or the allowlist in the caller is stale")
    TRANSFER_SITES[tag] = TRANSFER_SITES.get(tag, 0) + 1
    M.counter("transfers.sanctioned", site=tag).inc()
    site = ALLOWLIST.get(tag)
    if site is not None and not site.waits:
        yield
        return
    with _opened():
        yield


def upload(a, dtype: Optional[torch.dtype], device,
           tag: str = "mirror-upload") -> torch.Tensor:
    """Host array -> device tensor in ``dtype`` (None: the array's own)
    without a wait: the values are rounded on the host and staged in
    pinned memory, so the copy is queued behind the device's work (an
    upload from pageable memory waits for every queued kernel, and
    raises under :func:`no_implicit_transfers`).  Counted as the
    sanctioned transfer ``tag``, a site that does not wait."""
    dev = torch.device(device)
    with sanctioned_transfer(tag):
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if dev.type != "cuda":
            return t.to(dev)
        return t.contiguous().pin_memory().to(dev, non_blocking=True)


def device_scalar(value, dtype, device, tag: str = "scalar-upload"
                  ) -> torch.Tensor:
    """One host scalar as a 0-dim device tensor, through a sanctioned
    site.  ``torch.full`` writes it with a fill kernel (the value rides
    the launch), so the upload does not wait for the device as a copy
    from pageable memory (``torch.tensor(v, device=cuda)``) does."""
    with sanctioned_transfer(tag):
        return torch.full((), value, dtype=dtype, device=device)


class RecompileCounter:
    """The port's builds over the context, by registry counter
    (:data:`BUILD_COUNTERS`: the nvcc libraries, the forest's bucket and
    sharded tables, the fleet's lane-batched advances).  ``compiles``
    maps each counter to its increase since the context opened (read
    live inside it, frozen at exit); ``assert_steady_state`` holds every
    counter to ``budget``."""

    def __init__(self, names: Iterable[str] = BUILD_COUNTERS) -> None:
        self.names = tuple(names)
        self._start: Dict[str, float] = {}
        self._final: Optional[Dict[str, int]] = None

    def _now(self) -> Dict[str, int]:
        return {n: int(M.counter(n).value - self._start.get(n, 0))
                for n in self.names}

    def __enter__(self) -> "RecompileCounter":
        self._start = {n: M.counter(n).value for n in self.names}
        self._final = None
        return self

    def __exit__(self, *exc) -> None:
        self._final = self._now()

    @property
    def compiles(self) -> Dict[str, int]:
        return dict(self._final) if self._final is not None else self._now()

    @property
    def total_compiles(self) -> int:
        return sum(self.compiles.values())

    def assert_steady_state(self, budget: int = 1,
                            ignore: Iterable[str] = ()) -> None:
        """Every counter grew by at most ``budget`` (0 for a second step
        of a configuration already built)."""
        skip = set(ignore)
        bad = {n: c for n, c in self.compiles.items()
               if c > budget and n not in skip}
        if bad:
            raise AssertionError(
                f"steady-state build budget ({budget}) exceeded: {bad}")


#: aten ops whose outputs hold no values yet (their bytes are whatever
#: the allocator hands out)
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "empty_permuted", "resize_",
                  "set_")


def _non_finite(t) -> bool:
    if not isinstance(t, torch.Tensor) or t.numel() == 0:
        return False
    if not (t.is_floating_point() or t.is_complex()):
        return False
    from torch.utils._python_dispatch import _disable_current_modes

    # the check's own ops (isfinite runs through abs) stay unchecked
    with _disable_current_modes(), _opened():
        return not bool(torch.isfinite(t).all())


def check_kernel_outputs(name: str, *outs) -> None:
    """Under :func:`debug_nans`, the hand-written kernel ``name`` (B1-B14,
    ``cup3d_frenet``) checked like an aten op: its launch wrapper passes
    the tensors it wrote.  The dispatch mode cannot see a ctypes launch."""
    for t in outs:
        if _non_finite(t):
            raise FloatingPointError(
                f"debug_nans: non-finite output of kernel {name}")


def _nan_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _DebugNans(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__.split(".")[0] not in _UNINITIALISED:
                for t in tree_leaves(out):
                    if _non_finite(t):
                        raise FloatingPointError(
                            f"debug_nans: non-finite output of {func}")
            return out

    return _DebugNans()


@contextmanager
def debug_nans(enabled: bool = True):
    """Raise ``FloatingPointError`` at the first aten op whose floating
    output holds a NaN or an Inf, naming the op (a TorchDispatchMode on
    this thread), and at the first hand-written kernel whose output does
    (:func:`check_kernel_outputs`, from the launch wrappers).  Each check
    reads the device: opt-in, never on by default, never in a timed
    run."""
    if not enabled:
        yield
        return
    NAN_CHECKS[0] += 1
    try:
        with _nan_mode():
            yield
    finally:
        NAN_CHECKS[0] -= 1
