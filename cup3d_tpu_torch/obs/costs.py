"""Cost and memory accounting and the device peak table (port of the part
of ``cup3d_tpu/obs/costs.py`` that has a meaning in eager PyTorch).

1. **Device peaks.**  :func:`device_peaks` resolves the card's name
   (``torch.cuda.get_device_name``) against :data:`PEAK_TABLE`, the one
   home of the port's ceilings (chip_smoke.py and the kernel bounds read
   them here).  The table holds the H100 SXM: 3.35 TB/s HBM and 989
   TFLOP/s dense bf16 on the tensor cores, plus 67 TFLOP/s f32 outside
   them (the kernel table's bounds are f32).  The CPU and a card with no
   entry get that entry flagged ``nominal=True``: a reference, not a
   claim about the local machine.

2. **Cost rows.**  Eager PyTorch has no compiled executable to ask, so
   a row's cost half is ANALYTIC, not a compiler's: the bytes a call
   moves by the solver's traffic model (``bytes_model()`` of
   ``ops/fused_bicgstab.py`` and ``ops/fused_amr_bicgstab.py``: bytes a
   cell an iteration, times the cells and the iterations the call
   executed).  Its memory half is the caching allocator's peak around
   the call (``reset_peak_memory_stats``, then ``max_memory_allocated``)
   on a CUDA device.  The ``available`` flags say which halves a row
   got.  :func:`harvest_on_first_call` wraps a bound callable so its
   first call fills a row (the AMR driver's forest bind seam arms it
   under ``CUP3D_COSTS=1``); rows keep the JAX package's keys and land
   in the JAX package's gauges (``xla.flops{executable=}``,
   ``xla.bytes_accessed{executable=}``, ``xla.peak_bytes{executable=}``),
   so federation and ``/metrics`` read the same keys from both.

3. :func:`memory_watermarks` samples the allocator into
   ``hbm.peak_bytes{device=}`` and ``hbm.bytes_in_use{device=}``; on the
   CPU it returns ``{}`` and counts ``costs.unavailable``.

Nothing here runs per step: a row is filled at the first call of a
bound solve, the watermarks read host-side allocator counters.  Failures
are counted (``costs.unavailable{what=}``), never raised.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from cup3d_tpu_torch.obs import metrics as _metrics


@dataclass(frozen=True)
class DevicePeaks:
    """One card's advertised ceilings (the roofline denominators).

    ``nominal`` marks the reference entry handed to the CPU and to cards
    with no entry."""

    kind: str
    bf16_flops: float        # dense bf16 peak, FLOP/s a card
    hbm_bytes_per_s: float   # HBM bandwidth, B/s a card
    nominal: bool = False
    note: str = ""
    f32_flops: float = 0.0   # f32 FLOP/s outside the tensor cores

    def as_dict(self) -> dict:
        return {"kind": self.kind, "bf16_flops": self.bf16_flops,
                "hbm_bytes_per_s": self.hbm_bytes_per_s,
                "nominal": self.nominal, "note": self.note,
                "f32_flops": self.f32_flops}


#: published peaks (NVIDIA H100 SXM data sheet), keyed on a substring of
#: the card's name
PEAK_TABLE = (
    DevicePeaks("H100 80GB HBM3", 989e12, 3.35e12, f32_flops=67e12,
                note="H100 SXM: 989 TFLOP/s dense bf16, 67 TFLOP/s f32, "
                     "3.35 TB/s HBM3"),
)

#: the H100 entry as the reference for the CPU and unknown cards
NOMINAL_FALLBACK = DevicePeaks(
    "nominal-H100", PEAK_TABLE[0].bf16_flops, PEAK_TABLE[0].hbm_bytes_per_s,
    nominal=True, f32_flops=PEAK_TABLE[0].f32_flops,
    note="reference ceiling (H100 SXM numbers): the device has no entry "
         "in PEAK_TABLE, fractions are against this reference, not the "
         "local machine",
)


def peaks_for_kind(kind: str) -> DevicePeaks:
    """Resolve a card name against :data:`PEAK_TABLE` (case-insensitive
    substring); unknown kinds get :data:`NOMINAL_FALLBACK`."""
    norm = str(kind).strip().lower()
    for peaks in PEAK_TABLE:
        if peaks.kind.lower() in norm:
            return peaks
    return NOMINAL_FALLBACK


def device_peaks(device=None) -> DevicePeaks:
    """The card's peaks (``device`` a torch device or index, default the
    current CUDA device).  Never raises: no card, or a CPU device, is
    counted and gets the nominal entry."""
    try:
        import torch

        if device is not None and torch.device(device).type != "cuda":
            raise RuntimeError("not a CUDA device")
        return peaks_for_kind(torch.cuda.get_device_name(device))
    except Exception:
        _metrics.counter("costs.unavailable", what="device_kind").inc()
        return NOMINAL_FALLBACK


# -- cost rows ----------------------------------------------------------------

#: name -> row; a second harvest of a name overwrites (the newest wins)
_ROWS: Dict[str, dict] = {}

_ROW_KEYS = ("name", "flops", "bytes_accessed", "argument_bytes",
             "output_bytes", "temp_bytes", "alias_bytes",
             "generated_code_bytes", "peak_bytes", "available")


def _empty_row(name: str) -> dict:
    row = dict.fromkeys(_ROW_KEYS)
    row["name"] = str(name)
    row["available"] = {"cost": False, "memory": False}
    return row


def _tensor_bytes(obj) -> int:
    """Bytes of every tensor in a (nested) call argument or result."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


def _cuda_device(args, kwargs):
    import torch

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device if a.device.type == "cuda" else None
    return None


def _record_row(row: dict) -> dict:
    """Store a row and land its numbers in the JAX package's gauges."""
    name = row["name"]
    _ROWS[name] = row
    if row["flops"] is not None:
        _metrics.gauge("xla.flops", executable=name).set(row["flops"])
    if row["bytes_accessed"] is not None:
        _metrics.gauge("xla.bytes_accessed",
                       executable=name).set(row["bytes_accessed"])
    if row["peak_bytes"] is not None:
        _metrics.gauge("xla.peak_bytes",
                       executable=name).set(float(row["peak_bytes"]))
    _metrics.counter("costs.harvests").inc()
    return row


def harvest_call(name: str, fn, args=(), kwargs=None,
                 cost: Optional[Callable] = None):
    """Call ``fn(*args, **kwargs)`` once and fill its row; returns
    ``(row, result)``.  ``cost``: a zero-argument callable made before
    the call that, called again after it, returns ``(bytes, flops)`` of
    the call by an analytic model (either may be None) -- see
    :func:`model_cost`.  On a CUDA device the allocator's peak over the
    call is the memory half."""
    import torch

    kwargs = kwargs or {}
    row = _empty_row(name)
    stop_cost = cost() if cost is not None else None
    dev = _cuda_device(args, kwargs)
    before_bytes = None
    if dev is not None:
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            before_bytes = torch.cuda.memory_allocated(dev)
        except Exception:
            before_bytes = None
    out = fn(*args, **kwargs)
    if stop_cost is not None:
        nbytes, flops = stop_cost()
        row["bytes_accessed"] = None if nbytes is None else float(nbytes)
        row["flops"] = None if flops is None else float(flops)
        row["available"]["cost"] = nbytes is not None or flops is not None
    else:
        _metrics.counter("costs.unavailable", what="cost_model").inc()
    if before_bytes is not None:
        peak = torch.cuda.max_memory_allocated(dev)
        arg_b, out_b = _tensor_bytes((args, kwargs)), _tensor_bytes(out)
        row.update(argument_bytes=arg_b, output_bytes=out_b,
                   temp_bytes=max(0, peak - before_bytes), peak_bytes=peak)
        row["available"]["memory"] = True
    else:
        _metrics.counter("costs.unavailable", what="memory_stats").inc()
    return _record_row(row), out


def model_cost(*terms):
    """A ``cost`` for :func:`harvest_call` from ``(bytes_a_unit, units)``
    terms: the bytes are the sum of ``bytes_a_unit`` times the growth of
    the host counter ``units()`` over the call (a solver's executed
    iterations, with its bytes a cell an iteration times its cells)."""
    def start():
        u0 = [units() for _, units in terms]

        def stop():
            return sum(b * (units() - u) for (b, units), u
                       in zip(terms, u0)), None
        return stop
    return start


def rows() -> Dict[str, dict]:
    """Every row of this process, by name (copies)."""
    return {k: dict(v, available=dict(v["available"]))
            for k, v in _ROWS.items()}


def enabled() -> bool:
    """``CUP3D_COSTS=1`` arms the forest bind seam's harvest."""
    return os.environ.get("CUP3D_COSTS", "0") not in ("0", "")


def harvest_on_first_call(fn, name: str, cost: Optional[Callable] = None):
    """Wrap ``fn`` so its FIRST call also fills the row ``name``
    (:func:`harvest_call`); every later call is the plain call behind
    one bool test.  Attributes of ``fn`` (``supports_stats``,
    ``maxiter``, ...) are carried over."""
    state = {"done": False}

    def wrapper(*args, **kwargs):
        if state["done"]:
            return fn(*args, **kwargs)
        state["done"] = True
        return harvest_call(name, fn, args, kwargs, cost)[1]

    wrapper.__dict__.update(getattr(fn, "__dict__", {}))
    wrapper.__name__ = getattr(fn, "__name__", name)
    wrapper.__wrapped__ = fn
    return wrapper


# -- live allocator watermarks ----------------------------------------------


def memory_watermarks() -> Dict[str, dict]:
    """Sample the caching allocator of every visible card into
    ``hbm.peak_bytes{device=}`` / ``hbm.bytes_in_use{device=}`` gauges
    (``allocated_bytes.all.peak`` / ``.current``) with the card's total
    from ``mem_get_info``.  Returns {"cuda:<i>": stats}; ``{}`` on the
    CPU (counted, never raised)."""
    out: Dict[str, dict] = {}
    try:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception:
        n = 0
    if n == 0:
        _metrics.counter("costs.unavailable", what="devices").inc()
        return out
    for i in range(n):
        label = f"cuda:{i}"
        try:
            stats = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
        except Exception:
            _metrics.counter("costs.unavailable",
                             what="memory_stats").inc()
            continue
        peak = stats.get("allocated_bytes.all.peak")
        in_use = stats.get("allocated_bytes.all.current")
        sub = {"bytes_limit": int(total), "bytes_free": int(free)}
        if peak is not None:
            sub["peak_bytes_in_use"] = int(peak)
            _metrics.gauge("hbm.peak_bytes", device=label).set(float(peak))
        if in_use is not None:
            sub["bytes_in_use"] = int(in_use)
            _metrics.gauge("hbm.bytes_in_use",
                           device=label).set(float(in_use))
        out[label] = sub
    return out
