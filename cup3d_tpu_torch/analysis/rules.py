"""Rule catalog of the port's lint (``cup3d_tpu_torch.analysis.lint``).

The rule IDs are the JAX package's (``cup3d_tpu/analysis/rules.py``), so
each finding maps to its JAX rationale; each rule here says what the
hazard is in PyTorch.  A JAX rule with no PyTorch hazard stays in the
catalog marked not applicable, with the reason.  JX022 is the port's
own: TF32 enablement (ground rule 4).

Suppress one finding inline with ``# torch-lint: allow(JX00n, reason)``
or list it in ``analysis/baseline.json``, matched by (rule, path,
enclosing function).  Rule IDs are append-only: never renumber, never
reuse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    rationale: str
    #: why the rule has no PyTorch hazard ("" for a ported rule)
    not_applicable: str = ""

    @property
    def applies(self) -> bool:
        return not self.not_applicable


_JAXPR = ("the IR audit walks jaxprs and AOT-lowered XLA executables "
          "(cup3d_tpu/analysis/ir.py, audit.py); eager PyTorch has no "
          "traced program to audit")

RULES: Dict[str, Rule] = {
    r.id: r
    for r in (
        Rule(
            "JX001",
            "host sync in hot-path function",
            "`.item()`, `.tolist()`, `.cpu()`, `float/int/bool(tensor)`, "
            "`.nonzero()`, `torch.cuda.synchronize()` or a stream/event "
            "`.synchronize()` inside a step, solve or dispatch function "
            "makes the host wait for every kernel queued before it, so "
            "the launches of the next operator stop overlapping the "
            "device's work.  The port's designed reads (the end-of-step "
            "QoI read, the Krylov chunk predicate once every 4 "
            "iterations, ground rule 6) sit inside "
            "`sanctioned_transfer` blocks; anything else is a fault. "
            "`shape`, `dtype`, `device` and `numel()` are host metadata "
            "and never sync."),
        Rule(
            "JX002",
            "step-shaped jax.jit without donate_argnums",
            "A jitted step without donation copies its state buffers.",
            not_applicable="eager PyTorch has no jit and no donation: an "
            "operator allocates its output and the caller rebinds it; "
            "in-place updates are explicit (`copy_`, `add_`)"),
        Rule(
            "JX003",
            "Python control flow on traced values in a jitted body",
            "`if`/`while` on a traced value inside jit.",
            not_applicable="nothing is traced: a Python branch on a "
            "tensor is an eager `bool(tensor)` host read, which JX001 "
            "flags where the value is device-typed"),
        Rule(
            "JX004",
            "device tensor construction inside a per-step Python loop",
            "`torch.tensor/as_tensor/zeros/ones/full/arange/...(..., "
            "device=...)` inside a Python loop of a hot function launches "
            "an allocation and a fill (or, from host data, a copy that "
            "waits for the device) once an iteration, every step.  Build "
            "it once outside the loop, batch it, or keep it on the "
            "device."),
        Rule(
            "JX005",
            "float64 dtype in device code",
            "`torch.float64` as the dtype of a tensor made on a device, "
            "or `.double()` / `.to(torch.float64)` on a device tensor, "
            "runs at 1/60 of the H100's f32 FMA rate in plain CUDA cores "
            "and doubles the bytes; device dtypes come from the config "
            "(sim.dtype).  float64 is for host mirrors: a read "
            "(`.cpu()`) first, then the cast."),
        Rule(
            "JX006",
            "perf_counter timing window without a device sync",
            "Kernel launches return before the kernels run: a "
            "`time.perf_counter()` window around device work with no "
            "`torch.cuda.synchronize()`, event `synchronize()` or host "
            "read before its closing read times the launches, not the "
            "work.  Sync before the start and before the end, or time "
            "with CUDA events."),
        Rule(
            "JX007",
            "jax.jit construction inside an adaptation/step loop",
            "A fresh jit object per regrid recompiles every step.",
            not_applicable="eager PyTorch compiles nothing per call; the "
            "forest's per-topology builds are its tables, memoised "
            "(sim/amr.py bucket memo) and counted by "
            "`bucket.table_builds`, which RecompileCounter holds"),
        Rule(
            "JX008",
            "manual section timing outside the obs layer",
            "`time.perf_counter()` section timing outside "
            "cup3d_tpu_torch/obs/ is a private timing channel: the "
            "registry, the step trace and the flight recorder never see "
            "it.  Use obs spans (obs.trace.SpanTimer, the driver "
            "profiler) or obs metrics."),
        Rule(
            "JX009",
            "swallowed exception (drop without counter or re-raise)",
            "An `except: pass`/`continue` (or a log-and-drop handler) "
            "erases the only evidence of a failure.  Re-raise, return a "
            "sentinel the caller checks, record the error into state, or "
            "bump an obs counter.  cup3d_tpu_torch/resilience/ is exempt "
            "by path: containing counted failures is its job."),
        Rule(
            "JX010",
            "per-step host<->device staging of obstacle state",
            "`upload`/`torch.as_tensor`/`torch.tensor` of a loop-carried "
            "obstacle or driver attribute (self.X, ob.X, s.X) inside a "
            "step function, or `np.asarray` of one, moves the same "
            "mirror across the host boundary every step.  Cache static "
            "mirrors identity-keyed (models/base.forced_mask_dev), "
            "derive per-step values on the device, or chain the state "
            "on the device (pipelined stepping, sim/megaloop.py)."),
        Rule(
            "JX011",
            "bf16 reduction without an explicit f32 accumulator",
            "`torch.sum/dot/vdot/matmul/mm/bmm/einsum/tensordot` over a "
            "bfloat16 operand with no `dtype=` accumulator (or an f32 "
            "up-cast first) reduces in storage precision: a bf16 Krylov "
            "dot product loses the bits the stopping test needs.  The "
            "bf16 policy (ops/precision.py) stores bf16 and accumulates "
            "in f32."),
        Rule(
            "JX012",
            "direct torch.profiler use outside the obs layer",
            "`torch.profiler` opened outside cup3d_tpu_torch/obs/ is a "
            "second, uncoordinated capture: the profiler session is "
            "process-global, so it collides with the obs windows "
            "(CUP3D_PROFILE), and its trace never reaches the device-"
            "time attribution.  Use obs.profile capture windows."),
        Rule(
            "JX013",
            "per-lane Python loop over the fleet scenario axis",
            "A Python loop over the lane/scenario axis in "
            "cup3d_tpu_torch/fleet/ that launches device work each "
            "iteration pays the host's launch cost once a lane: the lanes "
            "exist to be advanced by one batched launch sequence "
            "(fleet/batch.py, torch.func.vmap).  Host-only loops over "
            "lanes are fine."),
        Rule(
            "JX014",
            "wall-clock subtraction used as a duration",
            "A duration from two `time.time()`/`datetime.now()` reads "
            "follows the wall clock, which NTP slews and steps: it can "
            "come out negative.  Durations come from the monotonic clock "
            "(obs.trace.now(), obs spans); `time.time()` stays for "
            "timestamps."),
        Rule(
            "JX015",
            "per-tick host reassembly of full-batch arrays in fleet/",
            "A tick/reseed/dispatch function in cup3d_tpu_torch/fleet/ "
            "that restacks the whole lane axis (`torch.stack/cat`, "
            "`np.stack/concatenate`, the stack_carries/stack_gaits "
            "helpers) pays O(lanes) work and a full-batch copy at every "
            "boundary; a reseed replaces one lane in place "
            "(fleet/batch.py reseed_lane_carry)."),
        Rule(
            "JX016",
            "full-array materialization in a sharded step path",
            "`.cpu()`, `.numpy()`, `np.asarray`/`np.array` of a tensor "
            "inside a step/advance/dispatch/megaloop function in "
            "cup3d_tpu_torch/{sim,fleet,parallel}/ pulls the whole array "
            "(every shard of a sharded forest) to the host.  Stage host "
            "reads through the designed sync points "
            "(sanctioned_transfer)."),
        Rule(
            "JX017",
            "hand-typed hardware peak literal in a roofline/bench path",
            "A numeric constant >= 1e9 that is not a power of ten in a "
            "bench*.py file or a roofline/peak function reads like a "
            "spec sheet and fixes one card's numbers into math that runs "
            "on every card.  Peaks live in obs/costs.py's table (the one "
            "exempt module); consumers call obs.costs.device_peaks()."),
        Rule(
            "JX018",
            "raw collective call site outside cup3d_tpu_torch/parallel/",
            "`torch.distributed` used outside cup3d_tpu_torch/parallel/ "
            "scatters the communication surface: process groups, ranks "
            "and the collectives belong to the one layer where the mesh "
            "lives (parallel/topology.py, collectives.py, ring.py)."),
        Rule(
            "JX019",
            "direct compile call site outside the build seams",
            "`torch.compile`, `torch.jit.script/trace`, "
            "`torch.utils.cpp_extension.load*` or an nvcc/g++ subprocess "
            "outside the build seams (ops/cuda_lib.py, native.py, aot/) "
            "builds something the compiled store never sees and the "
            "build counters (RecompileCounter) never count."),
        Rule(
            "JX020",
            "raw clock read outside obs/trace.py",
            "`time.monotonic()/time()/perf_counter()` (and the *_ns "
            "variants) anywhere but obs/trace.py starts a second clock "
            "domain: the fleet's latency phases sum to a job's end-to-"
            "end time only because every lifecycle stamp comes off "
            "obs.trace.now().  Monotonic reads go through "
            "obs.trace.now(), wall stamps through obs.trace.wall()."),
        Rule(
            "JX021",
            "fleet job status mutated outside the journal-logging seam",
            "A `<job>.status = ...` assignment in cup3d_tpu_torch/fleet/ "
            "outside the seams that journal their transitions "
            "(__init__, retire, reseed_lane, cancel, _prepare, "
            "_install_replayed_job) is a lifecycle edge the write-ahead "
            "journal never records: recover() cannot replay it."),
        Rule(
            "JX022",
            "TF32 enabled in the package",
            "`allow_tf32 = True` (cuda.matmul or cudnn), "
            "`torch.set_float32_matmul_precision('high'|'medium')` or an "
            "`fp32_precision = 'tf32'` setting turns f32 matmuls into "
            "TF32 (10 mantissa bits): the tile solve's dense "
            "preconditioner then stalls BiCGSTAB, as the JAX package's "
            "bf16-grade default did before it pinned HIGHEST precision "
            "(cup3d_tpu/ops/tilesolve.py:26-29).  Ground rule 4: "
            "matmuls stay true f32 (ops/precision.check_fp32_matmul)."),
        Rule("JP001", "donated buffer not aliased in the compiled "
             "executable", "", not_applicable=_JAXPR),
        Rule("JP002", "unsafe collective in a shard_map body", "",
             not_applicable=_JAXPR),
        Rule("JP003", "cross-shard materialization in a sharded step "
             "jaxpr", "", not_applicable=_JAXPR),
        Rule("JP004", "precision hazard visible in the jaxpr", "",
             not_applicable=_JAXPR + "; JX005, JX011 and JX022 read the "
             "source"),
        Rule("JP005", "host callback op in a hot jaxpr", "",
             not_applicable=_JAXPR),
    )
}

#: the rules the lint checks
PORTED = tuple(r.id for r in RULES.values() if r.applies)


@dataclass
class Violation:
    """One lint finding.  ``func`` is the enclosing function's qualname:
    the baseline matches on (rule, path, func), so entries survive line
    drift from unrelated edits."""

    rule: str
    path: str
    line: int
    col: int
    func: str
    message: str
    suppressed: bool = False
    suppression_reason: Optional[str] = None
    baselined: bool = False

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.func)

    def format(self) -> str:
        tag = ""
        if self.suppressed:
            tag = f"  [allowed: {self.suppression_reason or 'no reason'}]"
        elif self.baselined:
            tag = "  [baselined]"
        rule = RULES.get(self.rule)
        title = rule.title if rule else "unknown rule"
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"({title}) in `{self.func}`: {self.message}{tag}")
