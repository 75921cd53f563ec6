"""PyTorch-aware AST lint of the port (port of ``cup3d_tpu/analysis/lint.py``).

The source half of the analysis layer (``analysis/runtime.py`` is the
runtime half).  The lint is precision-first: an AST cannot prove that an
expression holds a CUDA tensor, so a rule fires only on patterns that
are device-typed by construction (``torch.*`` calls, the drivers'
``self._name(...)`` step pieces, names assigned from them) or by the
port's conventions.  What it misses, the runtime guard
(``no_implicit_transfers``) catches on the card; what it flags wrongly,
an inline annotation documents::

    umax = float(self._umax_device())  # torch-lint: allow(JX001, why)

A ``with sanctioned_transfer("tag"):`` block is the annotation of the
designed syncs inside it, for the lint and the guard alike.  A finding
may also sit in the baseline (``analysis/baseline.json``), matched by
(rule, path, enclosing function).  The CLI (``python -m
cup3d_tpu_torch.analysis``) exits nonzero on any finding that is neither.

The rules are the JAX package's IDs with PyTorch heuristics (the
rationale of each is in ``analysis/rules.py``); the scopes point at
``cup3d_tpu_torch/``.  This module imports neither torch nor jax, so the
CLI starts in a fraction of a second.
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from cup3d_tpu_torch.analysis.rules import Violation

PKG = "cup3d_tpu_torch/"

# -- scoping ----------------------------------------------------------------

#: modules whose functions can be on the per-step critical path
HOT_MODULE_RE = re.compile(r"cup3d_tpu_torch/(sim|ops|stream|fleet|models|"
                           r"parallel)/")

#: function names that run inside (or are) the step loop
HOT_FUNC_RE = re.compile(
    r"^(advance\w*|simulate|solve\w*|calc_max_timestep|_calc_dt\w*|"
    r"_emit\w*|_consume\w*|emit|kick|poll|join|flush\w*|stage|iterate|"
    r"end_step|dispatch\w*|tick|_fix_mass_flux|_compute_forces|__call__|"
    r"\w*step\w*|\w*megastep\w*)$")

#: loop constructs whose body re-executes (JX004)
LOOP_NODES = (ast.For, ast.While, ast.ListComp, ast.SetComp,
              ast.DictComp, ast.GeneratorExp)

#: torch constructors that make a tensor on ``device=`` (JX004)
TORCH_CONSTRUCTORS = frozenset(
    {"tensor", "as_tensor", "zeros", "ones", "full", "empty", "arange",
     "linspace", "eye", "rand", "randn", "zeros_like", "ones_like",
     "full_like", "empty_like"})

#: builtins that read a tensor's value on the host (JX001)
SYNC_BUILTINS = frozenset({"float", "int", "bool"})

#: method calls that read a device tensor on the host or wait for the
#: device, whatever the receiver (JX001)
SYNC_METHODS = frozenset({"item", "cpu", "synchronize", "nonzero"})

#: torch functions that sync (JX001)
SYNC_FUNCS = frozenset({"torch.cuda.synchronize", "torch.nonzero"})

#: tensor attributes and methods that live on the host (reading them
#: never syncs), so int(x.shape[0]) etc. is not a JX001 hit
HOST_METADATA_ATTRS = frozenset(
    {"shape", "dtype", "device", "ndim", "numel", "size", "dim",
     "element_size", "nbytes", "itemsize", "is_cuda", "data_ptr",
     "stride", "storage_offset", "is_contiguous", "layout", "nb", "bs",
     "index"})

#: torch callables that do not produce a device value (JX001 taint)
TORCH_HOST = re.compile(r"^torch\.(device|dtype|finfo|iinfo|Size|"
                        r"get_num_threads|set_num_threads|is_tensor|"
                        r"cuda\.(is_available|device_count|"
                        r"get_device_name|current_device|"
                        r"get_sync_debug_mode|memory_\w+|"
                        r"max_memory_\w+|mem_get_info)|"
                        r"backends\.\S+|__version__)")

#: JX005 scope: device code
JX005_MODULE_RE = re.compile(r"cup3d_tpu_torch/(sim|ops|grid|stream|models|"
                             r"parallel|fleet)/")

#: JX010 scope and receivers: the obstacle pipeline's step modules, and
#: the names whose attributes are loop-carried obstacle/driver state
JX010_MODULE_RE = re.compile(r"cup3d_tpu_torch/(sim|ops|stream|models)/")
JX010_STATE_ROOTS = frozenset({"self", "s", "sim", "ob", "obstacle"})
JX010_STAGING = frozenset({"upload", "torch.as_tensor", "torch.tensor",
                           "np.asarray", "numpy.asarray"})

#: JX011 scope and the reductions it watches
JX011_MODULE_RE = re.compile(r"cup3d_tpu_torch/ops/")
JX011_REDUCTIONS = frozenset({"sum", "dot", "vdot", "matmul", "mm", "bmm",
                              "einsum", "tensordot", "inner"})
JX011_ACCUM_KWARGS = frozenset({"dtype"})

#: JX013/JX015/JX021 scope: the fleet, where the lane axis exists
FLEET_MODULE_RE = re.compile(r"cup3d_tpu_torch/fleet/")
JX013_AXIS_RE = re.compile(r"(^|_)(lanes?|scenarios?)(_|$|\d)",
                           re.IGNORECASE)
JX015_FUNC_RE = re.compile(r"(^|_)(ticks?|reseeds?|dispatch(es)?)",
                           re.IGNORECASE)
JX015_STACKERS = frozenset({"stack", "cat", "concatenate", "vstack",
                            "hstack"})
JX015_ASSEMBLY_HELPERS = frozenset({"stack_carries", "stack_gaits"})

#: JX014: datetime constructors whose reads are wall-clock
JX014_DATETIME_ATTRS = frozenset({"now", "utcnow", "today"})

#: JX016 scope: the sharded steady-state paths, minus builders
JX016_MODULE_RE = re.compile(r"cup3d_tpu_torch/(sim|fleet|parallel)/")
JX016_FUNC_RE = re.compile(r"step|advance|dispatch|megaloop",
                           re.IGNORECASE)
JX016_BUILDER_RE = re.compile(r"^(make_|build_|bind_|_build_)")

#: JX017 scope and the one exempt module
JX017_PATH_RE = re.compile(r"(^|/)bench[^/]*\.py$")
JX017_FUNC_RE = re.compile(r"roofline|peak", re.IGNORECASE)
JX017_EXEMPT_RE = re.compile(r"cup3d_tpu_torch/obs/costs\.py$")
JX017_MIN_MAGNITUDE = 1e9

#: JX018: parallel/ is the communication seam
JX018_EXEMPT_RE = re.compile(r"cup3d_tpu_torch/parallel/")

#: JX019: the build seams
JX019_EXEMPT_RE = re.compile(
    r"cup3d_tpu_torch/(aot/|ops/cuda_lib\.py$|native\.py$)")
JX019_COMPILERS = frozenset({"torch.compile", "torch.jit.script",
                             "torch.jit.trace", "jit.script", "jit.trace"})
JX019_TOOLS = ("nvcc", "g++", "gcc", "clang++")

#: JX020: obs/trace.py is the clock seam
JX020_EXEMPT_RE = re.compile(r"cup3d_tpu_torch/obs/trace\.py$")
JX020_CLOCK_ATTRS = ("time", "monotonic", "perf_counter", "time_ns",
                     "monotonic_ns", "perf_counter_ns")

#: JX021: the fleet job-state seams that journal their transitions
JX021_SANCTIONED_RE = re.compile(
    r"^(__init__|retire|reseed_lane|cancel|_prepare|"
    r"_install_replayed_job)$")

#: JX022: the TF32 switches
JX022_FLAGS = frozenset({"allow_tf32", "allow_bf16_reduced_precision_"
                         "reduction", "allow_fp16_reduced_precision_"
                         "reduction"})

# reason may hold one level of nested parens: allow(JX001, a (b) c)
ALLOW_RE = re.compile(
    r"torch-lint:\s*allow\(\s*(JX\d{3})\s*"
    r"(?:,\s*((?:[^()]|\([^()]*\))*?)\s*)?\)")


def _is_power_of_ten(v: float) -> bool:
    if v <= 0:
        return False
    e = round(math.log10(v))
    return abs(v - 10.0 ** e) <= 1e-6 * (10.0 ** e)


# -- suppressions -----------------------------------------------------------


def parse_suppressions(source: str) -> Dict[int, Dict[str, str]]:
    """line -> {rule: reason}.  An annotation on a comment line (or a
    block of them: a wrapped annotation continues across consecutive
    comment lines) applies to the next code line; on a code line, to that
    line."""
    out: Dict[int, Dict[str, str]] = {}
    lines = source.splitlines()
    i = 0
    while i < len(lines):
        text = lines[i]
        if text.lstrip().startswith("#"):
            start = i
            while i < len(lines) and lines[i].lstrip().startswith("#"):
                i += 1
            joined = " ".join(lines[j].lstrip().lstrip("#").strip()
                              for j in range(start, i))
            matches = ALLOW_RE.findall(joined)
            if matches:
                slot = out.setdefault(i + 1, {})
                for rule, reason in matches:
                    slot[rule] = (reason or "").strip()
            continue
        if "#" in text:
            matches = ALLOW_RE.findall(text)
            if matches:
                slot = out.setdefault(i + 1, {})
                for rule, reason in matches:
                    slot[rule] = (reason or "").strip()
        i += 1
    return out


# -- AST helpers ------------------------------------------------------------


def _dotted(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' otherwise)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(call: ast.Call) -> str:
    return _dotted(call.func)


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_torch_call(call: ast.Call) -> bool:
    name = _call_name(call)
    return name.startswith("torch.") and not TORCH_HOST.match(name)


def _is_stepwrapper_call(call: ast.Call) -> bool:
    """``self._name(...)`` / ``s._name(...)``: the drivers' convention for
    step pieces held as attributes."""
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr.startswith("_")
            and not f.attr.startswith("__")
            and isinstance(f.value, ast.Name))


def _is_device_call(call: ast.Call) -> bool:
    return _is_torch_call(call) or _is_stepwrapper_call(call)


def _is_host_metadata(expr: ast.AST) -> bool:
    """True when ``expr`` only reads host-side tensor metadata."""
    node = expr
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        if isinstance(node, ast.Call):
            node = node.func
            continue
        if isinstance(node, ast.Subscript):
            node = node.value
            continue
        if node.attr in HOST_METADATA_ATTRS:
            return True
        node = node.value
    return False


def _receiver_chain(node: ast.AST) -> List[str]:
    """Method names along a call chain ``a.b().c()`` below ``node``."""
    out = []
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            out.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            return out


def _walk_shallow(func: ast.AST):
    """Walk a function body without descending into nested def/class:
    each def gets its own visit, so a deep walk would count nested
    findings twice.  Lambdas stay in scope."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _assign_parts(stmt: ast.AST):
    if isinstance(stmt, ast.Assign):
        return stmt.targets, stmt.value
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return [stmt.target], stmt.value
    return [], None


def _plain_names(targets) -> List[str]:
    out = []
    stack = list(targets)
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, ast.Name):
            out.append(leaf.id)
        elif isinstance(leaf, (ast.Tuple, ast.List)):
            stack.extend(leaf.elts)
        elif isinstance(leaf, ast.Starred):
            stack.append(leaf.value)
    return out


# -- per-function device-taint tracking (JX001) -----------------------------


class _Taint:
    """Names assigned (in source order) from device-producing calls; a
    host read (``.cpu()``, ``.numpy()``, ``np.asarray``) launders."""

    LAUNDER = frozenset({"cpu", "numpy", "tolist", "item"})

    def __init__(self) -> None:
        self.names: Set[str] = set()

    def feed(self, stmt: ast.stmt) -> None:
        targets, value = _assign_parts(stmt)
        if value is None:
            return
        if self._launders(value):
            return
        if self.covers(value):
            self.names.update(_plain_names(targets))

    def _launders(self, value: ast.AST) -> bool:
        if isinstance(value, ast.Call):
            if set(_receiver_chain(value)) & self.LAUNDER:
                return True
            if _call_name(value) in ("np.asarray", "numpy.asarray",
                                     "np.array", "float", "int", "bool"):
                return True
        return False

    def covers(self, expr: ast.AST) -> bool:
        if any(isinstance(n, ast.Call) and _is_device_call(n)
               for n in ast.walk(expr)):
            return True
        return bool(self.names & _names_in(expr))


# -- the linter -------------------------------------------------------------


@dataclass
class FileLint:
    path: str            # repo-relative posix path
    tree: ast.Module
    suppressions: Dict[int, Dict[str, str]]
    violations: List[Violation] = field(default_factory=list)

    def run(self) -> List[Violation]:
        in_pkg = self.path.startswith(PKG)
        hot_module = bool(HOT_MODULE_RE.search(self.path))
        for func, qualname in self._functions():
            hot = hot_module and bool(HOT_FUNC_RE.match(func.name))
            if hot:
                self._check_host_sync(func, qualname)         # JX001
                self._check_loop_construction(func, qualname)  # JX004
            self._check_timing_windows(func, qualname)        # JX006
            if in_pkg:
                self._check_manual_timing(func, qualname)     # JX008
                self._check_swallowed_exceptions(func, qualname)  # JX009
                self._check_wallclock_duration(func, qualname)  # JX014
                self._check_profiler_usage(func, qualname)    # JX012
                self._check_collectives(func, qualname)       # JX018
                self._check_build_seam(func, qualname)        # JX019
                self._check_raw_clock(func, qualname)         # JX020
            if JX010_MODULE_RE.search(self.path) and HOT_FUNC_RE.match(
                    func.name):
                self._check_obstacle_staging(func, qualname)  # JX010
            if JX011_MODULE_RE.search(self.path):
                self._check_bf16_reduction(func, qualname)    # JX011
            if FLEET_MODULE_RE.search(self.path):
                self._check_lane_device_loop(func, qualname)  # JX013
                self._check_batch_reassembly(func, qualname)  # JX015
                self._check_status_mutation(func, qualname)   # JX021
            if JX016_MODULE_RE.search(self.path):
                self._check_sharded_materialization(func, qualname)  # JX016
            if not JX017_EXEMPT_RE.search(self.path) and (
                    JX017_PATH_RE.search(self.path)
                    or JX017_FUNC_RE.search(func.name)):
                self._check_hardware_peaks(func, qualname)    # JX017
        mod = "<module>"
        if in_pkg:
            self._check_swallowed_exceptions(self.tree, mod)  # JX009
            self._check_wallclock_duration(self.tree, mod)    # JX014
            self._check_profiler_usage(self.tree, mod)        # JX012
            self._check_collectives(self.tree, mod)           # JX018
            self._check_build_seam(self.tree, mod)            # JX019
            self._check_raw_clock(self.tree, mod)             # JX020
            self._check_tf32()                                # JX022
        if JX005_MODULE_RE.search(self.path):
            self._check_float64()                             # JX005
        if JX011_MODULE_RE.search(self.path):
            self._check_bf16_reduction(self.tree, mod)        # JX011
        if FLEET_MODULE_RE.search(self.path):
            self._check_lane_device_loop(self.tree, mod)      # JX013
            self._check_status_mutation(self.tree, mod)       # JX021
        if JX017_PATH_RE.search(self.path) and not JX017_EXEMPT_RE.search(
                self.path):
            self._check_hardware_peaks(self.tree, mod)        # JX017
        return self.violations

    # -- plumbing ----------------------------------------------------------

    def _shallow(self, func: ast.AST) -> List[ast.AST]:
        """:func:`_walk_shallow` of ``func``, walked once per file."""
        cache = self.__dict__.setdefault("_shallow_cache", {})
        nodes = cache.get(id(func))
        if nodes is None:
            nodes = cache[id(func)] = list(_walk_shallow(func))
        return nodes

    def _functions(self):
        """(FunctionDef, qualname) for every def, with class/def nesting."""
        cached = self.__dict__.get("_functions_cache")
        if cached is not None:
            return cached
        out = self._functions_cache = []

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    out.append((child, q))
                    visit(child, f"{q}.")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)

        visit(self.tree, "")
        return out

    def _emit(self, rule: str, node: ast.AST, func: str, msg: str,
              sanctioned: Optional[str] = None) -> None:
        v = Violation(rule=rule, path=self.path, line=node.lineno,
                      col=getattr(node, "col_offset", 0), func=func,
                      message=msg)
        reason = self.suppressions.get(node.lineno, {}).get(rule)
        if sanctioned is not None:
            v.suppressed = True
            v.suppression_reason = f"sanctioned_transfer({sanctioned!r})"
        elif reason is not None:
            v.suppressed = True
            v.suppression_reason = reason or None
        self.violations.append(v)

    def _sanction_lookup(self, func: ast.AST):
        """line -> tag for the lines of ``with sanctioned_transfer("tag")``
        blocks (and of ``device_scalar(..., tag=...)`` calls): the block
        is the designed-sync annotation for the lint and the guard."""
        spans: List[Tuple[int, int, str]] = []
        for node in self._shallow(func):
            if isinstance(node, ast.With):
                for item in node.items:
                    c = item.context_expr
                    if (isinstance(c, ast.Call) and _call_name(c)
                            .endswith("sanctioned_transfer")):
                        tag = ""
                        if c.args and isinstance(c.args[0], ast.Constant):
                            tag = str(c.args[0].value)
                        spans.append((node.lineno,
                                      node.end_lineno or node.lineno, tag))

        def lookup(line: int) -> Optional[str]:
            for lo, hi, tag in spans:
                if lo <= line <= hi:
                    return tag or "sanctioned"
            return None

        return lookup

    # -- JX001 -------------------------------------------------------------

    def _check_host_sync(self, func: ast.AST, qualname: str) -> None:
        taint = _Taint()
        for stmt in self._shallow(func):
            if isinstance(stmt, ast.stmt):
                taint.feed(stmt)
        lookup = self._sanction_lookup(func)
        for node in self._shallow(func):
            if isinstance(node, ast.Call):
                msg = self._host_sync(node, taint)
                if msg:
                    self._emit("JX001", node, qualname, msg,
                               sanctioned=lookup(node.lineno))

    def _host_sync(self, node: ast.Call, taint: _Taint) -> str:
        name = _call_name(node)
        f = node.func
        if name in SYNC_FUNCS:
            return f"{name}() waits for the device"
        if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
            if f.attr == "synchronize" and node.args:
                return ""
            if f.attr == "nonzero" and _dotted(f.value) in ("np", "numpy"):
                return ""
            return (f".{f.attr}() reads the device (the host waits for "
                    "every queued kernel)")
        if (isinstance(f, ast.Attribute) and f.attr == "tolist"
                and taint.covers(f.value)):
            return ".tolist() of a device value reads the device"
        if name in SYNC_BUILTINS and len(node.args) == 1:
            arg = node.args[0]
            if _is_host_metadata(arg):
                return ""
            if taint.covers(arg):
                return (f"{name}() of a device value reads it on the "
                        "host")
        return ""

    # -- JX004 -------------------------------------------------------------

    def _check_loop_construction(self, func: ast.AST, qualname: str) -> None:
        for loop in self._shallow(func):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                if (name.startswith("torch.")
                        and name.rsplit(".", 1)[-1] in TORCH_CONSTRUCTORS
                        and any(kw.arg == "device" for kw in node.keywords)):
                    self._emit(
                        "JX004", node, qualname,
                        f"{name}(..., device=) inside a per-step Python "
                        "loop builds a device tensor every iteration; "
                        "hoist or batch it")

    # -- JX005 -------------------------------------------------------------

    def _check_float64(self) -> None:
        """``torch.float64`` as the dtype of a tensor made with
        ``device=``, ``.double()``, or ``.to(torch.float64)``, unless the
        receiver was read to the host first (``.cpu()``)."""
        for func, qualname in [(self.tree, "<module>")] + self._functions():
            for node in self._shallow(func):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                kws = {kw.arg: kw.value for kw in node.keywords}
                f = node.func
                hit = ""
                if (name.startswith("torch.") and "device" in kws
                        and _dotted(kws.get("dtype", ast.Constant(0)))
                        == "torch.float64"):
                    hit = f"{name}(dtype=torch.float64, device=...)"
                elif isinstance(f, ast.Attribute) and f.attr in (
                        "double", "to"):
                    f64 = f.attr == "double" or any(
                        _dotted(a) == "torch.float64"
                        for a in list(node.args) + list(kws.values()))
                    chain = set(_receiver_chain(f.value))
                    if f64 and not chain & {"cpu", "numpy"}:
                        hit = f".{f.attr}() to float64"
                if hit:
                    self._emit("JX005", node, qualname,
                               f"{hit} in device code; take the dtype from "
                               "the config (sim.dtype), or read to the "
                               "host first")

    # -- JX006 -------------------------------------------------------------

    def _check_timing_windows(self, func: ast.AST, qualname: str) -> None:
        """Between consecutive perf_counter() reads (and from the
        function's start to the first) a window that launches work must
        hold a sync: torch.cuda.synchronize, an event or stream
        synchronize, or a host read."""
        pc_lines: List[int] = []
        sync_lines: List[int] = []
        call_lines: List[int] = []
        for node in self._shallow(func):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            line = node.lineno
            f = node.func
            if name.endswith("perf_counter"):
                pc_lines.append(line)
            elif (name in SYNC_BUILTINS or name in SYNC_FUNCS
                  or name in ("np.asarray", "numpy.asarray")
                  or (isinstance(f, ast.Attribute)
                      and f.attr in ("item", "cpu", "synchronize",
                                     "tolist", "values"))):
                sync_lines.append(line)
            else:
                call_lines.append(line)
        if len(pc_lines) < 2:
            return
        pc_lines.sort()
        start = func.lineno
        for pc in pc_lines:
            dispatches = any(start <= ln <= pc for ln in call_lines)
            synced = any(start <= ln <= pc for ln in sync_lines)
            if dispatches and not synced:
                v = Violation(
                    rule="JX006", path=self.path, line=pc, col=0,
                    func=qualname,
                    message=("perf_counter() read with launched work and "
                             "no device sync since line "
                             f"{start}: the window times the launches, "
                             "not the kernels"))
                reason = self.suppressions.get(pc, {}).get("JX006")
                if reason is not None:
                    v.suppressed = True
                    v.suppression_reason = reason or None
                self.violations.append(v)
            start = pc

    # -- JX008 -------------------------------------------------------------

    def _check_manual_timing(self, func: ast.AST, qualname: str) -> None:
        """``time.perf_counter()`` outside the obs layer: one finding a
        function (its first read), so one annotation covers a section."""
        if self.path.startswith(PKG + "obs/"):
            return
        first = None
        for node in self._shallow(func):
            if (isinstance(node, ast.Call)
                    and _call_name(node).endswith("perf_counter")):
                if first is None or node.lineno < first.lineno:
                    first = node
        if first is not None:
            self._emit("JX008", first, qualname,
                       "manual section timing outside cup3d_tpu_torch/obs/:"
                       " use obs spans or obs metrics")

    # -- JX009 -------------------------------------------------------------

    _LOG_ATTRS = frozenset({"warn", "warning", "error", "info", "debug",
                            "exception"})

    def _is_droppy_stmt(self, stmt: ast.stmt) -> bool:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            return True
        if isinstance(stmt, ast.Expr):
            v = stmt.value
            if isinstance(v, ast.Constant):
                return True
            if isinstance(v, ast.Call):
                name = _call_name(v)
                if name == "print" or name.endswith("warnings.warn"):
                    return True
                if (isinstance(v.func, ast.Attribute)
                        and v.func.attr in self._LOG_ATTRS):
                    return True
        return False

    def _check_swallowed_exceptions(self, func: ast.AST,
                                    qualname: str) -> None:
        if self.path.startswith(PKG + "resilience/"):
            return
        for node in self._shallow(func):
            if (isinstance(node, ast.ExceptHandler) and node.body
                    and all(self._is_droppy_stmt(s) for s in node.body)):
                self._emit("JX009", node, qualname,
                           "exception swallowed (pass/log-and-drop): "
                           "re-raise, latch it into state, or bump an obs "
                           "counter")

    # -- JX010 -------------------------------------------------------------

    def _check_obstacle_staging(self, func: ast.AST, qualname: str) -> None:
        lookup = self._sanction_lookup(func)
        for node in self._shallow(func):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = _call_name(node)
            if name not in JX010_STAGING:
                continue
            arg = node.args[0]
            if not isinstance(arg, ast.Attribute) or _is_host_metadata(arg):
                continue
            root = arg
            while isinstance(root, ast.Attribute):
                root = root.value
            if not (isinstance(root, ast.Name)
                    and root.id in JX010_STATE_ROOTS):
                continue
            self._emit("JX010", node, qualname,
                       f"{name}({_dotted(arg)}) moves loop-carried "
                       "obstacle/driver state across the host boundary "
                       "every step; cache it identity-keyed, derive it on "
                       "the device, or chain it there",
                       sanctioned=lookup(node.lineno))

    # -- JX011 -------------------------------------------------------------

    def _dtype_aliases(self) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                leaf = _dotted(node.value).rsplit(".", 1)[-1]
                if leaf in ("bfloat16", "float32", "float64"):
                    aliases[node.targets[0].id] = leaf
        return aliases

    def _dtype_leaf(self, node: ast.AST, aliases: Dict[str, str]) -> str:
        name = _dotted(node)
        if not name:
            return ""
        if "." not in name:
            return aliases.get(name, name)
        return name.rsplit(".", 1)[-1]

    def _cast_dtype(self, call: ast.Call, aliases: Dict[str, str]) -> str:
        """The dtype a call casts to: ``x.to(D)``, ``x.bfloat16()``,
        ``x.float()``, or a torch constructor's ``dtype=D``."""
        f = call.func
        if isinstance(f, ast.Attribute):
            if f.attr == "bfloat16":
                return "bfloat16"
            if f.attr == "float":
                return "float32"
            if f.attr == "to" and call.args:
                return self._dtype_leaf(call.args[0], aliases)
        if _call_name(call).startswith("torch."):
            for kw in call.keywords:
                if kw.arg == "dtype":
                    return self._dtype_leaf(kw.value, aliases)
        return ""

    def _check_bf16_reduction(self, func: ast.AST, qualname: str) -> None:
        """Reductions over bf16-tainted operands with no ``dtype=``
        accumulator.  Taint starts only at an explicit bfloat16 cast and
        propagates through assignments; an f32/f64 cast launders."""
        if not hasattr(self, "_jx011_aliases"):
            self._jx011_aliases = self._dtype_aliases()
        aliases = self._jx011_aliases

        def value_taint(value: ast.AST, tainted: Set[str]) -> bool:
            if (isinstance(value, ast.Call) and self._cast_dtype(
                    value, aliases) in ("float32", "float64")):
                return False
            for n in ast.walk(value):
                if (isinstance(n, ast.Call)
                        and self._cast_dtype(n, aliases) == "bfloat16"):
                    return True
            return bool(tainted & _names_in(value))

        tainted: Set[str] = set()
        for stmt in self._shallow(func):
            targets, value = _assign_parts(stmt)
            if value is None:
                continue
            hit = value_taint(value, tainted)
            for name in _plain_names(targets):
                (tainted.add if hit else tainted.discard)(name)

        for node in self._shallow(func):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            f = node.func
            leaf = name.rsplit(".", 1)[-1] if name else (
                f.attr if isinstance(f, ast.Attribute) else "")
            if leaf not in JX011_REDUCTIONS:
                continue
            if any(kw.arg in JX011_ACCUM_KWARGS for kw in node.keywords):
                continue
            operands = list(node.args)
            if isinstance(f, ast.Attribute) and not name.startswith(
                    "torch."):
                operands.append(f.value)  # a.sum(), a.dot(b)
            if any(value_taint(a, tainted) for a in operands):
                self._emit("JX011", node, qualname,
                           f"{leaf}() over bfloat16 operands reduces in "
                           "storage precision; name the f32 accumulator "
                           "(dtype=torch.float32) or up-cast first")

    # -- JX012 -------------------------------------------------------------

    def _check_profiler_usage(self, func: ast.AST, qualname: str) -> None:
        if self.path.startswith(PKG + "obs/"):
            return
        first = None
        for node in self._shallow(func):
            hit = False
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                hit = (mod == "torch.profiler"
                       or mod.startswith("torch.profiler.")
                       or (mod == "torch" and any(
                           a.name == "profiler" for a in node.names)))
            elif isinstance(node, ast.Import):
                hit = any(a.name.startswith("torch.profiler")
                          for a in node.names)
            elif isinstance(node, ast.Attribute):
                name = _dotted(node)
                hit = (name == "torch.profiler"
                       or name.startswith("torch.profiler."))
            if hit and (first is None or node.lineno < first.lineno):
                first = node
        if first is not None:
            self._emit("JX012", first, qualname,
                       "direct torch.profiler use outside "
                       "cup3d_tpu_torch/obs/: use obs.profile capture "
                       "windows so captures coordinate")

    # -- JX013 -------------------------------------------------------------

    def _check_lane_device_loop(self, func: ast.AST, qualname: str) -> None:
        for node in self._shallow(func):
            if not isinstance(node, LOOP_NODES) or isinstance(node,
                                                              ast.While):
                continue
            if isinstance(node, ast.For):
                axis_src = [node.target, node.iter]
            else:
                axis_src = [p for g in node.generators
                            for p in (g.target, g.iter)]
            names: Set[str] = set()
            for piece in axis_src:
                names |= _names_in(piece)
                names |= {a.attr for a in ast.walk(piece)
                          if isinstance(a, ast.Attribute)}
            if not any(JX013_AXIS_RE.search(n) for n in names):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and _is_device_call(sub):
                    self._emit("JX013", sub, qualname,
                               f"`{_call_name(sub)}()` launches device "
                               "work once a lane in a lane-axis loop; "
                               "batch over the lane axis instead")
                    break

    # -- JX014 -------------------------------------------------------------

    def _wallclock_call_names(self) -> Set[str]:
        cached = getattr(self, "_jx014_names", None)
        if cached is not None:
            return cached
        names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name
                    if a.name == "time":
                        names.add(f"{alias}.time")
                    elif a.name == "datetime":
                        for attr in JX014_DATETIME_ATTRS:
                            names.add(f"{alias}.datetime.{attr}")
                            names.add(f"{alias}.date.{attr}")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    for a in node.names:
                        if a.name == "time":
                            names.add(a.asname or a.name)
                elif node.module == "datetime":
                    for a in node.names:
                        if a.name in ("datetime", "date"):
                            alias = a.asname or a.name
                            for attr in JX014_DATETIME_ATTRS:
                                names.add(f"{alias}.{attr}")
        self._jx014_names = names
        return names

    def _check_wallclock_duration(self, func: ast.AST,
                                  qualname: str) -> None:
        wall = self._wallclock_call_names()
        if not wall:
            return

        def is_wall_call(node: ast.AST) -> bool:
            return isinstance(node, ast.Call) and _call_name(node) in wall

        tainted: Set[str] = set()
        stmts = [n for n in self._shallow(func)
                 if isinstance(n, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign))]
        for _ in range(3):
            grew = False
            for stmt in stmts:
                targets, value = _assign_parts(stmt)
                if value is None:
                    continue
                hit = any(is_wall_call(n) for n in ast.walk(value)) or any(
                    isinstance(n, (ast.Name, ast.Attribute))
                    and _dotted(n) in tainted for n in ast.walk(value))
                if not hit:
                    continue
                for t in targets:
                    for leaf in ast.walk(t):
                        name = _dotted(leaf)
                        if name and name not in tainted:
                            tainted.add(name)
                            grew = True
            if not grew:
                break

        def is_wallish(node: ast.AST) -> bool:
            return is_wall_call(node) or (
                isinstance(node, (ast.Name, ast.Attribute))
                and _dotted(node) in tainted)

        for node in self._shallow(func):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)):
                continue
            lw, rw = is_wallish(node.left), is_wallish(node.right)
            if not (lw or rw):
                continue
            other = node.right if lw else node.left
            if isinstance(other, ast.Constant):
                continue  # timestamp arithmetic, not a duration
            self._emit("JX014", node, qualname,
                       "wall-clock subtraction used as a duration: use "
                       "the monotonic clock (obs.trace.now())")

    # -- JX015 -------------------------------------------------------------

    def _check_batch_reassembly(self, func: ast.AST, qualname: str) -> None:
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if not JX015_FUNC_RE.search(func.name):
            return
        for node in self._shallow(func):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            leaf = name.rsplit(".", 1)[-1]
            if leaf in JX015_ASSEMBLY_HELPERS:
                pass
            elif leaf in JX015_STACKERS:
                root = name.split(".", 1)[0].lstrip("_")
                if "." not in name or root not in ("torch", "np", "numpy"):
                    continue
            else:
                continue
            self._emit("JX015", node, qualname,
                       f"`{name}()` reassembles the full lane-stacked batch "
                       "inside a per-tick path; replace one lane in place "
                       "(fleet/batch.py reseed_lane_carry)")

    # -- JX016 -------------------------------------------------------------

    def _check_sharded_materialization(self, func: ast.AST,
                                       qualname: str) -> None:
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if not JX016_FUNC_RE.search(func.name) or JX016_BUILDER_RE.match(
                func.name):
            return
        lookup = self._sanction_lookup(func)
        for node in self._shallow(func):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            f = node.func
            what = ""
            if isinstance(f, ast.Attribute) and f.attr == "cpu":
                what = "pulls the whole tensor to the host"
            elif (name in ("np.asarray", "np.array", "numpy.asarray",
                           "numpy.array") and node.args
                  and isinstance(node.args[0], ast.Call)
                  and _is_device_call(node.args[0])):
                what = "materializes a device value host-side"
            if what:
                self._emit("JX016", node, qualname,
                           f"`{name or f.attr}()` {what} inside a sharded "
                           "step path; stage the read through a designed "
                           "sync point (sanctioned_transfer)",
                           sanctioned=lookup(node.lineno))

    # -- JX017 -------------------------------------------------------------

    def _check_hardware_peaks(self, func: ast.AST, qualname: str) -> None:
        for node in self._shallow(func):
            if not isinstance(node, ast.Constant):
                continue
            v = node.value
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if float(v) < JX017_MIN_MAGNITUDE or _is_power_of_ten(float(v)):
                continue
            self._emit("JX017", node, qualname,
                       f"numeric literal {v!r} in a roofline/bench path "
                       "looks like a hand-typed hardware peak; resolve "
                       "the card through obs.costs.device_peaks()")

    # -- JX018 -------------------------------------------------------------

    def _dist_aliases(self) -> Set[str]:
        """Names this file binds to ``torch.distributed``."""
        cached = getattr(self, "_jx018_names", None)
        if cached is not None:
            return cached
        names = {"torch.distributed"}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch.distributed" and a.asname:
                        names.add(a.asname)
            elif (isinstance(node, ast.ImportFrom) and node.module == "torch"
                  and node.level == 0):
                for a in node.names:
                    if a.name == "distributed":
                        names.add(a.asname or a.name)
        self._jx018_names = names
        return names

    def _check_collectives(self, func: ast.AST, qualname: str) -> None:
        if JX018_EXEMPT_RE.search(self.path):
            return
        aliases = self._dist_aliases()
        for node in self._shallow(func):
            hit = ""
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod.startswith("torch.distributed") or (
                        mod == "torch" and any(a.name == "distributed"
                                               for a in node.names)):
                    hit = f"from {mod} import"
            elif isinstance(node, ast.Import):
                if any(a.name.startswith("torch.distributed")
                       for a in node.names):
                    hit = "import torch.distributed"
            elif isinstance(node, ast.Call):
                name = _call_name(node)
                if name.rsplit(".", 1)[0] in aliases:
                    hit = f"{name}()"
            if hit:
                self._emit("JX018", node, qualname,
                           f"`{hit}` outside cup3d_tpu_torch/parallel/: "
                           "route communication through the parallel/ "
                           "layer")

    # -- JX019 -------------------------------------------------------------

    def _check_build_seam(self, func: ast.AST, qualname: str) -> None:
        if JX019_EXEMPT_RE.search(self.path):
            return
        for node in self._shallow(func):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            hit = ""
            if name in JX019_COMPILERS:
                hit = f"{name}()"
            elif "cpp_extension" in name and name.rsplit(
                    ".", 1)[-1].startswith("load"):
                hit = f"{name}()"
            elif name.startswith("subprocess.") and node.args:
                first = node.args[0]
                elts = (first.elts if isinstance(first, (ast.List,
                                                         ast.Tuple))
                        else [first])
                if any(isinstance(e, ast.Constant) and isinstance(
                        e.value, str) and os.path.basename(e.value)
                        in JX019_TOOLS for e in elts[:1]):
                    hit = f"a {elts[0].value} subprocess"
            if hit:
                self._emit("JX019", node, qualname,
                           f"{hit} outside the build seams (ops/cuda_lib.py,"
                           " native.py, aot/): the compiled store and the "
                           "build counters never see it")

    # -- JX020 -------------------------------------------------------------

    def _raw_clock_names(self) -> Set[str]:
        cached = getattr(self, "_jx020_names", None)
        if cached is not None:
            return cached
        names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        alias = a.asname or a.name
                        for attr in JX020_CLOCK_ATTRS:
                            names.add(f"{alias}.{attr}")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in JX020_CLOCK_ATTRS:
                        names.add(a.asname or a.name)
        self._jx020_names = names
        return names

    def _check_raw_clock(self, func: ast.AST, qualname: str) -> None:
        if JX020_EXEMPT_RE.search(self.path):
            return
        clocks = self._raw_clock_names()
        if not clocks:
            return
        first = None
        for node in self._shallow(func):
            if isinstance(node, ast.Call) and _call_name(node) in clocks:
                if first is None or node.lineno < first.lineno:
                    first = node
        if first is not None:
            self._emit("JX020", first, qualname,
                       f"raw clock read `{_call_name(first)}()` outside "
                       "cup3d_tpu_torch/obs/trace.py: use obs.trace.now() "
                       "or obs.trace.wall()")

    # -- JX021 -------------------------------------------------------------

    def _check_status_mutation(self, func: ast.AST, qualname: str) -> None:
        if JX021_SANCTIONED_RE.match(qualname.rsplit(".", 1)[-1]):
            return
        for node in self._shallow(func):
            targets, _ = _assign_parts(node)
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr == "status":
                    self._emit("JX021", node, qualname,
                               "fleet job status mutated outside the "
                               "journal-logging seams: route it through "
                               "_job_terminal/mark or a seam that "
                               "journals")

    # -- JX022 -------------------------------------------------------------

    def _check_tf32(self) -> None:
        """TF32 enabled anywhere: a TF32 switch assigned True, a
        ``fp32_precision`` set to "tf32", or a float32 matmul precision
        other than "highest"."""
        def owner(node) -> str:
            best, span = "<module>", None
            for f, q in self._functions():
                lo, hi = f.lineno, f.end_lineno or f.lineno
                if lo <= node.lineno <= hi and (span is None
                                                or hi - lo < span):
                    best, span = q, hi - lo
            return best

        for node in ast.walk(self.tree):
            hit = ""
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets, value = _assign_parts(node)
                for t in targets:
                    leaf = _dotted(t).rsplit(".", 1)[-1]
                    if (leaf in JX022_FLAGS and isinstance(value,
                                                           ast.Constant)
                            and value.value is True):
                        hit = f"{_dotted(t)} = True"
                    elif (leaf == "fp32_precision"
                          and isinstance(value, ast.Constant)
                          and value.value == "tf32"):
                        hit = f"{_dotted(t)} = 'tf32'"
            elif isinstance(node, ast.Call) and _call_name(node).endswith(
                    "set_float32_matmul_precision"):
                arg = node.args[0] if node.args else None
                if isinstance(arg, ast.Constant) and arg.value in (
                        "high", "medium"):
                    hit = f"set_float32_matmul_precision({arg.value!r})"
            if hit:
                self._emit("JX022", node, owner(node),
                           f"{hit} turns f32 matmuls into TF32; ground "
                           "rule 4 keeps them true f32")


# -- baseline ---------------------------------------------------------------


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: Optional[str]) -> Dict[Tuple[str, str, str], dict]:
    if path is None or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    out = {}
    for e in data.get("entries", []):
        out[(e["rule"], e["path"], e["func"])] = {
            "reason": e.get("reason", ""),
            "count": int(e.get("count", 1)), "used": 0}
    return out


def apply_baseline(violations: List[Violation],
                   baseline: Dict[Tuple[str, str, str], dict]) -> None:
    """Mark violations the baseline covers (up to each entry's count: a
    new violation in a baselined function still fails)."""
    for v in violations:
        if v.suppressed:
            continue
        entry = baseline.get(v.key())
        if entry is not None and entry["used"] < entry["count"]:
            entry["used"] += 1
            v.baselined = True


def write_baseline(violations: List[Violation], path: str) -> None:
    counts: Dict[Tuple[str, str, str], int] = {}
    for v in violations:
        if not v.suppressed:
            counts[v.key()] = counts.get(v.key(), 0) + 1
    entries = [{"rule": r, "path": p, "func": f, "count": c,
                "reason": "TODO: justify or fix"}
               for (r, p, f), c in sorted(counts.items())]
    with open(path, "w") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=2)
        fh.write("\n")


# -- entry points -----------------------------------------------------------


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in (
                    "__pycache__", "build"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def repo_relative(path: str) -> str:
    """A posix path rooted at the repo (the directory that holds the
    ``cup3d_tpu_torch`` package), so baseline entries do not depend on
    the directory the CLI runs from."""
    ap = os.path.abspath(path).replace(os.sep, "/")
    idx = ap.rfind("/" + PKG)
    if idx >= 0:
        return ap[idx + 1:]
    return os.path.basename(ap)


def lint_source(source: str, path: str = "<string>") -> List[Violation]:
    """Lint one source string (the fixture tests use this)."""
    return FileLint(path, ast.parse(source),
                    parse_suppressions(source)).run()


def lint_paths(paths: Sequence[str], baseline_path: Optional[str] = None,
               rules: Optional[Set[str]] = None) -> List[Violation]:
    violations: List[Violation] = []
    for fpath in _iter_py_files(paths):
        with open(fpath, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            violations.append(Violation(
                rule="JX000", path=repo_relative(fpath),
                line=e.lineno or 0, col=e.offset or 0, func="<module>",
                message=f"syntax error: {e.msg}"))
            continue
        violations.extend(FileLint(repo_relative(fpath), tree,
                                   parse_suppressions(source)).run())
    if rules:
        violations = [v for v in violations if v.rule in rules]
    apply_baseline(violations, load_baseline(baseline_path))
    return violations


def failing(violations: Iterable[Violation]) -> List[Violation]:
    return [v for v in violations if not v.suppressed and not v.baselined]

