"""Configuration: the reference's flag surface as a typed dataclass.

A copy of ``cup3d_tpu/config.py`` (the port imports nothing from the JAX
package); both packages parse the same argv into equal configs.

Mirrors the ~45 flags parsed by the reference's ``SimulationData`` ctor
(main.cpp:15330-15387) and ``ArgumentParser`` precedence rules
(main.cpp:10120-10299): command line > config file > default.  ``+key``
append and ``#`` comments are supported by :func:`parse_args`.  Obstacle
specs arrive as one mini-config line per obstacle in ``factory_content``
(FactoryFileLineParser semantics, main.cpp:8947-8958).
"""

from __future__ import annotations

import dataclasses
import shlex
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class SimulationConfig:
    # -- domain / discretization (main.cpp:15331-15347) --
    bpdx: int = 1
    bpdy: int = 1
    bpdz: int = 1
    levelMax: int = 1
    levelStart: int = -1  # default levelMax-1, as in the reference
    Rtol: float = 5.0  # refinement tagging threshold
    Ctol: float = 0.1  # compression tagging threshold
    extent: float = 1.0
    block_size: int = 8
    bAdaptChiGradient: bool = True
    levelMaxVorticity: int = -1  # cap refinement away from bodies (def: levelMax)

    # -- boundary conditions (main.cpp:15378-15380) --
    BC_x: str = "periodic"
    BC_y: str = "periodic"
    BC_z: str = "periodic"

    # -- time stepping (main.cpp:15348-15356) --
    CFL: float = 0.1
    dt: float = 0.0  # fixed dt if > 0
    tend: float = 1.0
    nsteps: int = 0  # 0 = no step cap
    rampup: int = 100  # CFL log-ramp steps
    step_2nd_start: int = 2  # enable 2nd-order pressure after this step
    uMax_allowed: float = 10.0  # runaway-velocity abort
    # depth-2 pipelined stepping (new capability, no reference analogue):
    # the per-step QoI pack is fetched one step late so its device->host
    # transfer overlaps the next step's device work.  dt then derives from
    # max|u| one step older than the reference's policy (CFL slack absorbs
    # it); requires a single obstacle without PID/roll corrections.
    pipelined: bool = False
    # device-resident dt chain (round 4): in pipelined obstacle-free runs
    # the CFL dt is computed ON DEVICE from the previous step's max|u|
    # (exactly the non-pipelined one-step-lag policy, no staleness margin)
    # and never read back — the steady-state step issues zero blocking
    # transfers.  -1 = auto (on for a CUDA device when eligible), 0 = off,
    # 1 = force on (tests).  Obstacle runs keep the host dt: fish midline
    # kinematics consume host time each step.
    dtDevice: int = -1
    # K-step megaloop (sim/megaloop.py): run K whole timesteps — dt
    # policy, fish midline, rasterization, rigid update, penalization,
    # projection, force probe — from a device carry with no QoI read,
    # emitting the QoI as one (K, ROW) packed block.  0 = off (the per-step loop, seed
    # behavior); the CUP3D_SCAN_K env var overrides.  Requires pipelined
    # mode, free dt, a step-count stop, and either no obstacles or a
    # single frozen-gait StefanFish (megaloop eligibility in
    # sim/simulation.py).  QoI/log latency grows to K steps.
    scan_k: int = 0

    # -- fluid (main.cpp:15357-15363) --
    nu: float = 1e-3
    uinf: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lambda_penalization: float = 1e6
    DLM: float = 1.0  # if > 0: lambda = DLM/dt each step
    implicitDiffusion: bool = False
    implicitPenalization: bool = True

    # -- pressure solve (main.cpp:15364-15368) --
    poissonTol: float = 1e-6
    poissonTolRel: float = 1e-4
    # nullspace handling (ops/amr_ops.build_amr_poisson_solver): 0 none,
    # 1 pin-corner-row-to-mean, 2 mean projection, 3 Dirichlet pin.
    # Deliberate divergence: the reference defaults to 1
    # (main.cpp:15366); we default to 2 — identical physics up to the
    # nullspace constant, but the projection keeps the Krylov operator
    # uniform (no special row), which converges slightly faster here.
    bMeanConstraint: int = 2
    poissonSolver: str = "spectral"  # spectral (uniform) | iterative (AMR)

    # -- diffusion solve (main.cpp:15369-15371) --
    diffusionTol: float = 1e-6
    diffusionTolRel: float = 1e-4

    # -- forcing (main.cpp:15372-15377) --
    uMax_forced: float = 0.0
    bFixMassFlux: bool = False
    initCond: str = "zero"  # zero | taylorGreen | channel

    # -- obstacles --
    factory_content: str = ""
    factory: str = ""  # path to a factory file (one obstacle per line)

    # -- output / diagnostics (main.cpp:15381-15387) --
    freqDiagnostics: int = 0
    tdump: float = 0.0
    fdump: int = 0
    path4serialization: str = "./"
    saveFreq: int = 0
    dumpChi: bool = True
    dumpOmega: bool = False
    dumpVelocity: bool = False
    verbose: bool = True

    # -- numerics --
    dtype: str = "float32"

    def __post_init__(self):
        if self.levelStart < 0:
            self.levelStart = self.levelMax - 1
        if self.levelMaxVorticity < 0:
            self.levelMaxVorticity = self.levelMax

    def resolved_factory_content(self) -> str:
        """factory_content plus the lines of the ``factory`` file, if any
        (reference ObstacleFactory reads both, main.cpp:13247-13267)."""
        content = self.factory_content
        if self.factory:
            with open(self.factory) as f:
                lines = f.read()
            content = f"{content}\n{lines}" if content else lines
        return content

    @property
    def bc(self) -> Tuple[str, str, str]:
        return (self.BC_x, self.BC_y, self.BC_z)

    @property
    def extents(self) -> Tuple[float, float, float]:
        """Physical domain size per axis (largest bpd axis spans `extent`,
        matching _preprocessArguments, main.cpp:15388-15420)."""
        bpd = (self.bpdx, self.bpdy, self.bpdz)
        m = max(bpd)
        return tuple(self.extent * b / m for b in bpd)

    def uniform_shape(self, level: Optional[int] = None) -> Tuple[int, int, int]:
        """Cells per axis of the dense grid at `level` (default levelStart)."""
        lvl = self.levelStart if level is None else level
        s = self.block_size * (1 << lvl)
        return (self.bpdx * s, self.bpdy * s, self.bpdz * s)


# reference flag name -> dataclass field
_FLAG_ALIASES = {
    "extentx": "extent",  # run.sh spells the domain size -extentx
    "levelMax": "levelMax",
    "levelStart": "levelStart",
    "lambda": "lambda_penalization",
    "poissonTol": "poissonTol",
    "poissonTolRel": "poissonTolRel",
    "BC_x": "BC_x",
    "BC_y": "BC_y",
    "BC_z": "BC_z",
}


def _is_flag(tok: str) -> bool:
    """A token starts a flag if it begins with -/+ and is not a number
    (so negative numeric values parse as values, as in the reference)."""
    if not tok.startswith(("-", "+")) or len(tok) < 2:
        return False
    try:
        float(tok)
        return False
    except ValueError:
        return True


def parse_args(argv: List[str]) -> SimulationConfig:
    """Parse reference-style ``-key value...`` command lines.

    Reference CommandlineParser semantics (main.cpp:10181-10210):
    - consecutive non-flag tokens are space-joined into one value;
    - a valueless flag means boolean true;
    - the FIRST occurrence of ``-key`` wins, so
      ``parse_args(cli + config_file_tokens)`` gives the CLI priority;
    - ``+key`` appends (string-valued flags only, e.g. factory-content).
    Unknown flags raise, mirroring strict mode.
    """
    fields = {f.name: f for f in dataclasses.fields(SimulationConfig)}
    raw: dict = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not _is_flag(tok):
            raise ValueError(f"expected -key, got {tok!r}")
        append = tok.startswith("+")
        key = tok.lstrip("+-").replace("-", "_")
        key = _FLAG_ALIASES.get(key, key)
        if key not in fields:
            raise ValueError(f"unknown flag {tok!r}")
        i += 1
        vals = []
        while i < len(argv) and not _is_flag(argv[i]):
            vals.append(argv[i])
            i += 1
        value = " ".join(vals) if vals else "true"
        if append:
            if fields[key].type not in ("str", str):
                raise ValueError(f"'+' append is only valid for string flags: {tok!r}")
            # newline-join so '+factory-content' appends form separate
            # obstacle lines (parse_factory also splits on bare type tokens)
            raw[key] = f"{raw[key]}\n{value}" if key in raw else value
        elif key not in raw:
            raw[key] = value
    kwargs = {k: _coerce(fields[k], v) for k, v in raw.items()}
    return SimulationConfig(**kwargs)


def _coerce(f: dataclasses.Field, raw: str):
    t = f.type
    if t in ("int", int):
        return int(raw)
    if t in ("float", float):
        return float(raw)
    if t in ("bool", bool):
        return raw.lower() in ("1", "true", "yes")
    if "Tuple[float" in str(t):
        vals = [float(v) for v in raw.replace(",", " ").split()]
        return tuple(vals)
    return raw


def parse_config_file(text: str) -> List[str]:
    """Config-file lines -> argv tokens; '#' starts a comment
    (ArgumentParser file mode, main.cpp:10243-10287)."""
    argv: List[str] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            argv.extend(shlex.split(line))
    return argv


def parse_factory(content: str) -> List[dict]:
    """factory-content -> one {key: value} dict per obstacle
    (FactoryFileLineParser, main.cpp:8947-8958; ObstacleFactory
    main.cpp:13247-13289).

    Obstacles are separated by newlines; additionally any bare (non
    key=value) token starts a new obstacle, so space-joined multi-obstacle
    strings parse too.
    """
    out: List[dict] = []
    for line in content.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        for tok in shlex.split(line):
            if "=" in tok:
                if not out:
                    raise ValueError(f"factory token {tok!r} before obstacle type")
                k, v = tok.split("=", 1)
                out[-1][k] = v
            elif tok[0].isalpha():
                out.append({"type": tok})
            else:
                raise ValueError(
                    f"factory token {tok!r} is neither key=value nor an obstacle type"
                )
    return out
