"""JAX drivers shared by the port's twin tests (test_torch_checkpoint.py,
test_torch_resilience.py, test_torch_fish_sim.py), and the test of their
reset.

A new JAX driver compiles its step functions on its first steps, seconds
on the CPU for each driver.  The twin tests therefore build one JAX
driver per configuration and process, and take it back to its initial
state before each use through the driver's own rollback hook
(``_resilience_restore``, the recovery engine's), which keeps its
compiled steps; the reset also puts back the Poisson solver a recovery
ladder may have rebuilt.  Two configurations are Taylor-Green runs of
16^3 cells: the uniform grid, and the bpd-2 forest of levelMax 2 held at
level 0 (8 blocks; Rtol/Ctol keep it there).  The third, "fish", is
BASELINE config #2 (one self-propelled StefanFish, iterative Poisson at
1e-6/1e-4, non-pipelined) cut to 32^3, its centre on a cell centre (the
body's section is thinner than a cell at 32^3).  The fourth,
"amr_fish", is BASELINE config #4 (run.sh's two StefanFish on the
adapting forest, the bench's factory lines) cut to bpd 1, levelMax 3,
levelStart 2 (finest h 1/32, the fish twin's), the bodies' centres on
cell centres in y and z; its JAX driver runs the unpadded host path
(``CUP3D_BUCKET=0``, the JAX package's equivalence baseline).

The forest's pipelined and physics twins are the JAX package's own test
cases (tests/test_amr_pipelined.py, at its sizes): "amr_pipe", its
pipelined Taylor-Green forest (bpd 2, levelMax 2, dt 1e-3); "amr_spheres",
its two spheres pipelined on the bpd-1 forest at levelMax 2 (dt 1e-3);
"amr_channel", a walled forest channel (bpd 2x1x1 at level 1, walls in
y) with FixMassFlux at uMax_forced 0.5 on the host path; and
"amr_implicit", the Taylor-Green forest with implicit diffusion at nu
0.02, dt 0.02.
"""

import os

import pickle

import numpy as np
import pytest
import torch

UNIFORM = ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 1 -extent 6.283185307179586 "
           "-initCond taylorGreen -poissonSolver iterative -nu 0.02 "
           "-CFL 0.3 -rampup 0 -verbose 0")
FOREST = UNIFORM.replace("-levelMax 1", "-levelMax 2 -levelStart 0 "
                         "-Rtol 100 -Ctol 0")
FISH = ("-bpdx 4 -bpdy 4 -bpdz 4 -levelMax 1 -extent 1 -CFL 0.4 -nu 1e-3 "
        "-rampup 100 -poissonSolver iterative -poissonTol 1e-6 "
        "-poissonTolRel 1e-4 -verbose 0")
FISH_BODY = ("StefanFish L=0.4 T=1.0 xpos=0.5 ypos=0.515625 zpos=0.515625 "
             "bFixFrameOfRef=1 heightProfile=danio widthProfile=stefan")

AMR_FISH = ("-bpdx 1 -bpdy 1 -bpdz 1 -levelMax 3 -levelStart 2 -extent 1 "
            "-Rtol 5 -Ctol 0.1 -CFL 0.4 -nu 0.001 -rampup 100 "
            "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
            "-verbose 0")
TWO_FISH = ("StefanFish L=0.4 T=1.0 xpos=0.3 ypos=0.515625 zpos=0.515625 "
            "planarAngle=180 heightProfile=danio widthProfile=stefan "
            "bFixFrameOfRef=1\n"
            "StefanFish L=0.4 T=1.0 xpos=0.7 ypos=0.515625 zpos=0.515625 "
            "heightProfile=danio widthProfile=stefan")

FOREST_PIPE = ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 2 -levelStart 0 "
               "-extent 6.283185307179586 -initCond taylorGreen -Rtol 1.8 "
               "-Ctol 0.05 -nu 0.001 -CFL 0.4 -rampup 0 -dt 0.001 "
               "-poissonSolver iterative -poissonTol 1e-6 "
               "-poissonTolRel 1e-4 -freqDiagnostics 0 -pipelined 1 "
               "-verbose 0")
SPHERES = ("-bpdx 1 -bpdy 1 -bpdz 1 -levelMax 2 -levelStart 1 -extent 1 "
           "-Rtol 5 -Ctol 0.1 -CFL 0.4 -nu 0.001 -rampup 0 -dt 0.001 "
           "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
           "-freqDiagnostics 0 -pipelined 1 -verbose 0")
TWO_SPHERES = ("Sphere radius=0.12 xpos=0.35 ypos=0.5 zpos=0.5 xvel=0.3 "
               "bForcedInSimFrame=1 bFixFrameOfRef=1\n"
               "Sphere radius=0.1 xpos=0.7 ypos=0.45 zpos=0.5")
CHANNEL = ("-bpdx 2 -bpdy 1 -bpdz 1 -levelMax 2 -levelStart 1 -extent 2 "
           "-BC_y wall -Rtol 100 -Ctol 0 -nu 0.001 -CFL 0.4 -rampup 0 "
           "-dt 0.005 -uMax_forced 0.5 -bFixMassFlux 1 "
           "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
           "-freqDiagnostics 0 -verbose 0")
IMPLICIT = FOREST.replace("-CFL 0.3", "-CFL 0.3 -dt 0.02 "
                          "-implicitDiffusion 1")
_BASES = {"uniform": UNIFORM, "amr": FOREST, "fish": FISH,
          "amr_fish": AMR_FISH, "amr_pipe": FOREST_PIPE,
          "amr_spheres": SPHERES, "amr_channel": CHANNEL,
          "amr_implicit": IMPLICIT}
_BODIES = {"fish": FISH_BODY, "amr_fish": TWO_FISH,
           "amr_spheres": TWO_SPHERES}

_drivers = {}


def argv(kind: str, tmp, nsteps: int) -> list:
    """The CLI arguments of ``kind`` (a key of ``_BASES``), stopping after
    ``nsteps`` steps and writing under ``tmp``."""
    out = (f"{_BASES[kind]} -tend 0 -nsteps {nsteps} "
           f"-path4serialization {tmp}").split()
    if kind in _BODIES:
        out += ["-factory-content", _BODIES[kind]]
    return out


def jax_driver(kind: str, tmp, nsteps: int):
    """This process's JAX driver of ``kind`` at its initial state, set to
    stop after ``nsteps`` steps and to write its checkpoints under
    ``tmp``; its recovery events are cleared."""
    import jax.numpy as jnp

    from cup3d_tpu.__main__ import build_driver
    from cup3d_tpu.io.checkpoint import build_payload

    if kind not in _drivers:
        prev = os.environ.get("CUP3D_BUCKET")
        if kind == "amr_fish":  # read when the driver is built
            os.environ["CUP3D_BUCKET"] = "0"
        try:
            d = build_driver(argv(kind, tmp, nsteps))
        finally:
            if prev is None:
                os.environ.pop("CUP3D_BUCKET", None)
            else:
                os.environ["CUP3D_BUCKET"] = prev
        d.init()
        p = build_payload(d)
        # the step jits donate the live fields: keep copies
        p["fields"] = {k: jnp.copy(v) for k, v in p["fields"].items()}
        p["obstacles"] = pickle.dumps(p["obstacles"])
        solver = getattr(getattr(d, "sim", None), "poisson_solver", None)
        _drivers[kind] = (d, p, solver, list(getattr(d, "pipeline", [])))
    d, p, solver, pipeline = _drivers[kind]
    if solver is not None:
        d.sim.poisson_solver = solver
        d.pipeline[:] = pipeline
    d._resilience_restore(p)
    d.cfg.path4serialization = str(tmp)
    d.cfg.nsteps = nsteps
    d.flight.recovery_events.clear()
    return d


def velocity(d):
    """The velocity of either package's driver, as a numpy copy (the JAX
    forest's padding rows dropped)."""
    v = d.state["vel"] if hasattr(d, "step_idx") else d.sim.state["vel"]
    if hasattr(d, "_unpad"):  # the JAX forest pads its block axis
        v = d._unpad(v)
    return np.array(v.numpy() if isinstance(v, torch.Tensor) else v)


def step_of(d) -> int:
    return d.step_idx if hasattr(d, "step_idx") else d.sim.step


def time_of(d) -> float:
    return d.time if hasattr(d, "step_idx") else d.sim.time


@pytest.mark.parametrize("kind", ["uniform", "amr"])
def test_reset_returns_the_jax_driver_to_its_initial_state(tmp_path, kind):
    d = jax_driver(kind, tmp_path, 2)
    v0 = velocity(d)
    d.advance(d.calc_max_timestep())
    assert step_of(d) == 1 and not np.array_equal(velocity(d), v0)
    d = jax_driver(kind, tmp_path, 2)
    assert step_of(d) == 0 and time_of(d) == 0.0
    np.testing.assert_array_equal(velocity(d), v0)
