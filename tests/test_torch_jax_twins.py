"""JAX drivers shared by the port's twin tests (test_torch_checkpoint.py,
test_torch_resilience.py), and the test of their reset.

A new JAX driver compiles its step functions on its first steps, seconds
on the CPU for each driver.  The twin tests therefore build one JAX
driver per configuration and process, and take it back to its initial
state before each use through the driver's own rollback hook
(``_resilience_restore``, the recovery engine's), which keeps its
compiled steps.  Both configurations are Taylor-Green runs of 16^3
cells: the uniform grid, and the bpd-2 forest of levelMax 2 held at
level 0 (8 blocks; Rtol/Ctol keep it there).
"""

import pickle

import numpy as np
import pytest
import torch

UNIFORM = ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 1 -extent 6.283185307179586 "
           "-initCond taylorGreen -poissonSolver iterative -nu 0.02 "
           "-CFL 0.3 -rampup 0 -verbose 0")
FOREST = UNIFORM.replace("-levelMax 1", "-levelMax 2 -levelStart 0 "
                         "-Rtol 100 -Ctol 0")

_drivers = {}


def argv(kind: str, tmp, nsteps: int) -> list:
    """The CLI arguments of ``kind`` ("uniform" or "amr"), stopping after
    ``nsteps`` steps and writing under ``tmp``."""
    base = UNIFORM if kind == "uniform" else FOREST
    return (f"{base} -tend 0 -nsteps {nsteps} "
            f"-path4serialization {tmp}").split()


def jax_driver(kind: str, tmp, nsteps: int):
    """This process's JAX driver of ``kind`` at its initial state, set to
    stop after ``nsteps`` steps and to write its checkpoints under
    ``tmp``; its recovery events are cleared."""
    import jax.numpy as jnp

    from cup3d_tpu.__main__ import build_driver
    from cup3d_tpu.io.checkpoint import build_payload

    if kind not in _drivers:
        d = build_driver(argv(kind, tmp, nsteps))
        d.init()
        p = build_payload(d)
        # the step jits donate the live fields: keep copies
        p["fields"] = {k: jnp.copy(v) for k, v in p["fields"].items()}
        p["obstacles"] = pickle.dumps(p["obstacles"])
        _drivers[kind] = (d, p)
    d, p = _drivers[kind]
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
