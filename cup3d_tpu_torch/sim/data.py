"""SimulationData: the runtime state of a uniform-grid run (port of
``cup3d_tpu/sim/data.py``; reference main.cpp:6600-6677), plus the state
carry functions that let the JAX package and the port start from one
numpy state.

Fields are dense tensors on ``device`` in the JAX package's layout:
vel/udef (nx,ny,nz,3), chi/p (nx,ny,nz).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.grid.uniform import BC, UniformGrid
from cup3d_tpu_torch.io.logging import BufferedLogger, Profiler
from cup3d_tpu_torch.ops.poisson import make_poisson_solver

FIELDS = ("vel", "chi", "p", "udef")
SCALARS = ("time", "step", "dt", "uinf")


class SimulationData:
    def __init__(self, cfg: SimulationConfig, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        shape = cfg.uniform_shape()
        self.grid = UniformGrid(shape, cfg.extents,
                                tuple(BC(b) for b in cfg.bc))
        self.dtype = getattr(torch, cfg.dtype)

        n3 = shape + (3,)
        kw = dict(dtype=self.dtype, device=self.device)
        self.state: Dict[str, torch.Tensor] = {
            "vel": torch.zeros(n3, **kw),
            "chi": torch.zeros(shape, **kw),
            "p": torch.zeros(shape, **kw),
            "udef": torch.zeros(n3, **kw),
        }

        self.poisson_solver: Callable = make_poisson_solver(
            self.grid,
            cfg.poissonSolver,
            self.dtype,
            tol_abs=cfg.poissonTol,
            tol_rel=cfg.poissonTolRel,
            mean_constraint=cfg.bMeanConstraint,
        )

        # scalars (host side, mirroring main.cpp:15348-15387 defaults)
        self.time: float = 0.0
        self.step: int = 0
        self.dt: float = 0.0
        self.uinf = np.asarray(cfg.uinf, dtype=np.float64)
        # penalization lambda: no obstacles run yet (ROADMAP A3); kept for
        # the checkpoint payload
        self.lambda_penal = cfg.lambda_penalization
        self.nu = cfg.nu
        # device QoI produced during a step, read back in ONE host read at
        # the end of the step (Simulation.advance)
        self.pending_parts: List = []
        self._uinf_src = None   # identity of the uploaded host uinf
        self._uinf_dev = None

        self.logger = BufferedLogger(cfg.path4serialization)
        self.profiler = Profiler()

    @property
    def vel(self) -> torch.Tensor:
        return self.state["vel"]

    def uinf_device(self) -> torch.Tensor:
        """Device copy of the frame velocity, uploaded when ``uinf`` is
        reassigned (identity check) and reused otherwise."""
        if self._uinf_src is not self.uinf:
            self._uinf_dev = torch.as_tensor(self.uinf, dtype=self.dtype,
                                             device=self.device)
            self._uinf_src = self.uinf
        return self._uinf_dev


def load_state_numpy(sim: SimulationData, arrays: Dict[str, np.ndarray],
                     scalars: Dict[str, object]) -> None:
    """Set ``sim``'s fields and scalars from numpy, e.g. a JAX run's
    ``{k: np.asarray(v) for k, v in jax_sim.state.items()}`` and its
    ``time``/``step``/``dt``/``uinf``.  Arrays are in the JAX layouts
    (nx,ny,nz[,3]); every one of vel, chi, p, udef is required."""
    for name in FIELDS:
        want = tuple(sim.state[name].shape)
        a = np.asarray(arrays[name])
        if a.shape != want:
            raise ValueError(f"{name}: shape {a.shape}, expected {want}")
        sim.state[name] = torch.tensor(a, dtype=sim.dtype, device=sim.device)
    sim.time = float(scalars["time"])
    sim.step = int(scalars["step"])
    sim.dt = float(scalars["dt"])
    sim.uinf = np.asarray(scalars["uinf"], dtype=np.float64).reshape(3)


def state_to_numpy(sim: SimulationData):
    """(arrays, scalars) in the form :func:`load_state_numpy` takes."""
    arrays = {k: sim.state[k].detach().cpu().numpy() for k in FIELDS}
    scalars = {"time": sim.time, "step": sim.step, "dt": sim.dt,
               "uinf": np.array(sim.uinf, dtype=np.float64)}
    return arrays, scalars
