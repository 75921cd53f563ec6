"""SimulationData: the runtime state of a uniform-grid run (port of
``cup3d_tpu/sim/data.py``; reference main.cpp:6600-6677), plus the state
carry functions that let the JAX package and the port start from one
numpy state.

Fields are dense tensors on ``device`` in the JAX package's layout:
vel/udef (nx,ny,nz,3), chi/p (nx,ny,nz).  ``obstacle_state_to_numpy`` /
``load_obstacle_state_numpy`` carry the obstacles' host state (rigid
mirrors, gait and PID state) between the packages the same way.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List

import numpy as np
import torch

from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.grid.uniform import BC, UniformGrid
from cup3d_tpu_torch.io.logging import BufferedLogger, Profiler
from cup3d_tpu_torch.analysis.runtime import upload
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
        # which Krylov path this run built (storage dtype, fused driver),
        # so a metrics dump tells the configurations apart
        from cup3d_tpu_torch.obs import metrics as obs_metrics
        from cup3d_tpu_torch.ops import precision

        obs_metrics.gauge("poisson.krylov_bf16").set(
            float(precision.krylov_dtype() == torch.bfloat16))
        obs_metrics.gauge("poisson.fused_iteration").set(
            float(precision.use_fused()))

        # scalars (host side, mirroring main.cpp:15348-15387 defaults)
        self.time: float = 0.0
        self.step: int = 0
        self.dt: float = 0.0
        self.uinf = np.asarray(cfg.uinf, dtype=np.float64)
        self.lambda_penal = cfg.lambda_penalization
        self.nu = cfg.nu
        self.obstacles: List = []  # filled by the obstacle factory
        # device QoI produced during a step, read back in ONE host read at
        # the end of the step (Simulation.advance)
        self.pending_parts: List = []
        self._uinf_src = None   # identity of the uploaded host uinf
        self._uinf_dev = None
        # built on first use, so obstacle-free runs never hold them
        self._xc_cache = None
        self._dlm_dev_cache = None
        self._lambda_dev_cache = None
        self._lambda_dev_val = None

        self.logger = BufferedLogger(cfg.path4serialization)
        self.profiler = Profiler()
        from cup3d_tpu_torch.io.dump import OutputCadence

        self.cadence = OutputCadence(cfg.tdump, cfg.fdump, cfg.saveFreq)

    @property
    def vel(self) -> torch.Tensor:
        return self.state["vel"]

    def uinf_device(self) -> torch.Tensor:
        """Device copy of the frame velocity, uploaded when ``uinf`` is
        reassigned (identity check: a swimming frame reassigns it every
        step) and reused otherwise."""
        if self._uinf_src is not self.uinf:
            self._uinf_dev = upload(self.uinf, self.dtype, self.device,
                                    tag="uinf-upload")
            self._uinf_src = self.uinf
        return self._uinf_dev

    @property
    def xc(self) -> torch.Tensor:
        """Cell centres (nx,ny,nz,3) on the device, built once."""
        if self._xc_cache is None:
            self._xc_cache = self.grid.cell_centers(self.dtype, self.device)
        return self._xc_cache

    def ubody(self, udef, cm, ut, om) -> torch.Tensor:
        """Rigid + deformation body velocity u_t + om x (x - cm) + udef
        on the whole grid."""
        xc = self.xc
        return ut + torch.linalg.cross(om.expand_as(xc), xc - cm) + udef

    def lambda_device(self, dt_dev) -> torch.Tensor:
        """This step's penalization lambda on the device: DLM/dt from the
        step's dt tensor when DLM > 0 (main.cpp:15302-15303; the host
        ``lambda_penal`` mirror feeds logs and checkpoints), else the
        static lambda, uploaded once per value."""
        if self.cfg.DLM > 0:
            if self._dlm_dev_cache is None:
                self._dlm_dev_cache = upload(self.cfg.DLM, self.dtype,
                                             self.device,
                                             tag="scalar-upload")
            return self._dlm_dev_cache / dt_dev
        if self._lambda_dev_val != self.lambda_penal:
            self._lambda_dev_cache = upload(self.lambda_penal, self.dtype,
                                            self.device,
                                            tag="scalar-upload")
            self._lambda_dev_val = self.lambda_penal
        return self._lambda_dev_cache


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


#: host attributes of an obstacle carried by obstacle_state_to_numpy (its
#: gait generator ``myFish`` travels whole: every attribute, schedulers
#: included)
OBSTACLE_KEYS = ("position", "quaternion", "transVel", "angVel",
                 "centerOfMass", "absPos", "origC", "mass", "J",
                 "penal_force", "penal_torque",
                 "n_surf_points", "_probe_budget", "r_axis",
                 "collision_counter", "collision_vel", "collision_angvel")


def _host_copy(v):
    """A numpy / plain-Python copy of a host attribute of either package
    (a JAX or torch array becomes a numpy array, floating as float64; an
    object such as a scheduler becomes a dict of its attributes)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, deque):
        return deque(_host_copy(x) for x in v)
    if isinstance(v, (list, tuple)):
        return type(v)(_host_copy(x) for x in v)
    if hasattr(v, "__array__"):
        a = np.array(v)
        return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) \
            else a
    if hasattr(v, "__dict__"):
        return {k: _host_copy(x) for k, x in vars(v).items()}
    raise TypeError(f"cannot carry a {type(v).__name__}")


def obstacle_state_to_numpy(sim) -> dict:
    """The host state of ``sim``'s obstacles (a SimulationData of either
    package): per obstacle its rigid mirrors, penalization force and the
    whole gait generator (curvature and period schedulers, PID state),
    plus the sim's ``lambda_penal``.  :func:`load_obstacle_state_numpy`
    takes it."""
    obs = []
    for ob in sim.obstacles:
        d = {k: _host_copy(getattr(ob, k)) for k in OBSTACLE_KEYS
             if hasattr(ob, k)}
        if hasattr(ob, "myFish"):
            d["myFish"] = _host_copy(ob.myFish)
        obs.append(d)
    return {"lambda_penal": float(sim.lambda_penal), "obstacles": obs}


def _assign(obj, name, value) -> None:
    cur = getattr(obj, name, None)
    if isinstance(value, dict) and hasattr(cur, "__dict__"):
        for k, v in value.items():
            _assign(cur, k, v)
    else:
        setattr(obj, name, _host_copy(value))


def load_obstacle_state_numpy(sim, state: dict) -> None:
    """Set the host state of ``sim``'s obstacles (either package's, built
    from the same factory line) from :func:`obstacle_state_to_numpy`.
    Device rigid state and cached fields are dropped: the next step's
    CreateObstacles rebuilds them from the host mirrors."""
    if len(state["obstacles"]) != len(sim.obstacles):
        raise ValueError(f"{len(state['obstacles'])} obstacle states for "
                         f"{len(sim.obstacles)} obstacles")
    sim.lambda_penal = float(state["lambda_penal"])
    for ob, d in zip(sim.obstacles, state["obstacles"]):
        for k, v in d.items():
            _assign(ob, k, v)
        ob._dev_rigid = None
        ob._ubody_cache = None


def scan_carry_to_numpy(carry: dict) -> dict:
    """A megaloop carry of either package (vel, p, [chi, udef, rigid,
    qint,] umax, dt, time) as numpy arrays, for
    :func:`load_scan_carry_numpy`."""
    return {k: _host_copy(v) for k, v in carry.items()}


def load_scan_carry_numpy(driver, carry: dict) -> None:
    """Make a carry from :func:`scan_carry_to_numpy` (a JAX run's, say) the
    port driver's megaloop carry, and its fields the driver's fields: the
    next ``advance_megaloop`` continues from it.  The host scalars follow
    its (dt, time) chain."""
    s = driver.sim
    dev = {k: upload(np.asarray(v), s.dtype, s.device)
           for k, v in carry.items()}
    for name in ("vel", "p", "chi", "udef"):
        if name in dev:
            want = tuple(s.state[name].shape)
            if tuple(dev[name].shape) != want:
                raise ValueError(f"{name}: shape {tuple(dev[name].shape)}, "
                                 f"expected {want}")
            s.state[name] = dev[name]
    s.time = float(np.asarray(carry["time"]))
    s.dt = float(np.asarray(carry["dt"]))
    driver._scan_carry = dev


def gait_from_numpy(gait: dict, dtype, device) -> dict:
    """A frozen gait (models/fish/device_midline.freeze_gait) of either
    package on the port's device: arrays become tensors in ``dtype``,
    Python scalars stay."""
    return {k: (upload(np.asarray(v, np.float64), dtype, device)
                if np.ndim(v) > 0 else float(v))
            for k, v in gait.items()}
