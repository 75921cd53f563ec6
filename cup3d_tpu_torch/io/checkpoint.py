"""Checkpoint / restore of a full run (port of
``cup3d_tpu/io/checkpoint.py``, the same on-disk format).

A checkpoint is one pickled dict: ``version`` (:data:`FORMAT_VERSION`),
``kind`` ("uniform" or "amr"), ``cfg`` as a plain dict, ``leaves`` (the
octree leaf keys as an (nb, 4) int64 array on the forest, else None),
``fields`` as numpy arrays in the JAX package's layouts, ``time``,
``step``, ``dt``, ``uinf``, ``lambda_penal``, ``next_dump`` and
``obstacles`` (the obstacle objects, pickled with their host state only:
chi/udef are rebuilt from it after a load).  An obstacle-free checkpoint
written by either package restarts in the other: the port writes an
obstacle-free forest's ``chi``/``udef`` as zeros, the fields it does not
keep, and reads only ``vel`` and ``p`` there.  The port's own obstacles
round-trip on both layouts (the forest's with the JAX package's layout
of the payload: its obstacles, then CreateObstacles(0.0) rebuilds chi,
udef and sdf).  Unpickling never imports the JAX package: a
payload that names one of its classes (its obstacles) is refused with a
clear error.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

FORMAT_VERSION = 1


def _driver_kind(driver) -> str:
    from cup3d_tpu_torch.sim.amr import AMRSimulation

    return "amr" if isinstance(driver, AMRSimulation) else "uniform"


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:07d}.pkl")


def build_payload(driver) -> dict:
    """Everything a checkpoint needs, without reading the device:
    ``fields`` holds references to the live tensors (the recovery engine
    clones them; :func:`materialize_payload` reads them)."""
    if _driver_kind(driver) == "amr":
        # the real blocks' rows (views): a checkpoint is layout-free
        kind = "amr"
        state = {k: driver._unpad(v) for k, v in driver.state.items()}
        time, step, dt = driver.time, driver.step_idx, driver.dt
        uinf, lam = driver.uinf, driver.lambda_penal
        leaves = np.asarray(driver.grid.keys, np.int64).reshape(-1, 4)
        obstacles = driver.obstacles
        next_dump = driver._cadence.next_dump
    else:
        s = driver.sim
        kind, state = "uniform", s.state
        time, step, dt = s.time, s.step, s.dt
        uinf, lam = s.uinf, s.lambda_penal
        leaves = None
        obstacles = s.obstacles
        next_dump = s.cadence.next_dump
    return {
        "version": FORMAT_VERSION,
        "kind": kind,
        "cfg": dataclasses.asdict(driver.cfg),
        "leaves": leaves,
        "fields": dict(state),
        "time": float(time),
        "step": int(step),
        "dt": float(dt),
        "uinf": np.asarray(uinf, np.float64),
        "lambda_penal": float(lam),
        "next_dump": float(next_dump),
        "obstacles": obstacles,
    }


def materialize_payload(payload: dict) -> dict:
    """Read the field tensors of ``build_payload`` to numpy; on the
    forest keep the real blocks' rows and add the JAX package's
    ``chi``/``udef`` as zeros."""
    out = dict(payload)
    fields = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v) for k, v in payload["fields"].items()}
    if payload["kind"] == "amr":
        # the real blocks' rows (build_payload's are already)
        nb = len(payload["leaves"])
        fields = {k: v[:nb] for k, v in fields.items()}
        fields.setdefault("chi", np.zeros_like(fields["p"]))
        fields.setdefault("udef", np.zeros_like(fields["vel"]))
    out["fields"] = fields
    return out


def write_payload(payload: dict, path: str) -> str:
    """Atomic, retried write (tmp file + ``os.replace``, backoff on
    failure): a kill or an armed ``ckpt.write_fail`` leaves the previous
    complete file or none, never a truncated pickle."""
    from cup3d_tpu_torch.resilience import faults, writeguard

    def _write(tmp: str) -> None:
        # fires on every retry while armed
        faults.maybe_raise("ckpt.write_fail", payload.get("step"))
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)

    return writeguard.atomic_write(path, _write, site="ckpt")


def save_checkpoint(driver, path: Optional[str] = None) -> str:
    """Synchronous checkpoint to ``path`` (default
    ``<path4serialization>/ckpt_<step>.pkl``)."""
    payload = build_payload(driver)
    if path is None:
        path = checkpoint_path(driver.cfg.path4serialization,
                               payload["step"])
    return write_payload(materialize_payload(payload), path)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "cup3d_tpu" or module.startswith("cup3d_tpu."):
            raise ValueError(
                f"the checkpoint holds {module}.{name} of the JAX package, "
                "which the port does not import: only checkpoints of "
                "obstacle-free runs restart across the packages")
        return super().find_class(module, name)


def read_payload(path: str) -> dict:
    """Unpickle and validate one checkpoint; a partial, corrupt or foreign
    file raises ``ValueError``."""
    try:
        with open(path, "rb") as f:
            payload = _Unpickler(f).load()
    except OSError:
        raise
    except Exception as e:
        raise ValueError(f"corrupt or truncated checkpoint {path!r}: "
                         f"{type(e).__name__}: {e}") from e
    if not isinstance(payload, dict) or "version" not in payload:
        raise ValueError(f"not a cup3d_tpu checkpoint payload: {path!r}")
    if payload["version"] != FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint version {payload['version']}")
    missing = [k for k in ("kind", "cfg", "fields", "time", "step", "dt")
               if k not in payload]
    if missing:
        raise ValueError(f"incomplete checkpoint {path!r}: missing keys "
                         f"{missing}")
    return payload


def list_checkpoints(directory: str):
    """``ckpt_*.pkl`` files under ``directory``, oldest step first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for n in names:
        if n.startswith("ckpt_") and n.endswith(".pkl"):
            try:
                step = int(n[len("ckpt_"):-len(".pkl")])
            # torch-lint: allow(JX009, a file named like a checkpoint without a
            # step number is not one)
            except ValueError:
                continue
            out.append((step, os.path.join(directory, n)))
    return [p for _, p in sorted(out)]


def latest_valid_checkpoint(directory: str) -> Optional[str]:
    """Newest checkpoint under ``directory`` whose payload validates."""
    for path in reversed(list_checkpoints(directory)):
        try:
            read_payload(path)
        # torch-lint: allow(JX009, an invalid checkpoint is skipped for the
        # next newest: the search's purpose)
        except (ValueError, OSError):
            continue
        return path
    return None


def load_checkpoint(path: str, device=None, mesh=None):
    """Rebuild the driver (AMRSimulation or Simulation) from a checkpoint,
    ready to ``simulate()``, on ``device`` (None: CUDA, as every entry
    point).  ``mesh`` (parallel/forest.make_block_mesh) restores a forest
    checkpoint INTO the block-sharded mode, on the mesh's device: the
    fields padded to the forest's ``nb_pad`` rows exactly as a fresh mesh
    run lays them out.  Checkpoints hold unpadded fields, so a save of
    either layout restores into the other."""
    from cup3d_tpu_torch.config import SimulationConfig

    payload = read_payload(path)
    cfg = SimulationConfig(**payload["cfg"])
    fields = payload["fields"]
    if payload["kind"] == "amr":
        from cup3d_tpu_torch.grid.octree import TreeConfig
        from cup3d_tpu_torch.sim.amr import AMRSimulation, tree_from_keys

        keys = [tuple(int(v) for v in k) for k in payload["leaves"]]
        periodic = tuple(b == "periodic" for b in cfg.bc)
        tree = tree_from_keys(TreeConfig((cfg.bpdx, cfg.bpdy, cfg.bpdz),
                                         cfg.levelMax, periodic), keys)
        driver = AMRSimulation(cfg, tree=tree, device=device, mesh=mesh)
        if driver.grid.keys != keys:
            raise ValueError("checkpoint leaves are not in the forest's "
                             "Hilbert slot order")
        driver.state = {k: driver._pad(torch.tensor(
            np.asarray(fields[k]), dtype=driver.dtype, device=driver.device))
            for k in driver.state}
        driver.time = float(payload["time"])
        driver.step_idx = int(payload["step"])
        driver.dt = float(payload["dt"])
        driver.uinf = np.asarray(payload["uinf"], np.float64)
        driver.lambda_penal = float(payload["lambda_penal"])
        driver._cadence.next_dump = float(payload["next_dump"])
        driver.obstacles = list(payload.get("obstacles") or [])
        for ob in driver.obstacles:
            ob.sim = driver
        driver.create_obstacles(0.0)  # rebuild chi/udef/sdf
        return driver

    from cup3d_tpu_torch.sim.simulation import Simulation

    if mesh is not None:
        raise ValueError("mesh= restores a forest checkpoint; this one is "
                         "of the uniform grid")
    driver = Simulation(cfg, device=device)
    s = driver.sim
    s.state = {k: torch.tensor(np.asarray(v), dtype=s.dtype, device=s.device)
               for k, v in fields.items()}
    s.time = float(payload["time"])
    s.step = int(payload["step"])
    s.dt = float(payload["dt"])
    s.uinf = np.asarray(payload["uinf"], np.float64)
    s.lambda_penal = float(payload["lambda_penal"])
    s.cadence.next_dump = float(payload["next_dump"])
    s.obstacles = list(payload.get("obstacles") or [])
    for ob in s.obstacles:
        ob.sim = s
    driver._setup_operators()
    if s.obstacles:
        driver.pipeline[0](0.0)  # CreateObstacles: rebuild chi/udef
    return driver

