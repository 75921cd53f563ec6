"""Checkpoints across the two packages (cup3d_tpu_torch/io/checkpoint.py
keeps the JAX package's on-disk format).

The JAX package steps a Taylor-Green run (16^3 uniform, or the bpd-2
forest of levelMax 2 at level 0: 8 blocks; tests/test_torch_jax_twins.py)
and writes a checkpoint with its own ``save_checkpoint``; the port's
``load_checkpoint`` reads it, without importing ``cup3d_tpu``, into a
driver on the CPU.  Both packages then step on from that file to the
same ``nsteps``: velocity within 1e-5 of max|u|.  A port-written
checkpoint round-trips bitwise in the port, and the atomic write leaves
no file behind when ``ckpt.write_fail`` fires on every retry."""

import os
import pickle

import numpy as np
import pytest
import torch

import test_torch_jax_twins as twins
from cup3d_tpu.resilience import faults as jfaults
from cup3d_tpu_torch.io import checkpoint as tck
from cup3d_tpu_torch.resilience import faults
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS_BEFORE, STEPS_TOTAL = 2, 4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("CUP3D_FAULT", "CUP3D_FUSED", "CUP3D_GETZ", "CUP3D_COARSE"):
        monkeypatch.delenv(var, raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.mark.parametrize("kind", ["uniform", "amr"])
def test_jax_checkpoint_restarts_in_the_port(tmp_path, kind):
    from cup3d_tpu.io import checkpoint as jck

    js = twins.jax_driver(kind, tmp_path, STEPS_TOTAL)
    for _ in range(STEPS_BEFORE):
        js.advance(js.calc_max_timestep())
    path = jck.save_checkpoint(js)

    ts = tck.load_checkpoint(path, device="cpu")
    assert type(ts).__module__.startswith("cup3d_tpu_torch.")
    assert twins.step_of(ts) == STEPS_BEFORE
    np.testing.assert_array_equal(twins.velocity(ts), twins.velocity(js))
    if kind == "amr":
        assert [tuple(k) for k in ts.grid.keys] == [tuple(k)
                                                    for k in js.grid.keys]
        ts.adapt_enabled = False
    # the JAX run steps on from the state it saved (its restart
    # reproduces that trajectory: tests/test_checkpoint.py)
    js.simulate()
    ts.simulate()
    assert twins.step_of(ts) == twins.step_of(js) == STEPS_TOTAL
    want = twins.velocity(js)
    assert np.abs(twins.velocity(ts) - want).max() <= 1e-5 * np.abs(
        want).max()


@pytest.mark.parametrize("kind", ["uniform", "amr"])
def test_port_checkpoint_round_trips_bitwise(tmp_path, kind):
    from cup3d_tpu_torch.__main__ import build_driver

    d = build_driver(twins.argv(kind, tmp_path, STEPS_TOTAL)
                     + ["-device", "cpu"])
    d.init()
    d.advance(d.calc_max_timestep())
    path = tck.save_checkpoint(d)
    assert tck.list_checkpoints(str(tmp_path)) == [path]
    assert tck.latest_valid_checkpoint(str(tmp_path)) == path
    payload = tck.read_payload(path)
    assert payload["kind"] == kind and payload["obstacles"] == []
    assert all(isinstance(v, np.ndarray) for v in payload["fields"].values())
    if kind == "amr":
        assert payload["leaves"].dtype == np.int64
        assert payload["leaves"].shape == (d.grid.nb, 4)
    r = tck.load_checkpoint(path, device="cpu")
    assert twins.step_of(r) == twins.step_of(d)
    want = d.state if kind == "amr" else d.sim.state
    got = r.state if kind == "amr" else r.sim.state
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a truncated file is skipped by the restart scan
    with open(path, "rb") as f:
        blob = f.read()
    bad = tck.checkpoint_path(str(tmp_path), 99)
    with open(bad, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="corrupt"):
        tck.read_payload(bad)
    assert tck.latest_valid_checkpoint(str(tmp_path)) == path


def test_write_fail_leaves_no_partial_file(tmp_path):
    from cup3d_tpu_torch.obs import metrics as M

    payload = {"version": tck.FORMAT_VERSION, "kind": "uniform", "cfg": {},
               "fields": {}, "time": 0.0, "step": 3, "dt": 0.1}
    faults.arm("ckpt.write_fail", "*", 99)
    s0 = M.snapshot()
    path = str(tmp_path / "ckpt_0000003.pkl")
    with pytest.raises(faults.InjectedFault):
        tck.write_payload(payload, path)
    assert os.listdir(tmp_path) == []
    assert M.delta(s0)["resilience.write_retries{site=ckpt}"] == 2
    faults.clear()
    tck.write_payload(payload, path)
    with open(path, "rb") as f:
        assert pickle.load(f)["step"] == 3


def test_checkpoints_naming_jax_classes_are_refused(tmp_path):
    """Unpickling never imports the JAX package: a payload that names one
    of its classes (an obstacle) is refused."""
    path = tmp_path / "ckpt_0000001.pkl"
    # protocol-0 pickle of the global cup3d_tpu.models.sphere.Sphere
    path.write_bytes(b"ccup3d_tpu.models.sphere\nSphere\n.")
    with pytest.raises(ValueError, match="JAX package"):
        tck.read_payload(str(path))
