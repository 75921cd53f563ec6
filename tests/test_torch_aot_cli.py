"""The compiled store across processes and against the JAX fleet, on
the CPU.

- ``python -m cup3d_tpu_torch aot probe -device cpu`` twice on one
  store: the second process builds no forest table and waits on no
  build, it binds as many advances as the first (a bind builds
  nothing), and its QoI rows hash bitwise the first's; ``aot warm`` on
  that store finds everything stored;
- ``aot warm`` fills an empty store without running a job, and a server
  on it builds no table."""

import json
import os
import subprocess
import sys

import pytest
import torch

from cup3d_tpu_torch.fleet.server import DONE, FleetServer
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.resilience import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = [dict(kind="tgv", n=16, nsteps=8, cfl=0.3, tenant="x"),
         dict(kind="amr_tgv", bpd=2, levelMax=2, nsteps=8, cfl=0.3,
              tenant="y")]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("CUP3D_AOT_STORE", raising=False)
    faults.clear()
    yield
    faults.clear()
    torch.set_num_threads(n)


def _aot(tmp_path, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("CUP3D_AOT_STORE", "CUP3D_FAULT"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "cup3d_tpu_torch", "aot", *args,
         "-device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def _probe(tmp_path, tag, store="store"):
    return _aot(tmp_path, "probe", "--scenarios", str(tmp_path / "spec.json"),
                "--store", str(tmp_path / store),
                "--workdir", str(tmp_path / f"wd-{tag}"))


def test_probe_cold_then_warm_across_processes(tmp_path):
    """Two probes on one store, then ``aot warm`` on it: everything is
    already stored, and nothing is built again."""
    (tmp_path / "spec.json").write_text(json.dumps(SPECS))
    cold = _probe(tmp_path, "cold")
    warm = _probe(tmp_path, "warm")
    for rep in (cold, warm):
        assert {"advance_compiles", "aot_counters", "rows_blake2s", "jobs",
                "nvcc_builds", "table_builds", "first_dispatch_s",
                "compile_wait_frac"} <= set(rep)
        assert set(rep["jobs"].values()) == {DONE}
        assert rep["nvcc_builds"] == 0  # the CPU runs no kernel
    assert cold["advance_compiles"] >= 2 and cold["table_builds"] >= 1
    assert cold["compile_wait_frac"] > 0
    assert warm["table_builds"] == 0
    assert warm["advance_compiles"] == cold["advance_compiles"]
    assert warm["aot_counters"].get("aot.store_hits", 0) >= 1
    assert warm["compile_wait_frac"] == 0.0
    assert warm["rows_blake2s"] == cold["rows_blake2s"]
    rep = _aot(tmp_path, "warm", "--scenarios", str(tmp_path / "spec.json"),
               "--store", str(tmp_path / "store"),
               "--workdir", str(tmp_path / "wd-warm-cmd"))
    assert len(rep["warmed"]) == 2
    assert all(e["warmed"] and e["already_stored"] for e in rep["warmed"])
    assert rep["state"]["files"] >= cold["aot_counters"]["aot.store_writes"]
    assert cold["aot_counters"]["aot.store_writes"] >= cold["table_builds"]


def test_warm_fills_an_empty_store(tmp_path):
    """``aot warm`` on an empty store builds the spec's forest tables
    without running a job (on the CPU a tgv group needs no record); a
    later server on that store builds no table."""
    (tmp_path / "spec.json").write_text(json.dumps(SPECS))
    rep = _aot(tmp_path, "warm", "--scenarios", str(tmp_path / "spec.json"),
               "--store", str(tmp_path / "w"),
               "--workdir", str(tmp_path / "wd"))
    assert len(rep["warmed"]) == 2 and all(e["warmed"]
                                           for e in rep["warmed"])
    by_kind = {e["kind"]: e for e in rep["warmed"]}
    assert by_kind["amr_tgv"]["records"] == ["tables"]
    assert not by_kind["amr_tgv"]["already_stored"]
    assert by_kind["tgv"]["records"] == []
    assert all(e["carry_bytes"] > 0 for e in rep["warmed"])
    import os as _os

    _os.environ["CUP3D_AOT_STORE"] = str(tmp_path / "w")
    try:
        before = M.snapshot()
        srv = FleetServer(workdir=str(tmp_path / "srv"), device="cpu")
        ids = [srv.submit(sp["tenant"], dict(sp)) for sp in SPECS]
        srv.drain()
    finally:
        del _os.environ["CUP3D_AOT_STORE"]
    after = M.snapshot()
    assert all(srv._jobs[j].status == DONE for j in ids)
    assert after.get("bucket.table_builds", 0) == before.get(
        "bucket.table_builds", 0)
    assert after.get("fleet.executable_builds", 0) - before.get(
        "fleet.executable_builds", 0) == 2
