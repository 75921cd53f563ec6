"""Durability of the port's fleet (cup3d_tpu_torch/fleet/journal.py,
server.recover, migrate.py) on the CPU, and its journal against the JAX
package's.

- a crash drill: a server process killed at a K-boundary by
  ``server.crash`` (exit 23) after a journaled snapshot; ``recover()`` in
  a fresh server finishes every job with QoI bytes equal to a
  never-crashed run;
- a journal written by the JAX package's crashed server, recovered and
  finished by the port, and the reverse: the lanes within the JAX
  package's fleet bounds of the other package's never-crashed drain;
- ``migrate_job`` between two port servers and ``drain_for_shutdown``:
  the migrated job's QoI bytes equal to the never-migrated run;
- the journal's segment frame and reject taxonomy, and a one-shot
  ``journal.write_fail`` absorbed by the write guard's retry."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cup3d_tpu.fleet.server import FleetServer as JFleetServer
from cup3d_tpu.resilience import faults as jax_faults
from cup3d_tpu_torch.fleet import migrate as MIG
from cup3d_tpu_torch.fleet.journal import MAGIC, JobJournal
from cup3d_tpu_torch.fleet.server import DONE, MIGRATED, FleetServer
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.resilience import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KE_RTOL = 1e-4
VEL_ATOL = 1e-4
TIME_RTOL = 1e-4

#: 32 steps = 4 dispatches of K = 8; the snapshot lands at dispatch 2
#: (CUP3D_SNAP_EVERY 16), the crash at dispatch 3
SPECS = [dict(kind="tgv", n=16, nsteps=32, cfl=0.3),
         dict(kind="tgv", n=16, nsteps=24, cfl=0.25)]
CRASH = "server.crash@3"

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread_no_faults():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()
    torch.set_num_threads(n)


def _crashed(workdir, package: str) -> None:
    """Drain SPECS in a child process of ``package`` armed with the
    crash; it must die at the K-boundary with exit code 23."""
    if package == "jax":
        boot = ("import jax\njax.config.update('jax_platforms', 'cpu')\n"
                "from cup3d_tpu.fleet.server import FleetServer\n"
                "kw = {}\n")
    else:
        boot = ("import torch\ntorch.set_num_threads(1)\n"
                "from cup3d_tpu_torch.fleet.server import FleetServer\n"
                "kw = {'device': 'cpu'}\n")
    code = boot + textwrap.dedent(f"""
        srv = FleetServer(workdir={str(workdir)!r}, **kw)
        for i, sp in enumerate({SPECS!r}):
            srv.submit(f"tenant-{{i}}", sp)
        srv.drain()
        raise SystemExit(0)
        """)
    env = dict(os.environ, CUP3D_FAULT=CRASH, PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 23, proc.stderr[-2000:]


def _never_crashed(package: str, tmp_factory):
    if package not in _CACHE:
        tmp = tmp_factory.mktemp(f"control_{package}")
        if package == "jax":
            srv = JFleetServer(workdir=str(tmp))
        else:
            srv = FleetServer(workdir=str(tmp), device="cpu")
        ids = [srv.submit(f"tenant-{i}", dict(sp))
               for i, sp in enumerate(SPECS)]
        srv.drain()
        _CACHE[package] = (srv, ids)
    return _CACHE[package]


def _recover(cls, workdir, **kw):
    srv = cls(workdir=str(workdir), **kw)
    stats = srv.recover()
    srv.drain()
    return srv, stats


def test_crash_recover_bitwise(tmp_path, tmp_path_factory):
    """Killed at dispatch 3, recovered from the dispatch-2 snapshots:
    every job done with the never-crashed QoI bytes."""
    _crashed(tmp_path, "port")
    srv, stats = _recover(FleetServer, tmp_path, device="cpu")
    assert stats["resumed"] == 2 and stats["replayed"] == 2
    ctl, ids = _never_crashed("port", tmp_path_factory)
    for jid in ids:
        assert srv.poll(jid)["status"] == DONE
        assert srv._jobs[jid].qoi_bytes() == ctl._jobs[jid].qoi_bytes()
    # recovery is idempotent: replaying again changes nothing
    assert srv.recover()["replayed"] == 0
    assert srv.health()["durability"]["recovered"]["replayed"] == 0


def _assert_rows_close(a_srv, b_srv, ids):
    for jid in ids:
        assert a_srv.poll(jid)["status"] == DONE
        ra, rb = a_srv._jobs[jid].rows, b_srv._jobs[jid].rows
        assert ra.shape == rb.shape
        np.testing.assert_allclose(ra[:, -3:], rb[:, -3:], rtol=TIME_RTOL)
        la = {k: np.asarray(v) for k, v in a_srv.lane_state(jid).items()}
        lb = {k: np.asarray(v) for k, v in b_srv.lane_state(jid).items()}
        ke_a = float(np.sum(la["vel"].astype(np.float64) ** 2))
        ke_b = float(np.sum(lb["vel"].astype(np.float64) ** 2))
        assert abs(ke_a - ke_b) <= KE_RTOL * ke_b
        np.testing.assert_allclose(la["vel"], lb["vel"], rtol=0,
                                   atol=VEL_ATOL)


def test_jax_journal_recovered_by_port(tmp_path, tmp_path_factory):
    """The JAX server's crash journal, replayed by the port: its lanes
    resume from the JAX snapshots (host numpy carries) and finish within
    the bounds of the JAX package's never-crashed drain."""
    _crashed(tmp_path, "jax")
    srv, stats = _recover(FleetServer, tmp_path, device="cpu")
    assert stats["resumed"] == 2
    ctl, ids = _never_crashed("jax", tmp_path_factory)
    _assert_rows_close(srv, ctl, ids)


def test_port_journal_recovered_by_jax(tmp_path, tmp_path_factory):
    """The port's crash journal, replayed by the JAX package's server:
    the lanes finish within the bounds of the port's never-crashed
    drain."""
    _crashed(tmp_path, "port")
    srv, stats = _recover(JFleetServer, tmp_path)
    assert stats["resumed"] == 2
    ctl, ids = _never_crashed("port", tmp_path_factory)
    _assert_rows_close(srv, ctl, ids)


def test_migrate_job_and_drain_for_shutdown(tmp_path, tmp_path_factory):
    """A RUNNING job checkpointed off server A at a K-boundary and
    finished on server B ends with the never-migrated QoI bytes; then A
    drains for shutdown into B."""
    ctl, cids = _never_crashed("port", tmp_path_factory)
    a = FleetServer(workdir=str(tmp_path / "a"), device="cpu")
    b = FleetServer(workdir=str(tmp_path / "b"), device="cpu")
    ids = [a.submit(f"tenant-{i}", dict(sp)) for i, sp in enumerate(SPECS)]
    moved = {}

    def feed(server, tick):
        if tick == 1:
            moved["id"] = MIG.migrate_job(a, b, ids[0])
        if tick == 2:
            moved["drain"] = MIG.drain_for_shutdown(a, b)
            return False
        return True

    a.serve(feed)
    b.drain()
    assert a.poll(ids[0])["status"] == MIGRATED
    assert moved["drain"]["migrated"] == [ids[1]]
    assert a.draining
    for jid in ids:
        assert b.poll(jid)["status"] == DONE
        assert b._jobs[jid].qoi_bytes() == ctl._jobs[jid].qoi_bytes()
    assert b.migrations == 2


def test_journal_frame_rejects_and_write_retry(tmp_path):
    """Segments carry the JAX package's frame; corrupt ones are counted
    and skipped; a one-shot write fault is absorbed by the retry."""
    j = JobJournal(str(tmp_path / "j"))
    faults.arm("journal.write_fail", "*", 1)
    s0 = M.snapshot()
    path = j.append("submit", job_id="job-0001", tenant="t",
                    spec={"kind": "tgv", "nsteps": 8}, nsteps=8)
    d = M.delta(s0)
    assert path is not None
    assert d["resilience.write_retries{site=fleet-journal}"] == 1
    with open(path, "rb") as f:
        assert f.read().startswith(MAGIC)
    bad = os.path.join(j.root, "0000000099.jrec")
    with open(bad, "wb") as f:
        f.write(b"not a segment")
    s0 = M.snapshot()
    view = j.replay()
    d = M.delta(s0)
    assert list(view) == ["job-0001"] and view["job-0001"]["status"] == \
        "queued"
    assert d["journal.rejects{reason=magic}"] == 1
    # the JAX package's journal reads the port's segment
    from cup3d_tpu.fleet.journal import JobJournal as JJournal

    jv = JJournal(j.root).replay()
    assert jv["job-0001"]["spec"] == {"kind": "tgv", "nsteps": 8}
