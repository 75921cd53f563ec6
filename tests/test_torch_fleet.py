"""The port's fleet server (cup3d_tpu_torch/fleet/) against the JAX
package's on the CPU: the uniform lanes and the serving semantics.

- two ``tgv`` lanes at 16^3 (CFL 0.3 and 0.25) and two ``fish`` lanes at
  32^3 (T 1.0 and 0.9) drained by both packages' FleetServer: per lane KE
  to 1e-4 relative, velocity to 1e-4 absolute, time and dt to 1e-4
  relative, the fish position to 1e-5 (the JAX package's own fleet
  bounds, tests/test_fleet.py);
- the same lanes against the port's solo K = 8 megaloop of the same spec;
- a NaN injected into one lane (``fleet.lane_nan``): the siblings bitwise
  equal to the unfaulted drain, the faulted lane rolled back as many
  times as the JAX server rolls it back, and done;
- a continuous-batching reseed leaves the other lane bitwise untouched;
- admission control (quota, backpressure), cancel of a running lane,
  byte-stable QoI fan-out, and the generation drain
  (``CUP3D_FLEET_CONTINUOUS=0``) against the continuous drain with no
  arrivals.

The JAX drains are cached at module scope (one per configuration)."""

import numpy as np
import pytest
import torch

from cup3d_tpu.fleet.server import FleetServer as JFleetServer
from cup3d_tpu.resilience import faults as jax_faults
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.fleet import batch as FB
from cup3d_tpu_torch.fleet.server import (
    CANCELLED,
    DONE,
    FleetAdmissionError,
    FleetServer,
)
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.sim.simulation import Simulation

# the JAX package's fleet bounds (tests/test_fleet.py)
KE_RTOL = 1e-4
VEL_ATOL = 1e-4
TIME_RTOL = 1e-4
POS_ATOL = 1e-5


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


def _tgv_spec(**kw):
    spec = dict(kind="tgv", n=16, nsteps=8, cfl=0.3)
    spec.update(kw)
    return spec


def _fish_spec(**kw):
    spec = dict(kind="fish", n=32, nsteps=8, cfl=0.3, L=0.3, T=1.0,
                xpos=0.5)
    spec.update(kw)
    return spec


TGV_SPECS = (_tgv_spec(cfl=0.3), _tgv_spec(cfl=0.25))
FISH_SPECS = (_fish_spec(T=1.0), _fish_spec(T=0.9))

_CACHE = {}


def _drain(cls, tmp, specs, **kw):
    srv = cls(workdir=str(tmp), **kw)
    ids = [srv.submit(f"tenant-{i}", dict(sp)) for i, sp in enumerate(specs)]
    srv.drain()
    return srv, ids


def _port(tmp, specs, **kw):
    return _drain(FleetServer, tmp, specs, device="cpu", **kw)


def _cached(name, tmp_factory, cls, specs, **kw):
    if name not in _CACHE:
        tmp = tmp_factory.mktemp(name)
        if cls is FleetServer:
            _CACHE[name] = _port(tmp, specs, **kw)
        else:
            _CACHE[name] = _drain(cls, tmp, specs, **kw)
    return _CACHE[name]


def _ke(vel):
    v = np.asarray(vel, np.float64)
    return float(np.mean(np.sum(v * v, axis=-1)))


def _lane(srv, job_id):
    return {k: np.asarray(v) for k, v in srv.lane_state(job_id).items()}


def _assert_lane_close(a, b):
    ke_a, ke_b = _ke(a["vel"]), _ke(b["vel"])
    assert abs(ke_a - ke_b) <= KE_RTOL * max(abs(ke_b), 1e-12)
    np.testing.assert_allclose(a["vel"], b["vel"], rtol=0, atol=VEL_ATOL)
    for k in ("time", "dt"):
        np.testing.assert_allclose(float(a[k]), float(b[k]),
                                   rtol=TIME_RTOL)


@pytest.mark.parametrize("kind", ["tgv", "fish"])
def test_lanes_match_jax_fleet(tmp_path_factory, kind):
    """Both packages' servers drain the same two lanes; every lane of the
    port within the JAX package's fleet bounds of the JAX lane, and the
    per-step rows' (umax, dt, time) chain alike."""
    specs = TGV_SPECS if kind == "tgv" else FISH_SPECS
    jsrv, jids = _cached(f"jax_{kind}", tmp_path_factory, JFleetServer,
                         specs)
    tsrv, tids = _cached(f"port_{kind}", tmp_path_factory, FleetServer,
                         specs)
    for jid, tid in zip(jids, tids):
        assert jsrv.poll(jid)["status"] == DONE
        assert tsrv.poll(tid)["status"] == DONE
        jl, tl = _lane(jsrv, jid), _lane(tsrv, tid)
        assert sorted(jl) == sorted(tl)
        for k in jl:
            assert jl[k].shape == tl[k].shape, k
            assert jl[k].dtype == tl[k].dtype, k
        _assert_lane_close(tl, jl)
        if kind == "fish":
            np.testing.assert_allclose(tl["rigid"][6:9], jl["rigid"][6:9],
                                       rtol=0, atol=POS_ATOL)
        jr, tr = jsrv._jobs[jid].rows, tsrv._jobs[tid].rows
        assert jr.shape == tr.shape
        np.testing.assert_allclose(tr[:, -3:], jr[:, -3:], rtol=TIME_RTOL)
    if kind == "fish":
        p0 = _lane(tsrv, tids[0])["rigid"][6:9]
        p1 = _lane(tsrv, tids[1])["rigid"][6:9]
        assert not np.allclose(p0, p1, atol=1e-9)


def _solo(tmp, spec):
    """The port's solo megaloop of one lane's spec (K = 8, the scan path
    the lane replicates)."""
    common = dict(bpdx=1, bpdy=1, bpdz=1, block_size=spec["n"],
                  levelMax=1, levelStart=0, CFL=spec["cfl"],
                  nsteps=spec["nsteps"], tend=0.0, rampup=0, scan_k=8,
                  pipelined=True, verbose=False, freqDiagnostics=0,
                  path4serialization=str(tmp))
    if spec["kind"] == "tgv":
        cfg = SimulationConfig(extent=2 * np.pi, nu=0.02,
                               initCond="taylorGreen", **common)
    else:
        cfg = SimulationConfig(
            extent=1.0, nu=1e-4, factory_content=(
                f"stefanfish L={spec['L']} T={spec['T']} "
                f"xpos={spec['xpos']}"), **common)
    d = Simulation(cfg, device="cpu")
    d.init()
    d.simulate()
    assert d._scan_k == 8
    return d


@pytest.mark.parametrize("kind", ["tgv", "fish"])
def test_lanes_match_port_solo_megaloop(tmp_path_factory, tmp_path, kind):
    """Each lane of the port's batch within the same bounds of the port's
    solo K = 8 megaloop of its spec."""
    specs = TGV_SPECS if kind == "tgv" else FISH_SPECS
    tsrv, tids = _cached(f"port_{kind}", tmp_path_factory, FleetServer,
                         specs)
    for i, (tid, spec) in enumerate(zip(tids, specs)):
        d = _solo(tmp_path / f"solo{i}", spec)
        lane = _lane(tsrv, tid)
        s = d.sim
        solo = {"vel": s.state["vel"].numpy(), "time": s.time, "dt": s.dt}
        _assert_lane_close(lane, solo)
        if kind == "fish":
            np.testing.assert_allclose(
                lane["rigid"][6:9], np.asarray(s.obstacles[0].position),
                rtol=0, atol=POS_ATOL)


def test_lane_nan_isolated_bitwise(tmp_path):
    """``fleet.lane_nan`` armed at lane 1 once: lanes 0 and 2 bitwise
    equal to the unfaulted drain, lane 1 rolled back (as many times as
    the JAX server rolls it back for the same arm) and done."""
    specs = [_tgv_spec(cfl=0.3, nsteps=12), _tgv_spec(cfl=0.28, nsteps=12),
             _tgv_spec(cfl=0.25, nsteps=12)]
    ref, ref_ids = _port(tmp_path / "ref", specs, snap_every=4)
    faults.arm("fleet.lane_nan", 1, 1)
    s0 = M.snapshot()
    flt, flt_ids = _port(tmp_path / "flt", specs, snap_every=4)
    d = M.delta(s0)
    for lane in (0, 2):
        a = ref._jobs[ref_ids[lane]].batch.carry
        b = flt._jobs[flt_ids[lane]].batch.carry
        for k in a:
            assert torch.equal(a[k][lane], b[k][lane]), k
        assert (ref._jobs[ref_ids[lane]].qoi_bytes()
                == flt._jobs[flt_ids[lane]].qoi_bytes())
    assert flt.poll(flt_ids[1])["status"] == DONE
    assert flt.poll(flt_ids[1])["steps_done"] == 12
    assert np.isfinite(_lane(flt, flt_ids[1])["vel"]).all()
    rollbacks = d["fleet.lane_rollbacks{reason=nan-velocity}"]

    jax_faults.arm("fleet.lane_nan", 1, 1)
    jflt, _ = _drain(JFleetServer, tmp_path / "jflt", specs, snap_every=4)
    assert rollbacks == sum(b.guard.rollbacks for b in jflt.batches) == 1
    assert flt.health()["rollbacks"] == rollbacks


def test_reseed_does_not_touch_other_lanes(tmp_path):
    """Lane 0 retires after one dispatch and a late job is reseeded into
    it at the K-boundary: lanes 1 and 2 stay leaf for leaf, and byte for
    byte in their QoI, those of the serve that never reseeds; the late
    job completes on the reused lane (the JAX package's test of it)."""
    specs = [_tgv_spec(nsteps=8, cfl=0.3), _tgv_spec(nsteps=9, cfl=0.25),
             _tgv_spec(nsteps=9, cfl=0.28)]
    ref, rid = _port(tmp_path / "ref", specs)
    srv = FleetServer(workdir=str(tmp_path / "srv"), device="cpu")
    ids = [srv.submit(f"tenant-{i}", sp) for i, sp in enumerate(specs)]
    late = {}

    def feed(server, tick):
        if "id" not in late and server.poll(ids[0])["status"] == DONE:
            late["id"] = server.submit("late", _tgv_spec(nsteps=8, cfl=0.2))
        return "id" not in late

    s0 = M.snapshot()
    srv.serve(feed)
    d = M.delta(s0)
    assert srv.reseeds == 1 and d["fleet.reseeds{kind=tgv}"] == 1
    assert srv.poll(late["id"])["status"] == DONE
    assert srv._jobs[late["id"]].lane == srv._jobs[ids[0]].lane == 0
    for jid, ref_jid in zip(ids[1:], rid[1:]):
        assert srv.poll(jid)["status"] == DONE
        mine, theirs = srv.lane_state(jid), ref.lane_state(ref_jid)
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])
        assert srv._jobs[jid].qoi_bytes() == ref._jobs[ref_jid].qoi_bytes()
    # the upload itself: a new carry, one lane's rows written, the old
    # carry (held by the stream and the rollback snapshot) unchanged
    carry = srv.batches[0].carry
    before = {k: v.clone() for k, v in carry.items()}
    solo = {k: torch.ones_like(v[0]) for k, v in carry.items()
            if k != FB.LEFT}
    new = FB.reseed_lane_carry(carry, 0, solo, 5)
    for k in carry:
        assert torch.equal(carry[k], before[k]), k
        assert torch.equal(new[k][1:], carry[k][1:]), k
    assert int(new[FB.LEFT][0]) == 5
    assert torch.equal(new["vel"][0], torch.ones_like(new["vel"][0]))


def test_admission_quota_and_backpressure(tmp_path):
    srv = FleetServer(workdir=str(tmp_path / "q"), tenant_quota=1,
                      device="cpu")
    srv.submit("a", _tgv_spec())
    with pytest.raises(FleetAdmissionError) as e:
        srv.submit("a", _tgv_spec())
    assert e.value.reason == "quota"
    srv.submit("b", _tgv_spec())
    srv2 = FleetServer(workdir=str(tmp_path / "d"), max_queue_depth=2,
                       device="cpu")
    srv2.submit("a", _tgv_spec())
    srv2.submit("a", _tgv_spec())
    with pytest.raises(FleetAdmissionError) as e:
        srv2.submit("a", _tgv_spec())
    assert e.value.reason == "queue-full"
    adm = srv2.health()["admission"]
    assert adm["backpressure"] is True and adm["queue_depth"] == 2
    with pytest.raises(ValueError):
        srv2.submit("a", dict(kind="warp-drive", nsteps=4))


def test_cancel_running_lane(tmp_path):
    """Cancelling a RUNNING job freezes its lane at a K-boundary; the
    other lane finishes bitwise as it would have."""
    specs = [_tgv_spec(cfl=0.3, nsteps=16), _tgv_spec(cfl=0.25, nsteps=16)]
    ref, ref_ids = _port(tmp_path / "ref", specs)
    srv = FleetServer(workdir=str(tmp_path / "c"), device="cpu")
    ids = [srv.submit(f"t{i}", sp) for i, sp in enumerate(specs)]

    def feed(server, tick):
        if tick == 1:
            assert server.cancel(ids[0]) is True
        return tick < 1

    srv.serve(feed)
    assert srv.poll(ids[0])["status"] == CANCELLED
    assert 0 < srv.poll(ids[0])["steps_done"] < 16
    assert srv.poll(ids[1])["status"] == DONE
    assert (srv._jobs[ids[1]].qoi_bytes()
            == ref._jobs[ref_ids[1]].qoi_bytes())
    assert srv.cancel(ids[1]) is False


def test_qoi_fanout_byte_stable_and_generation_drain(tmp_path,
                                                     tmp_path_factory):
    """Two identical drains give bitwise-identical per-tenant QoI
    buffers, and the generation drain (continuous off) gives the
    continuous drain's bytes when nothing arrives."""
    a, a_ids = _cached("port_tgv", tmp_path_factory, FleetServer,
                       TGV_SPECS)
    b, b_ids = _port(tmp_path / "b", TGV_SPECS)
    g, g_ids = _port(tmp_path / "g", TGV_SPECS, continuous=False)
    for x, y, z in zip(a_ids, b_ids, g_ids):
        ja = a._jobs[x]
        assert ja.rows.shape == (8, FB.TGV_ROW)
        assert np.isfinite(ja.rows).all()
        assert ja.qoi_bytes() == b._jobs[y].qoi_bytes()
        assert ja.qoi_bytes() == g._jobs[z].qoi_bytes()
    assert a._jobs[a_ids[0]].qoi_bytes() != a._jobs[a_ids[1]].qoi_bytes()
    assert g.health()["scheduler"]["continuous"] is False


def test_lanes_with_per_lane_fields_match_their_solo_drains(tmp_path):
    """Jobs whose specs differ only in CFL and step budget share a batch,
    each with a driver of its own as in the JAX package; each lane gives
    the rows it gives drained alone."""
    srv, ids = _port(tmp_path / "a", [_tgv_spec(cfl=0.3),
                                      _tgv_spec(cfl=0.25, nsteps=9),
                                      _tgv_spec(cfl=0.28, nsteps=8)])
    assert srv.jobs_by_status() == {DONE: 3}
    assert len(srv.batches) == 1
    for spec, jid in zip(TGV_SPECS, ids):
        alone, aid = _port(tmp_path / f"alone{spec['cfl']}", [spec])
        want = alone._jobs[aid[0]].rows
        np.testing.assert_allclose(srv._jobs[jid].rows[:len(want)], want,
                                   rtol=TIME_RTOL)
