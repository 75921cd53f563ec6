"""The port's fleet observability against the JAX package's, on the CPU:
obs/metrics.py's log-bucket histograms and rolling baseline, obs/trace.py's
records, sink and step span, obs/federate.py's in-process half, the flight
recorder's job events, the fleet mesh refused on one card, and the
``fleet`` CLI's output keys.

- the histogram functions equal to the JAX package's on seeded inputs,
  exactly;
- a traced port fleet drain and a traced port driver run: their
  ``trace.jsonl`` and Perfetto export pass the JAX package's
  tools/trace_check.py validators (the test imports them; the port does
  not);
- ``python -m cup3d_tpu_torch fleet | fleet slo | fleet why`` print the
  JAX CLI's keys."""

import io
import json
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from cup3d_tpu.obs import history as JH
from cup3d_tpu.obs import metrics as JM
from cup3d_tpu.obs import trace as JT
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.fleet.server import DONE, FleetServer
from cup3d_tpu_torch.obs import federate as TF
from cup3d_tpu_torch.obs import flight as TFL
from cup3d_tpu_torch.obs import metrics as TM
from cup3d_tpu_torch.obs import trace as TT
from cup3d_tpu_torch.parallel import topology as topo
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.sim.simulation import Simulation

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import trace_check  # noqa: E402  (the JAX package's validator)

SPEC = dict(kind="tgv", n=16, nsteps=8, cfl=0.3)


@pytest.fixture(autouse=True)
def _one_thread_no_faults():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear()
    yield
    faults.clear()
    torch.set_num_threads(n)


def test_histograms_equal_jax_exactly():
    rng = np.random.default_rng(11)
    vals = np.concatenate([10.0 ** rng.uniform(-7, 5, 500),
                           [0.0, 1e-5, 1e3, 2e3, -1.0]])
    assert TM.BUCKET_BOUNDS == JM.BUCKET_BOUNDS
    assert [TM.bucket_index(v) for v in vals] == \
        [JM.bucket_index(v) for v in vals]
    th = [TM.Histogram("x", {"k": str(i)}) for i in range(3)]
    jh = [JM.Histogram("x", {"k": str(i)}) for i in range(3)]
    for i, v in enumerate(vals):
        th[i % 3].observe(float(v))
        jh[i % 3].observe(float(v))
    for a, b in zip(th, jh):
        assert a.bucket_counts == b.bucket_counts
        assert a.sample() == b.sample()
        assert a.cumulative_buckets() == b.cumulative_buckets()
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert TM.merged_quantile(th, q) == JM.merged_quantile(jh, q)
        assert th[0].quantile(q) == jh[0].quantile(q)
        assert (TM.quantile_from_buckets(th[1].bucket_counts, th[1].count,
                                         th[1].min, th[1].max, q)
                == JM.quantile_from_buckets(jh[1].bucket_counts,
                                            jh[1].count, jh[1].min,
                                            jh[1].max, q))
    TM.histogram("fam.test", a="1").observe(0.5)
    assert any(h.name == "fam.test" for h in TM.histograms("fam.test"))
    TM.counter("fam.count", a="1").inc()
    assert [c.name for c in TM.counters("fam.count")] == ["fam.count"]


def test_trace_schema_and_history_equal_jax():
    assert TT.SCHEMA_VERSION == JT.SCHEMA_VERSION
    assert TT.JOB_EVENTS == JT.JOB_EVENTS
    assert TT.JOB_PHASES == JT.JOB_PHASES
    assert TT.PHASE_OF_EVENT == JT.PHASE_OF_EVENT
    assert (TT.LANE_PID, TT.SHARD_PID, TT.COMPILE_PID) == \
        (JT.LANE_PID, JT.SHARD_PID, JT.COMPILE_PID)
    rng = np.random.default_rng(5)
    names = list(JT.JOB_EVENTS)
    ev = [(names[i % len(names)], float(t))
          for i, t in enumerate(np.cumsum(rng.uniform(0, 1, 17)))]
    assert TT.phase_decomposition(ev) == JT.phase_decomposition(ev)
    rec = TT.job_record("job-0001", "t", "done", 8, ev, bucket="b")
    rec["schema"] = TT.SCHEMA_VERSION
    rec["phases"] = TT.phase_decomposition(ev)
    assert TT.validate_step_record(rec) == JT.validate_step_record(rec) == []
    sh = TT.shard_record(1, 3, 0.5, 1.2, straggler=True)
    sh["schema"] = TT.SCHEMA_VERSION
    assert JT.validate_step_record(sh) == []
    series = list(rng.uniform(0, 1, 40))
    for w in (1, 5, 32):
        assert TM.rolling_baseline(series, window=w) == \
            JH.rolling_baseline(series, window=w)


def test_federation_in_process_and_flight_job_events(tmp_path):
    """Two in-process registries federate: counters sum, histograms merge
    bucket-wise to the quantile of one registry holding both; a dead
    HTTP peer is counted, not raised, the merged view renders as
    Prometheus text, and the straggler watch raises (ROADMAP queue A
    item 5).  The fleet notes terminal jobs into the live flight
    recorders."""
    r1, r2, both = (TM.MetricsRegistry() for _ in range(3))
    rng = np.random.default_rng(2)
    for v in rng.uniform(0.001, 10, 200):
        r1.histogram("fleet.job_e2e_s", tenant="a").observe(float(v))
        both.histogram("fleet.job_e2e_s", tenant="a").observe(float(v))
    for v in rng.uniform(0.001, 10, 100):
        r2.histogram("fleet.job_e2e_s", tenant="a").observe(float(v))
        both.histogram("fleet.job_e2e_s", tenant="a").observe(float(v))
    r1.counter("fleet.submits").inc(3)
    r2.counter("fleet.submits").inc(4)
    view = TF.merge_snapshots([TF.local_snapshot(r1, process=0),
                               TF.local_snapshot(r2, process=1)])
    assert view.counters["fleet.submits"] == 7
    for q in (0.5, 0.99):
        assert view.quantile("fleet.job_e2e_s", q, tenant="a") == \
            TM.merged_quantile(both.histograms("fleet.job_e2e_s"), q)
    dead = "http://127.0.0.1:1"
    fed = TF.Federation(peers=[dead])
    before = TM.snapshot().get(f"federate.scrape_errors{{peer={dead}}}", 0)
    assert len(fed.collect()) == 1
    assert TM.snapshot()[f"federate.scrape_errors{{peer={dead}}}"] == \
        before + 1
    from cup3d_tpu_torch.obs import export as TX

    text = TX.parse_prometheus_text(view.render_prometheus())
    assert text[("cup3d_fleet_submits", frozenset())] == 7
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        TF.StragglerWatch()

    fr = TFL.FlightRecorder(directory=str(tmp_path))
    srv = FleetServer(workdir=str(tmp_path / "w"), device="cpu")
    jid = srv.submit("acme", dict(SPEC))
    srv.drain()
    assert any(e["job_id"] == jid and e["status"] == DONE
               for e in fr.job_events)
    path = fr.trigger("test")
    post = TFL.load_postmortem(path)
    assert post["job_events"] and "mesh" in post


def _traced(tmp_path, fn):
    TT.TRACE.configure(enabled=True, directory=str(tmp_path))
    try:
        fn()
        TT.TRACE.flush()
        TT.TRACE.export_chrome()
    finally:
        TT.TRACE.close()
        TT.TRACE.configure(enabled=False)
    jsonl = os.path.join(str(tmp_path), "trace.jsonl")
    records = trace_check.validate_jsonl(jsonl)
    trace_check.roundtrip_chrome(records, jsonl)
    with open(os.path.join(str(tmp_path), "trace.pfto.json")) as f:
        chrome = json.load(f)
    steps = sum(1 for r in records if r.get("kind", "step") == "step")
    trace_check._check_chrome(chrome, "port export", steps)
    return records, chrome


def test_fleet_trace_passes_trace_check(tmp_path):
    """A traced drain: one job record per job (with its phases), lane
    occupancy spans on pid 3, all accepted by the JAX validators."""
    def drain():
        srv = FleetServer(workdir=str(tmp_path / "w"), device="cpu")
        for c in (0.3, 0.25, 0.28):
            srv.submit("acme", dict(SPEC, cfl=c))
        srv.drain()

    records, chrome = _traced(tmp_path / "t", drain)
    jobs = [r for r in records if r.get("kind") == "job"]
    assert len(jobs) == 3 and all("phases" in r for r in jobs)
    lanes = [e for e in chrome["traceEvents"]
             if e.get("pid") == TT.LANE_PID and e.get("ph") == "X"]
    assert len(lanes) >= 3


def test_driver_step_spans_pass_trace_check(tmp_path):
    """The drivers' step span (StepObserver.step round each advance)."""
    cfg = SimulationConfig(bpdx=2, bpdy=2, bpdz=2, levelMax=1, levelStart=0,
                           extent=2 * np.pi, CFL=0.3, nu=0.02, nsteps=3,
                           tend=0.0, rampup=0, initCond="taylorGreen",
                           verbose=False, freqDiagnostics=0,
                           path4serialization=str(tmp_path / "w"))

    def run():
        d = Simulation(cfg, device="cpu")
        d.init()
        d.simulate()

    records, _ = _traced(tmp_path / "t", run)
    steps = [r for r in records if r.get("kind", "step") == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]


def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        with pytest.raises(SystemExit) as e:
            main(argv)
    return e.value.code, json.loads(buf.getvalue())


@pytest.mark.parametrize("mode", ["", "slo", "why"])
def test_fleet_cli_keys_match_jax(tmp_path, mode):
    from cup3d_tpu.__main__ import main as jmain
    from cup3d_tpu_torch.__main__ import main as tmain

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"scenarios": [dict(SPEC, tenant="acme")],
                                "lanes": 4}))
    head = ["fleet"] + ([mode] if mode else [])
    args = ["--scenarios", str(spec)]
    jc, jout = _cli(jmain, head + args + ["--workdir", str(tmp_path / "j")])
    tc, tout = _cli(tmain, head + args + ["--workdir", str(tmp_path / "t"),
                                          "--device", "cpu"])
    assert jc == tc == 0
    assert sorted(jout) == sorted(tout)
    if not mode:
        assert sorted(jout["acme"]) == sorted(tout["acme"])
        assert tout["acme"]["statuses"] == {DONE: 1}
        assert sorted(jout["acme"]["jobs"][0]) == \
            sorted(tout["acme"]["jobs"][0])
    elif mode == "slo":
        assert sorted(jout["slo"]) == sorted(tout["slo"])
        assert sorted(jout["slo"]["tenants"]["acme"]) == \
            sorted(tout["slo"]["tenants"]["acme"])
    else:
        assert sorted(jout["tenants"]["acme"]) == \
            sorted(tout["tenants"]["acme"])
    # the aot mode runs (aot/cli.py); with no store it exits as the JAX
    # package's does
    with pytest.raises(SystemExit, match="no store"):
        tmain(["aot", "list"])


def test_fleet_mesh_is_refused_naming_a8b(tmp_path, monkeypatch):
    """The fleet's lanes cut into shards across cards are ROADMAP A8b: on
    one card ``CUP3D_FLEET_MESH=1`` raises, and ``fleet --mesh`` reports
    the unsharded batch."""
    from cup3d_tpu_torch.__main__ import main as tmain

    monkeypatch.setenv("CUP3D_FLEET_MESH", "1")
    monkeypatch.setenv("CUP3D_MESH", "2x1")
    with pytest.raises(NotImplementedError, match="A8b"):
        FleetServer(workdir=str(tmp_path / "s"), device="cpu")
    monkeypatch.delenv("CUP3D_FLEET_MESH")
    srv = FleetServer(workdir=str(tmp_path / "s"), device="cpu")
    assert srv.health()["mesh"] == topo.mesh_state(None)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"scenarios": [dict(SPEC, tenant="acme")]}))
    err = io.StringIO()
    with redirect_stdout(io.StringIO()):
        with redirect_stderr(err):
            with pytest.raises(SystemExit) as e:
                tmain(["fleet", "--scenarios", str(spec), "--mesh",
                       "--workdir", str(tmp_path / "c"), "--device", "cpu"])
    assert e.value.code == 0
    line = next(x for x in err.getvalue().splitlines() if x.startswith("{"))
    assert json.loads(line) == topo.mesh_state(None)
