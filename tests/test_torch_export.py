"""The port's exporter (obs/export.py) and HTTP federation
(obs/federate.py) against the JAX package's, on the CPU over loopback.

- the same registry contents rendered by both packages give byte-equal
  exposition text (histograms, NaN and +-Inf, escaped labels) and parse
  back to equal dicts;
- the five endpoints of the port's exporter, with ``/health``'s keys
  equal to the JAX package's;
- a port coordinator whose peer is a JAX exporter, and a JAX coordinator
  whose peer is the port's exporter, merge to equal counter sums and
  exactly equal quantiles;
- ``ensure_exporter`` off by default, a bad port and a bind failure
  counted;
- ``FlightRecorder.armed`` equal to the JAX package's across dumps."""

import json
import math
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from cup3d_tpu.obs import export as JX
from cup3d_tpu.obs import federate as JF
from cup3d_tpu.obs import flight as JFL
from cup3d_tpu.obs import metrics as JM
from cup3d_tpu_torch.obs import export as TX
from cup3d_tpu_torch.obs import federate as TF
from cup3d_tpu_torch.obs import flight as TFL
from cup3d_tpu_torch.obs import metrics as TM

PATHS = ("/metrics", "/health", "/federate", "/metrics/federated",
         "/health/federated")


def _fill(reg, seed=0, scale=1.0):
    """The same contents into a registry of either package."""
    rng = np.random.default_rng(seed)
    reg.counter("fleet.submits", tenant="acme").inc(3)
    reg.counter("export.scrapes", path="metrics").inc(2)
    reg.gauge("profile.device_ms", section="bicgstab.update").set(1.25)
    reg.gauge("profile.device_ms", section="other").set(0.0)
    reg.gauge("odd.values", kind="nan").set(float("nan"))
    reg.gauge("odd.values", kind="pinf").set(float("inf"))
    reg.gauge("odd.values", kind="minf").set(float("-inf"))
    reg.gauge("escaped", label='a"b\\c\nd').set(-2.5e-7)
    for v in scale * 10.0 ** rng.uniform(-6, 4, 300):
        reg.histogram("fleet.job_e2e_s", tenant="a").observe(float(v))
    for v in rng.uniform(0, 50, 40):
        reg.histogram("poisson.iters_hist", driver="amr").observe(float(v))
    reg.histogram("empty.hist").observe(float("inf"))


def _nan_safe(d):
    return {k: (repr(v) if isinstance(v, float) and math.isnan(v) else v)
            for k, v in d.items()}


def test_exposition_byte_equal_and_parses_back():
    tr, jr = TM.MetricsRegistry(), JM.MetricsRegistry()
    _fill(tr)
    _fill(jr)
    assert tr.snapshot().keys() == jr.snapshot().keys()
    t_text = TX.render_prometheus(tr.snapshot(), tr.histograms())
    j_text = JX.render_prometheus(jr.snapshot(), jr.histograms())
    assert t_text.encode() == j_text.encode()
    for tok in ("NaN", "+Inf", "-Inf", "_bucket{", "_sum", "_count",
                '\\"', "\\\\", "\\n", "# TYPE cup3d_fleet_job_e2e_s histogram"):
        assert tok in t_text, tok
    assert _nan_safe(TX.parse_prometheus_text(t_text)) == \
        _nan_safe(JX.parse_prometheus_text(j_text))
    assert TX.parse_histograms(t_text) == JX.parse_histograms(j_text)
    # the untyped form of an explicit flat dict too
    flat = {"a.b{x=1}": 1.0, "c": float("nan")}
    assert TX.render_prometheus(flat) == JX.render_prometheus(flat)
    with pytest.raises(ValueError):
        TX.parse_prometheus_text("not a sample line at all {")
    for key in ("poisson.iters_hist{driver=amr}.count", "a.b", "x{k=v}"):
        assert TX.prometheus_key(key) == JX.prometheus_key(key)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _key_tree(obj, depth=2):
    if not isinstance(obj, dict) or depth == 0:
        return None
    return {k: _key_tree(v, depth - 1) for k, v in obj.items()}


def test_endpoints_over_loopback_and_health_keys_equal_jax(
        tmp_path, monkeypatch):
    monkeypatch.delenv("CUP3D_AOT_STORE", raising=False)
    monkeypatch.delenv("CUP3D_STRAGGLER_RATIO", raising=False)
    fr = TFL.FlightRecorder(directory=str(tmp_path))
    jfr = JFL.FlightRecorder(directory=str(tmp_path / "j"))
    ex = TX.MetricsExporter(port=0).start()
    try:
        assert ex.port > 0
        before = TM.snapshot()
        bodies = {}
        for path in PATHS:
            status, ctype, body = _get(ex.url + path)
            assert status == 200, path
            bodies[path] = (ctype, body)
        for path in ("/metrics", "/metrics/federated"):
            assert bodies[path][0].startswith("text/plain; version=0.0.4")
            TX.parse_prometheus_text(bodies[path][1].decode())
        health = json.loads(bodies["/health"][1])
        jhealth = JX.health_payload()
        assert health.keys() == jhealth.keys()
        for block in ("trace", "profile", "federation", "aot"):
            assert _key_tree(health[block]) == _key_tree(jhealth[block])
        assert health["aot"] == jhealth["aot"] == {"store": None}
        # the JAX process watch may hold walls from other tests: the
        # port's block is the one a fresh JAX watch gives
        assert health["stragglers"].keys() == jhealth["stragglers"].keys()
        assert health["stragglers"] == JF.StragglerWatch().health()
        mine = [f for f in health["flight_recorders"]
                if f["directory"] == str(tmp_path)]
        assert len(mine) == 1 and mine[0]["armed"] is True
        assert mine[0].keys() == jhealth["flight_recorders"][0].keys()
        fed = json.loads(bodies["/federate"][1])
        assert fed["schema"] == TF.SNAPSHOT_SCHEMA == JF.SNAPSHOT_SCHEMA == 1
        fh = json.loads(bodies["/health/federated"][1])
        assert fh.keys() <= JF.merge_snapshots([fed]).health().keys()
        after = TM.snapshot()
        for path in PATHS:
            key = f"export.scrapes{{path={path.strip('/')}}}"
            assert after[key] == before.get(key, 0) + 1, key
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(ex.url + "/nope")
        assert e.value.code == 404
    finally:
        ex.stop()
        ex.stop()  # idempotent
    del fr, jfr


def _observe(reg, seed, n):
    rng = np.random.default_rng(seed)
    vals = 10.0 ** rng.uniform(-4, 2, n)
    for v in vals:
        reg.histogram("fleet.job_e2e_s", tenant="a").observe(float(v))
    reg.counter("fleet.submits").inc(n)
    reg.gauge("fleet.queue_depth").set(float(seed))
    return vals


def test_federation_across_packages_both_ways(monkeypatch):
    tr, jr = TM.MetricsRegistry(), JM.MetricsRegistry()
    _observe(tr, 1, 250)
    _observe(jr, 2, 170)
    both = JM.MetricsRegistry()
    _observe(both, 1, 250)
    _observe(both, 2, 170)
    # each process's /federate serves its own registry
    monkeypatch.setattr(TF.FED, "registry", tr)
    monkeypatch.setattr(JF.FED, "registry", jr)
    tex = TX.MetricsExporter(port=0).start()
    jex = JX.MetricsExporter(port=0).start()
    try:
        tview = TF.Federation(peers=[jex.url], registry=tr).view()
        jview = JF.Federation(peers=[tex.url], registry=jr).view()
    finally:
        tex.stop()
        jex.stop()
    assert len(tview.snapshots) == len(jview.snapshots) == 2
    assert tview.counters["fleet.submits"] == \
        jview.counters["fleet.submits"] == 420
    for q in (0.5, 0.9, 0.99, 1.0):
        want = JM.merged_quantile(both.histograms("fleet.job_e2e_s"), q)
        assert tview.quantile("fleet.job_e2e_s", q, tenant="a") == \
            jview.quantile("fleet.job_e2e_s", q, tenant="a") == want
    # the merged views render; both processes are rank 0 here, so the
    # summed counter is the sample the two renderings share
    ts = TX.parse_prometheus_text(tview.render_prometheus())
    js = JX.parse_prometheus_text(jview.render_prometheus())
    assert ts[("cup3d_fleet_submits", frozenset())] == \
        js[("cup3d_fleet_submits", frozenset())] == 420
    assert ts.keys() == js.keys()


def test_dead_peer_is_counted_not_raised():
    dead = "http://127.0.0.1:1"
    key = f"federate.scrape_errors{{peer={dead}}}"
    before = TM.snapshot().get(key, 0)
    assert TF._scrape_peer(dead, timeout=0.5) is None
    assert TM.snapshot()[key] == before + 1


def test_ensure_exporter_off_by_default(monkeypatch):
    monkeypatch.setattr(TX, "EXPORTER", None)
    monkeypatch.delenv("CUP3D_METRICS_PORT", raising=False)
    assert TX.ensure_exporter() is None
    monkeypatch.setenv("CUP3D_METRICS_PORT", "0")
    assert TX.ensure_exporter() is None
    monkeypatch.setenv("CUP3D_METRICS_PORT", "not-a-port")
    before = TM.snapshot().get("export.bad_port", 0)
    assert TX.ensure_exporter() is None
    assert TM.snapshot()["export.bad_port"] == before + 1
    assert TX.EXPORTER is None
    # a port already bound: counted, not raised
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        before = TM.snapshot().get("export.bind_errors", 0)
        assert TX.ensure_exporter(port=s.getsockname()[1]) is None
        assert TM.snapshot()["export.bind_errors"] == before + 1
    ex = TX.ensure_exporter(port=0)
    try:
        assert ex is not None and TX.ensure_exporter(port=0) is ex
        assert TM.snapshot()["export.port"] == float(ex.port)
    finally:
        ex.stop()


def test_flight_armed_equals_jax_across_dumps(tmp_path):
    t = TFL.FlightRecorder(directory=str(tmp_path / "t"), max_dumps=2)
    j = JFL.FlightRecorder(directory=str(tmp_path / "j"), max_dumps=2)
    seen = []
    for i in range(4):
        assert t.armed == j.armed
        seen.append(t.armed)
        for fr in (t, j):
            fr.record_step({"step": i, "t": 0.1 * i, "dt": 0.1})
            fr.trigger("test", extra={"step": i})
    assert t.armed == j.armed is False
    assert seen == [True, True, False, False]
    assert len(t.dumps_written) == len(j.dumps_written) == 2
