"""The port's QoI stream (cup3d_tpu_torch/stream/qoi.py) held to the
JAX package's: each test runs the same emissions through both packages'
QoIStream and checks tests/test_stream.py's expectations on both (FIFO
order, values through groups, bounded staleness under backpressure, the
in-flight limit of a kick, pack slimming, the ``stream.stall`` seam and
abandon), then the pipelined driver's counters in the metrics registry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cup3d_tpu.obs import metrics as jax_metrics
from cup3d_tpu.resilience import faults as jax_faults
from cup3d_tpu.stream.qoi import PackPolicy as JPackPolicy
from cup3d_tpu.stream.qoi import QoIStream as JQoIStream
from cup3d_tpu_torch.obs import metrics as torch_metrics
from cup3d_tpu_torch.resilience import faults as torch_faults
from cup3d_tpu_torch.stream.qoi import PackPolicy, QoIStream

PKGS = {
    "jax": (JQoIStream, JPackPolicy, jax_faults, jax_metrics,
            lambda a: jnp.asarray(a, jnp.float32)),
    "torch": (QoIStream, PackPolicy, torch_faults, torch_metrics,
              lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    jax_faults.clear()
    torch_faults.clear()
    yield
    jax_faults.clear()
    torch_faults.clear()


def _entry(arr, i, size=3):
    return {"layout": [("val", size)], "pack": arr(np.full(size, float(i))),
            "idx": i}


def _vals(e):
    v = e.get("vals")
    if v is None:
        p = e["pack"]
        v = (p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p))
    return np.asarray(v, np.float64)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fifo_consume_ordering(pkg):
    Stream, _, _, _, arr = PKGS[pkg]
    seen = []
    st = Stream(lambda e: seen.append(e["idx"]), read_every=2,
                max_inflight=1)
    for i in range(11):
        st.emit(_entry(arr, i))
    st.flush()
    assert seen == list(range(11))
    assert not st
    assert st.stats["packs_consumed"] == 11


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_values_roundtrip_through_groups(pkg):
    Stream, _, _, _, arr = PKGS[pkg]
    got = {}
    st = Stream(lambda e: got.__setitem__(e["idx"], _vals(e)), read_every=3,
                max_inflight=2)
    for i in range(10):
        st.emit(_entry(arr, i))
    st.flush()
    for i in range(10):
        np.testing.assert_allclose(got[i], float(i))
    assert st.stats["groups_started"] >= 3
    assert st.stats["bytes_streamed"] >= 3 * 3 * 3 * 4


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_bounded_staleness_under_backpressure(pkg, monkeypatch):
    """Readiness polling off (every group reports not landed): progress
    only through emit()'s backpressure, at most max_inflight groups in
    flight, no entry staler than (1 + max_inflight) * read_every, and
    the same consumption sequence in both packages."""
    Stream, _, _, _, arr = PKGS[pkg]
    read_every, max_inflight = 2, 2
    consumed, when = [], []
    st = Stream(lambda e: consumed.append(e["idx"]), read_every=read_every,
                max_inflight=max_inflight)
    monkeypatch.setattr(Stream, "_ready", staticmethod(lambda batch: False))
    bound = (1 + max_inflight) * read_every
    for i in range(25):
        st.emit(_entry(arr, i))
        assert len(st._inflight) <= max_inflight
        assert len(st.queue) < read_every
        newest = consumed[-1] + 1 if consumed else 0
        assert i - newest < bound
        when.append(len(consumed))
    assert st.stats["groups_read"] > 0
    assert st.stats["stall_s"] >= 0.0 and st.stats["read_s"] == 0.0
    st.flush()
    assert consumed == list(range(25))
    # consumed packs after each emission: a group of 2 is read when the
    # third group needs its place
    assert when == [0] * 5 + [2 * ((i - 3) // 2) for i in range(5, 25)]


def test_reset_stats_matches_the_jax_stream():
    """emit -> reset_stats -> emit: both packages' snapshots agree at each
    stage (the timed-window boundary of the JAX package's bench); the
    reset zeroes the counters and keeps the packs queued and in flight."""
    snaps = {}
    for pkg in ("jax", "torch"):
        Stream, _, _, _, arr = PKGS[pkg]
        seen = []
        st = Stream(lambda e: seen.append(e["idx"]), read_every=2,
                    max_inflight=2)
        monkey = staticmethod(lambda batch: False)  # reads at backpressure
        Stream._ready, saved = monkey, Stream.__dict__["_ready"]
        try:
            for i in range(5):
                st.emit(_entry(arr, i))
            first = st.snapshot()
            st.reset_stats()
            reset = st.snapshot()
            for i in range(5, 9):
                st.emit(_entry(arr, i))
            second = st.snapshot()
            st.flush()
        finally:
            Stream._ready = saved
        assert seen == list(range(9))
        snaps[pkg] = [{k: v for k, v in s.items()
                       if not k.endswith("_s")} for s in
                      (first, reset, second)]
        assert reset["packs_emitted"] == 0 and reset["groups_read"] == 0
        assert reset["groups_inflight"] == first["groups_inflight"] > 0
    assert snaps["torch"] == snaps["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_kick_respects_inflight_limit(pkg):
    Stream, _, _, _, arr = PKGS[pkg]
    st = Stream(lambda e: None, read_every=4, max_inflight=1)
    st.emit(_entry(arr, 0))
    st._inflight.append({"batch": None, "group": []})  # saturate
    st.kick()
    assert len(st._inflight) == 1
    assert len(st.queue) == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pack_slimming_roundtrip(pkg):
    """A slim pack (scalars only) carries the full pack's QoI values;
    the dropped full-field part never ships."""
    Stream, Policy, _, _, arr = PKGS[pkg]
    rng = np.random.default_rng(0)
    big = rng.random(5000)

    def run(policy):
        got = {}

        def consume(e):
            v, off = _vals(e), 0
            for name, size in e["layout"]:
                got[name] = np.array(v[off:off + size])
                off += size

        st = Stream(consume, read_every=1, policy=policy)
        dtype = jnp.float32 if pkg == "jax" else torch.float32
        st.emit(st.pack_parts([("rigid", arr(np.arange(19.0))),
                               ("scores", arr(big)),
                               ("umax", arr([7.0]))], dtype, step=0))
        st.flush()
        return got, st.stats

    full, fs = run(Policy())
    slim, ss = run(Policy.for_cells(256 ** 3))
    assert set(full) == {"rigid", "scores", "umax"}
    assert set(slim) == {"rigid", "umax"}
    for k in slim:
        np.testing.assert_array_equal(slim[k], full[k])
    assert ss["parts_dropped"] == 1 and ss["bytes_dropped"] == 5000 * 4
    assert fs["bytes_streamed"] - ss["bytes_streamed"] == 5000 * 4


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stream_stall_site_and_abandon(pkg):
    """stream.stall fires at the emit seam; abandon() drops queued work
    without consuming it."""
    Stream, _, faults, M, arr = PKGS[pkg]
    seen = []
    st = Stream(lambda e: seen.append(e), read_every=100,
                name="resilience-test")
    s0 = M.snapshot()
    faults.arm("stream.stall", 2, 1)
    for i in range(4):
        e = _entry(arr, i, size=1)
        e["step"] = i
        st.emit(e)
    assert M.delta(s0)["faults.injected{site=stream.stall}"] == 1
    assert len(st.queue) == 4 and not seen
    st.abandon()
    assert not st.queue and not seen
    assert st.stats["packs_abandoned"] == 4
    st.flush()
    assert not seen


def test_pipelined_driver_counts_in_the_registry(tmp_path):
    """A pipelined run's stream shows in obs.metrics.snapshot() under the
    JAX package's keys, stream.<key>{stream=qoi}: every step's pack
    emitted and consumed, in groups."""
    from cup3d_tpu_torch.config import SimulationConfig
    from cup3d_tpu_torch.sim.simulation import Simulation

    s0 = torch_metrics.snapshot()
    d = Simulation(SimulationConfig(
        bpdx=1, bpdy=1, bpdz=1, levelMax=1, nsteps=9, tend=0.0,
        initCond="taylorGreen", pipelined=True, verbose=False,
        freqDiagnostics=0, path4serialization=str(tmp_path)), device="cpu")
    d.init()
    d.simulate()
    delta = torch_metrics.delta(s0)
    assert delta["stream.packs_emitted{stream=qoi}"] == 9
    assert delta["stream.packs_consumed{stream=qoi}"] == 9
    assert delta["stream.groups_read{stream=qoi}"] >= 2
    assert len(d.step_log) == 9 and not d._pack_reader
