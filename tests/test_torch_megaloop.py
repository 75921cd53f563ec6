"""Pipelined stepping and the K-step megaloop of the port
(cup3d_tpu_torch/sim/simulation.py, sim/megaloop.py,
models/fish/device_midline.py) against the JAX package on the same
seeded state, at small size on the CPU:

- the device midline against JAX's at a frozen 32^3 gait, the gait
  carried across by ``sim.data.gait_from_numpy``;
- pipelined 16^3 Taylor-Green with the host dt chain (dtDevice 0) against
  the JAX pipelined driver, and with the device dt chain (dtDevice 1)
  against the JAX per-step policy it reproduces (the JAX uniform driver
  has no device dt chain: the JAX config's dtDevice describes the
  non-pipelined one-step-lag policy);
- the TGV megaloop: K = 1 against K = 8 bitwise (as JAX holds itself,
  tests/test_megaloop.py), K = 8 against JAX, and a JAX megaloop carry
  continued by the port (``sim.data.load_scan_carry_numpy``);
- the fish megaloop at 32^3 (tests/test_megaloop.py's _fish_cfg): K = 1
  against K = 8 within JAX's own KE bound, the port against JAX;
- the same fish pipelined per step against the JAX pipelined driver, and
  then continued as megaloops on the same driver (the bench's order);
- a fault inside a megaloop rolls back and completes; the step-budget
  tail falls back to the per-step loop.

The packs' reads trail the stepping by a timing the platform decides, so
the pipelined comparisons pin both streams to backpressure-only reads
(``_ready`` False): then both packages consume at the same emissions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cup3d_tpu.config import SimulationConfig as JConfig
from cup3d_tpu.resilience import faults as jax_faults
from cup3d_tpu.sim.simulation import Simulation as JSimulation
from cup3d_tpu.stream.qoi import QoIStream as JQoIStream
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.sim import data as tdata
from cup3d_tpu_torch.sim.simulation import Simulation
from cup3d_tpu_torch.stream.qoi import QoIStream

from test_torch_jax_twins import argv, jax_driver

# per-step (umax, dt, time), relative: f32 arithmetic in another order
ROW_RTOL = 1e-5
# the fish megaloop, port against JAX: position and velocity against
# their scale, KE relative (the ROADMAP's lane-vs-solo bound)
FISH_RTOL = 1e-4
# midline arrays against their max magnitude
MIDLINE_RTOL = 1e-5


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


def _tgv(C, tmp, **kw):
    base = dict(bpdx=2, bpdy=2, bpdz=2, levelMax=1, levelStart=0,
                extent=2 * np.pi, CFL=0.3, nu=0.02, nsteps=16, tend=0.0,
                rampup=0, initCond="taylorGreen", pipelined=True,
                verbose=False, freqDiagnostics=0,
                path4serialization=str(tmp))
    base.update(kw)
    return C(**base)


def _fish(C, tmp, **kw):
    base = dict(bpdx=1, bpdy=1, bpdz=1, levelMax=1, levelStart=0,
                block_size=32, extent=1.0, CFL=0.3, nu=1e-4, nsteps=8,
                tend=0.0, rampup=0,
                factory_content="stefanfish L=0.3 T=1.0 xpos=0.5",
                dtype="float32", pipelined=True, verbose=False,
                freqDiagnostics=0, path4serialization=str(tmp))
    base.update(kw)
    return C(**base)


def _run_port(cfg):
    d = Simulation(cfg, device="cpu")
    d.init()
    d.simulate()
    return d


def _run_jax(cfg):
    d = JSimulation(cfg)
    d.init()
    d.simulate()
    return d


def _ke(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    v = v.astype(np.float64)
    return float(np.mean(np.sum(v * v, axis=-1)))


def _jax_rows(d):
    """(umax, dt, time after the step) of each step of a JAX run, from its
    flight ring (a per-step record's umax is the one its dt used, t its
    start; a megaloop row's are the step's own)."""
    recs = [r for r in d.flight.steps if "dt" in r and "scan_k" not in r]
    if recs and recs[0].get("scan"):
        return np.array([[r["umax"], r["dt"], r["t"]] for r in recs])
    return np.array([[r["dt"], r["t"] + r["dt"]] for r in recs])


def _port_rows(d, with_umax=True):
    cols = ("umax", "dt", "end") if with_umax else ("dt", "end")
    return np.array([[r["time"] + r["dt"] if c == "end" else r[c]
                      for c in cols] for r in d.step_log])


# -- the device midline ----------------------------------------------------


def test_device_midline_matches_jax(tmp_path):
    """midline_state_device at a frozen 32^3 gait, JAX's gait carried into
    the port, for three (t, dt, qint): r, v, nor, vnor, width, height and
    the new internal quaternion within 1e-5 of their max magnitude; the
    port's own freeze_gait gives JAX's gait."""
    from cup3d_tpu.models.fish import device_midline as jdm
    from cup3d_tpu_torch.models.fish import device_midline as tdm

    body = "stefanfish L=0.3 T=1.0 xpos=0.5 ypos=0.515625 zpos=0.515625"
    j = JSimulation(_fish(JConfig, tmp_path, factory_content=body))
    j.init()
    t = Simulation(_fish(SimulationConfig, tmp_path, factory_content=body),
                   device="cpu")
    t.init()
    job, tob = j.sim.obstacles[0], t.sim.obstacles[0]
    assert jdm.device_midline_eligible(job)
    assert tdm.device_midline_eligible(tob)
    jg = jdm.freeze_gait(job, 0.0, jnp.float32)
    tg = tdm.freeze_gait(tob, 0.0, torch.float32)
    gait = tdata.gait_from_numpy(
        {k: np.asarray(v) if not isinstance(v, float) else v
         for k, v in jg.items()}, torch.float32, "cpu")
    assert set(tg) == set(gait)
    for k in tg:
        a, b = tg[k], gait[k]
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        else:
            assert a == pytest.approx(b, rel=1e-12, abs=1e-15), k
    rng = np.random.default_rng(0)
    for t_, dt in ((0.0, 1e-3), (0.37, 2e-3), (0.81, 5e-4)):
        q = rng.normal(size=4)
        q = (q / np.linalg.norm(q)).astype(np.float32)
        jm, jq = jdm.midline_state_device(
            jg, jnp.asarray(t_, jnp.float32), jnp.asarray(dt, jnp.float32),
            jnp.asarray(q))
        tm, tq = tdm.midline_state_device(
            gait, torch.tensor(t_), torch.tensor(dt), torch.as_tensor(q))
        for k in ("r", "v", "nor", "vnor", "width", "height"):
            want = np.asarray(jm[k], np.float64)
            got = tm[k].numpy().astype(np.float64)
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(got - want).max() <= MIDLINE_RTOL * scale, (k, t_)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                                   atol=MIDLINE_RTOL)


def test_frenet_recurrence_matches_jax_and_its_wrapper_rules():
    """The Frenet recurrence's plain version against JAX's lax.scan on the
    curvature of a 41-point midline; on CPU tensors the wrapper takes the
    plain version and counts no launch, and kernels=True raises."""
    from cup3d_tpu.models.fish import device_midline as jdm
    from cup3d_tpu_torch.models.fish import device_midline as tdm

    rng = np.random.default_rng(3)
    rs = np.cumsum(rng.uniform(0.004, 0.01, 41)).astype(np.float32)
    k = (5.0 * np.sin(np.linspace(0, 6, 41))).astype(np.float32)
    dk = (30.0 * np.cos(np.linspace(0, 6, 41))).astype(np.float32)
    want = jdm._frenet_scan_dev(jnp.asarray(rs), jnp.asarray(k),
                                jnp.asarray(dk))
    tdm.launches["frenet"] = 0
    args = tuple(torch.as_tensor(a) for a in (rs, k, dk))
    got = tdm._frenet_scan_dev(*args)
    assert tdm.launches["frenet"] == 0
    for name in ("r", "v", "nor", "vnor", "bin", "vbin"):
        w = np.asarray(want[name], np.float64)
        assert np.abs(got[name].numpy() - w).max() <= (
            MIDLINE_RTOL * max(np.abs(w).max(), 1e-30)), name
    with pytest.raises(ValueError, match="CUDA"):
        tdm._frenet_scan_dev(*args, kernels=True)


# -- pipelined Taylor-Green ------------------------------------------------


@pytest.mark.parametrize("dt_device", [0, 1])
def test_pipelined_tgv_matches_jax(tmp_path, monkeypatch, dt_device):
    """16^3 Taylor-Green, iterative Poisson, pipelined: per-step (umax, dt,
    time) within 1e-5 relative of the JAX run, iterations +-1."""
    for cls in (JQoIStream, QoIStream):
        monkeypatch.setattr(cls, "_ready", staticmethod(lambda b: False))
    nsteps = 12
    d = jax_driver("uniform", tmp_path / "jax", nsteps)
    d.cfg.pipelined = dt_device == 0
    d.flight.residuals.clear()
    d.flight.steps.clear()
    try:
        d.simulate()
    finally:
        d.cfg.pipelined = False
    want = _jax_rows(d)
    want_iters = [r["iters"] for r in d.flight.residuals]
    from cup3d_tpu_torch.__main__ import build_driver

    t = build_driver(argv("uniform", tmp_path / "port", nsteps)
                     + ["-pipelined", "1", "-dtDevice", str(dt_device),
                        "-device", "cpu"])
    t.init()
    assert t._dt_chain == (dt_device == 1)
    t.simulate()
    assert t.sim.step == nsteps and len(t.step_log) == nsteps
    got = _port_rows(t, with_umax=False)
    np.testing.assert_allclose(got, want[:, -2:], rtol=ROW_RTOL)
    iters = [r["iters"] for r in t.step_log]
    assert len(iters) == len(want_iters) == nsteps
    assert max(abs(a - b) for a, b in zip(iters, want_iters)) <= 1
    # max|u|: the one each step's dt used (host chain), or the one each
    # step measured, which the next step's dt uses (device chain)
    jumax = np.array([r["umax"] for r in d.flight.steps])
    if dt_device == 0:
        got = np.array([r["umax"] for r in t.flight.steps])
        np.testing.assert_allclose(got, jumax, rtol=ROW_RTOL)
    else:
        got = np.array([r["umax"] for r in t.step_log])
        np.testing.assert_allclose(got[:-1], jumax[1:], rtol=ROW_RTOL)


# -- the TGV megaloop -------------------------------------------------------


def test_tgv_megaloop_k1_vs_k8_bitwise_and_against_jax(tmp_path):
    a = _run_port(_tgv(SimulationConfig, tmp_path / "k1", scan_k=1))
    b = _run_port(_tgv(SimulationConfig, tmp_path / "k8", scan_k=8))
    assert a._scan_k == 1 and b._scan_k == 8
    assert a.sim.step == b.sim.step == 16
    for k in ("vel", "p"):
        assert torch.equal(a.sim.state[k], b.sim.state[k]), k
    assert a.sim.time == b.sim.time and a.sim.dt == b.sim.dt
    assert all(r["scan"] for r in b.step_log) and len(b.step_log) == 16
    j = _run_jax(_tgv(JConfig, tmp_path / "jax", scan_k=8))
    np.testing.assert_allclose(_port_rows(b), _jax_rows(j), rtol=ROW_RTOL)
    assert _ke(b.sim.state["vel"]) == pytest.approx(
        _ke(j.sim.state["vel"]), rel=ROW_RTOL)


def test_jax_megaloop_carry_continues_in_the_port(tmp_path):
    """One JAX megaloop of K = 8, its carry carried into the port: the
    port's next megaloop gives the JAX one's rows."""
    j = JSimulation(_tgv(JConfig, tmp_path / "jax", scan_k=8))
    j.init()
    assert j._scan_ready()
    j.advance_megaloop()
    j.flush_packs()
    carry = tdata.scan_carry_to_numpy(j._scan_carry)
    j.advance_megaloop()
    j.flush_packs()
    want = _jax_rows(j)[8:]
    t = Simulation(_tgv(SimulationConfig, tmp_path / "port", scan_k=8),
                   device="cpu")
    t.init()
    assert t._scan_ready()
    tdata.load_scan_carry_numpy(t, carry)
    t.sim.step = 8
    t.advance_megaloop()
    t.flush_packs()
    np.testing.assert_allclose(_port_rows(t), want, rtol=ROW_RTOL)
    np.testing.assert_allclose(t.sim.state["vel"].numpy(),
                               np.asarray(j.sim.state["vel"]), rtol=0,
                               atol=ROW_RTOL)


# -- the fish megaloop ------------------------------------------------------


def test_fish_megaloop_k1_vs_k8_and_against_jax(tmp_path):
    a = _run_port(_fish(SimulationConfig, tmp_path / "k1", scan_k=1))
    b = _run_port(_fish(SimulationConfig, tmp_path / "k8", scan_k=8))
    assert a._scan_k == 1 and b._scan_k == 8
    assert a.sim.step == b.sim.step == 8
    ke_a, ke_b = _ke(a.sim.state["vel"]), _ke(b.sim.state["vel"])
    assert abs(ke_a - ke_b) <= 1e-6 * max(abs(ke_a), 1e-12)
    for name in ("position", "transVel"):
        np.testing.assert_allclose(getattr(a.sim.obstacles[0], name),
                                   getattr(b.sim.obstacles[0], name),
                                   rtol=0, atol=1e-6)
    j = _run_jax(_fish(JConfig, tmp_path / "jax", scan_k=8))
    jo, to = j.sim.obstacles[0], b.sim.obstacles[0]
    for name in ("position", "transVel", "angVel", "quaternion"):
        want = np.asarray(getattr(jo, name), np.float64)
        got = np.asarray(getattr(to, name), np.float64)
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= FISH_RTOL * scale, name
    assert ke_b == pytest.approx(_ke(j.sim.state["vel"]), rel=FISH_RTOL)
    np.testing.assert_allclose(_port_rows(b), _jax_rows(j), rtol=FISH_RTOL)


# pipelined per-step fish steps, then megaloops on the same driver (the
# bench's order: bench_fish_uniform's steps, then _megaloop_split)
FISH_STEPS, FISH_K, FISH_LOOPS = 12, 4, 2
_jax_fish = {}


def _jax_dt_end(d):
    """(dt, time after the step) of each step of a JAX run, from its
    flight ring: a per-step record's t is its start, a megaloop row's
    its end."""
    recs = [r for r in d.flight.steps if "dt" in r and "scan_k" not in r]
    return np.array([[r["dt"], r["t"] if r.get("scan") else r["t"] + r["dt"]]
                     for r in recs])


def _fish_state(d):
    ob = d.sim.obstacles[0]
    out = {k: np.asarray(getattr(ob, k), np.float64)
           for k in ("position", "transVel", "angVel", "quaternion")}
    out["ke"] = _ke(d.sim.state["vel"])
    return out


def _assert_fish_state(got, want):
    """Position, velocities and quaternion within 1e-4 of their scale, KE
    within 1e-4 relative."""
    for k, w in want.items():
        if k == "ke":
            assert got[k] == pytest.approx(w, rel=FISH_RTOL)
        else:
            scale = max(np.abs(w).max(), 1e-12)
            assert np.abs(got[k] - w).max() <= FISH_RTOL * scale, k


def _jax_fish_pipelined(tmp):
    """The JAX fish at 32^3, pipelined: FISH_STEPS per-step steps (state
    A, after a flush), then FISH_LOOPS megaloops of K = FISH_K on the same
    driver, the mirrors flushed before the first as bench.py does (state
    B).  Computed once a process."""
    if not _jax_fish:
        j = JSimulation(_fish(JConfig, tmp, scan_k=FISH_K,
                              nsteps=FISH_STEPS + FISH_K * FISH_LOOPS))
        j.init()
        for _ in range(FISH_STEPS):
            j.advance(j.calc_max_timestep())
        j.flush_packs()
        _jax_fish["a"] = _fish_state(j)
        _jax_fish["a_rows"] = _jax_dt_end(j)
        assert j._scan_ready()
        for _ in range(FISH_LOOPS):
            j.advance_megaloop()
        j.flush_packs()
        _jax_fish["b"] = _fish_state(j)
        _jax_fish["b_rows"] = _jax_dt_end(j)
    return _jax_fish


def _port_fish_pipelined(tmp):
    t = Simulation(_fish(SimulationConfig, tmp, scan_k=FISH_K,
                         nsteps=FISH_STEPS + FISH_K * FISH_LOOPS),
                   device="cpu")
    t.init()
    for _ in range(FISH_STEPS):
        t.advance(t.calc_max_timestep())
    return t


def _pin_streams(monkeypatch):
    for cls in (JQoIStream, QoIStream):
        monkeypatch.setattr(cls, "_ready", staticmethod(lambda b: False))


def test_pipelined_fish_matches_jax(tmp_path, monkeypatch):
    """32^3 fish, pipelined per-step stepping (the stale-max|u| margin and
    body-speed floor, the 1.03x growth bound, the device-chained rigid
    state, uinf and centre of mass): per-step dt and time within 1e-5
    relative of the JAX pipelined driver; after a flush the rigid state
    and KE within 1e-4 of their scale."""
    _pin_streams(monkeypatch)
    want = _jax_fish_pipelined(tmp_path / "jax")
    t = _port_fish_pipelined(tmp_path / "port")
    assert t.sim.obstacles[0]._dev_rigid is not None  # the chain ran
    t.flush_packs()
    assert len(t.step_log) == FISH_STEPS
    np.testing.assert_allclose(_port_rows(t, with_umax=False),
                               want["a_rows"], rtol=ROW_RTOL)
    _assert_fish_state(_fish_state(t), want["a"])


def test_megaloop_continues_a_pipelined_fish_as_jax(tmp_path, monkeypatch):
    """The bench's order on one driver: pipelined per-step steps, then
    megaloops with no flush in between (advance_megaloop drains the stream
    before it seeds its carry from the mirrors): the rows and the final
    rigid state and KE as JAX's."""
    _pin_streams(monkeypatch)
    want = _jax_fish_pipelined(tmp_path / "jax")
    t = _port_fish_pipelined(tmp_path / "port")
    assert t._pack_reader.queue or t._pack_reader._inflight  # mirrors trail
    assert t._scan_ready()
    for _ in range(FISH_LOOPS):
        t.advance_megaloop()
    t.flush_packs()
    assert [r.get("scan", False) for r in t.step_log] == (
        [False] * FISH_STEPS + [True] * (FISH_K * FISH_LOOPS))
    np.testing.assert_allclose(_port_rows(t, with_umax=False),
                               want["b_rows"], rtol=ROW_RTOL)
    _assert_fish_state(_fish_state(t), want["b"])


# -- recovery and the per-step tail ----------------------------------------


def test_fault_inside_a_megaloop_rolls_back_and_completes(tmp_path,
                                                          monkeypatch):
    """step.nan_velocity armed at step 6, inside the second K = 4
    megaloop: detection at the row's consumption, one rollback to the
    K-aligned snapshot, the run completes with a decaying field and the
    megaloop resumes after the retried steps."""
    monkeypatch.setenv("CUP3D_SNAP_EVERY", "4")
    ref = _run_port(_tgv(SimulationConfig, tmp_path / "ref", scan_k=4))
    faults.arm("step.nan_velocity", 6, 1)
    s0 = M.snapshot()
    d = _run_port(_tgv(SimulationConfig, tmp_path / "flt", scan_k=4))
    delta = M.delta(s0)
    assert d.sim.step == 16
    assert delta["resilience.rollbacks"] == 1
    assert delta.get("resilience.giveups", 0) == 0
    ke = _ke(d.sim.state["vel"])
    assert np.isfinite(ke) and _ke(ref.sim.state["vel"]) <= ke <= 0.26
    assert d.sim.time <= ref.sim.time
    scans = [r["step"] for r in d.flight.steps if r.get("scan")]
    assert scans and max(scans) == 15


def test_megaloop_tail_falls_back_to_the_per_step_loop(tmp_path):
    d = _run_port(_tgv(SimulationConfig, tmp_path, scan_k=4, nsteps=10))
    assert d.sim.step == 10
    recs = list(d.flight.steps)
    assert [r["step"] for r in recs if r.get("scan")] == list(range(8))
    assert [r["step"] for r in recs if not r.get("scan")] == [8, 9]
    # the JAX driver's gates: no megaloop without pipelined stepping or
    # with a time stop
    for kw in (dict(pipelined=False), dict(tend=0.5, nsteps=0),
               dict(dt=1e-3)):
        t = Simulation(_tgv(SimulationConfig, tmp_path, scan_k=4, **kw),
                       device="cpu")
        t.init()
        j = JSimulation(_tgv(JConfig, tmp_path, scan_k=4, **kw))
        j.init()
        assert t._scan_k == j._scan_k == 0, kw


def test_pipelined_refuses_roll_correction_as_jax_does(tmp_path):
    """Roll correction mutates angVel on the host after the 6x6 solve: no
    device rigid chain, so both packages' init() refuse it pipelined."""
    body = "stefanfish L=0.3 T=1.0 xpos=0.5 CorrectRoll=1"
    for Sim, C, kw in ((Simulation, SimulationConfig, {"device": "cpu"}),
                       (JSimulation, JConfig, {})):
        d = Sim(_fish(C, tmp_path, factory_content=body), **kw)
        with pytest.raises(ValueError, match="roll"):
            d.init()
