"""The port's device-time attribution (obs/profile.py) against the JAX
package's, on the CPU.

- ``parse_plan`` equal to the JAX package's over good and bad specs;
- with injected start and stop, both controllers open and close windows
  at the same steps;
- the JAX package's fixture (``tests/data/synthetic_profile.trace.json.gz``,
  an XLA-shaped capture) through both ``attribute`` functions: equal
  summaries;
- the port's kernel names land in the sections of their JAX
  counterparts;
- the Kineto-shaped fixture of the port's ``synthetic_trace``
  (``tests/data/synthetic_torch_profile.trace.json.gz``): the device-side
  annotation ranges and host ATen/python events never count, a kernel
  goes to the range that launched it (by correlation id) and not to the
  range open when it ran, and the sum invariant holds;
- a capture of the card (``tests/data/torch_profile_h100.trace.json.gz``,
  trimmed from chip_smoke.py phase 36) attributed with the invariant and
  nonzero BiCGSTAB sections;
- the ``kind="device"`` record passes both packages' schema checks;
- both drivers call ``on_step`` at the loop top and ``finish`` when they
  drain, and a real CPU window counts an empty capture and lands no
  device number."""

import gzip
import json
import os

import pytest

from cup3d_tpu.obs import profile as JP
from cup3d_tpu.obs import trace as JT
from cup3d_tpu_torch.obs import metrics as TM
from cup3d_tpu_torch.obs import profile as TP
from cup3d_tpu_torch.obs import trace as TT

DATA = os.path.join(os.path.dirname(__file__), "data")
JAX_FIXTURE = os.path.join(DATA, "synthetic_profile.trace.json.gz")
KINETO_FIXTURE = os.path.join(DATA, "synthetic_torch_profile.trace.json.gz")
H100_FIXTURE = os.path.join(DATA, "torch_profile_h100.trace.json.gz")

SPECS = [None, "", "0", "off", "none", "once", "once:0", "once:7",
         "every:1", "every:5", "every:0", "every:-3", "every:x", "once:x",
         "always", "every", "every:2:3"]


def test_parse_plan_equals_jax():
    for spec in SPECS:
        assert TP.parse_plan(spec) == JP.parse_plan(spec), spec
    before = TM.snapshot().get("profile.bad_plan", 0)
    bad = [s for s in SPECS if s not in (None, "", "0", "off", "none")
           and TP.parse_plan(s) is None]
    assert len(bad) == 7
    assert TM.snapshot()["profile.bad_plan"] == before + 7


def _recording(mod, plan, steps, tmp_path, tag, **kw):
    calls = []
    ctl = mod.CaptureController(
        plan=plan, directory=str(tmp_path / tag),
        sink=(TT if mod is TP else JT).TraceSink(enabled=False),
        start_fn=lambda d: calls.append(("start", os.path.basename(d))),
        stop_fn=lambda: calls.append(("stop",)), **kw)
    for s in steps:
        ctl.on_step(s)
    ctl.finish()
    return calls, ctl.windows


@pytest.mark.parametrize("plan,window,steps", [
    ("every:4", 2, range(13)), ("every:3", 1, range(0, 40, 2)),
    ("once:3", 100, range(8)), ("once", 1, range(5)),
    ("every:2", 3, range(0, 48, 8)), (None, 1, range(5)),
])
def test_controllers_open_windows_at_the_same_steps(plan, window, steps,
                                                    tmp_path):
    t = _recording(TP, plan, steps, tmp_path, "t", window_steps=window)
    j = _recording(JP, plan, steps, tmp_path, "j", window_steps=window)
    assert t == j
    if plan is not None:
        assert t[1] > 0


def test_jax_fixture_attribution_equals_jax():
    trace = TP.load_chrome_trace(JAX_FIXTURE)
    t = TP.attribute(trace, source=JAX_FIXTURE)
    j = JP.attribute(JP.load_chrome_trace(JAX_FIXTURE), source=JAX_FIXTURE)
    assert t.summary() == j.summary()
    assert t.events == j.events
    assert abs(sum(t.sections.values()) + t.other_ms - t.total_ms) < 1e-9
    sections = ["PoissonSolve"]
    assert TP.attribute(trace, sections=sections).summary() == \
        JP.attribute(trace, sections=sections).summary()


#: the port's kernels (as Kineto names them) and their JAX counterparts
PAIRS = [
    ("void (anonymous namespace)::k_update<float>(float const*)",
     "_k_update"),
    ("void (anonymous namespace)::k_update<__nv_bfloat16>(float*)",
     "_k_update"),
    ("void (anonymous namespace)::k_lap<float>(float const*)", "_k_lap"),
    ("void (anonymous namespace)::k_lap_amr<float>(float const*)", "_k_lap"),
    ("void (anonymous namespace)::k_axpy<float>(float const*)", "_k_axpy"),
    ("void (anonymous namespace)::k_finish<float>(float const*)",
     "_k_finish"),
    ("void (anonymous namespace)::k_getz_two<2, 1>(float const*)",
     "_k_getz_two"),
    ("void (anonymous namespace)::k_getz_tile<0, 2, 1>(float const*)",
     "_k_getz"),
    ("void (anonymous namespace)::k_getz_amr<2, 1>(float const*)",
     "_k_getz"),
    ("void (anonymous namespace)::k_ring_shift(char const*)",
     "ring_shift_dma"),
]


def test_port_kernel_names_land_in_their_jax_sections():
    for port, jax_name in PAIRS:
        want = JP._kernel_section(jax_name)
        assert want is not None
        assert TP._kernel_section(port) == want, port
    # a departure: the CG getZ kernel carries the getz fragment in the
    # port, where the JAX package's _cg_kernel carries none
    assert TP._kernel_section(
        "void (anonymous namespace)::k_getz_cg(float*)") == \
        "bicgstab.getz_lap"
    assert TP._kernel_section(
        "void (anonymous namespace)::k_frenet(float const*)") is None
    # the JAX package's own names keep their sections
    for _, frags in JP.KERNEL_SECTIONS:
        for frag in frags:
            assert TP._kernel_section(frag) == JP._kernel_section(frag)


def test_kineto_fixture_matches_generator_and_attributes(tmp_path):
    fresh = TP.write_synthetic_capture(str(tmp_path / "x.trace.json.gz"))
    with open(fresh, "rb") as a, open(KINETO_FIXTURE, "rb") as b:
        assert a.read() == b.read()
    trace = TP.load_chrome_trace(KINETO_FIXTURE)
    attr = TP.attribute(trace, source=KINETO_FIXTURE)
    assert attr.sections.keys() == TP.SYNTHETIC_SECTIONS.keys()
    for k, v in TP.SYNTHETIC_SECTIONS.items():
        assert attr.sections[k] == pytest.approx(v, abs=1e-12)
    assert attr.other_ms == pytest.approx(TP.SYNTHETIC_OTHER_MS, abs=1e-12)
    assert abs(sum(attr.sections.values()) + attr.other_ms
               - attr.total_ms) < 1e-9
    ev = trace["traceEvents"]
    ops = [e for e in ev if e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    # only the ops count: the gpu_user_annotation range over them, the
    # host ranges, ATen ops and python frames add nothing
    assert any(e.get("cat") == "gpu_user_annotation" for e in ev)
    assert attr.total_ms == pytest.approx(
        sum(e["dur"] for e in ops) / 1e3, abs=1e-12)
    assert len(attr.events) == len(ops)
    assert "aten::add" not in attr.sections
    assert not any(k.startswith("cup3d_tpu_torch/") for k in attr.sections)
    # the library add kernel ran while the writer thread's range was
    # open and after its launching range had closed: containment by its
    # own timestamp would give DumpWriter; its correlation gives the
    # range that launched it
    add = [e for e in ev if "CUDAFunctor_add" in e.get("name", "")
           and e.get("cat") == "kernel"][0]
    open_then = [e["name"] for e in ev if e.get("cat") == "user_annotation"
                 and e["ts"] <= add["ts"] <= e["ts"] + e["dur"]]
    assert open_then == ["DumpWriter"]
    got = [e["section"] for e in attr.events
           if "CUDAFunctor_add" in e["name"]]
    assert got == ["AdvectionDiffusion"]
    by = attr.kernels_by_section()
    assert sum(by["other"].values()) == 3
    assert any("k_frenet" in n for n in by["other"])


def test_h100_capture_attributes_with_the_invariant():
    trace = TP.load_chrome_trace(H100_FIXTURE)
    attr = TP.attribute(trace, source=H100_FIXTURE)
    assert abs(sum(attr.sections.values()) + attr.other_ms
               - attr.total_ms) < 1e-9
    for s in ("bicgstab.update", "bicgstab.getz_lap", "bicgstab.finish"):
        assert attr.sections.get(s, 0.0) > 0.0, (s, attr.sections)
    ops = [e for e in trace["traceEvents"]
           if str(e.get("cat", "")).lower() in TP.KINETO_DEVICE_CATS]
    assert len(attr.events) == len(ops) > 0
    assert attr.total_ms == pytest.approx(
        sum(e["dur"] for e in ops) / 1e3, rel=1e-12)
    # the card's kernels by their Kineto names
    names = {e["name"] for e in attr.events}
    assert any("k_update" in n for n in names)
    assert any("k_getz_two" in n for n in names)


def test_device_record_passes_both_schema_checks(tmp_path):
    sink = TT.TraceSink(enabled=True, directory=str(tmp_path))
    attr = TP.attribute(TP.load_chrome_trace(KINETO_FIXTURE))
    TP.merge_into_sink(sink, attr, window=(2, 4))
    sink.close()
    with open(sink.jsonl_path) as f:
        recs = [json.loads(x) for x in f if x.strip()]
    assert len(recs) == 1 and recs[0]["kind"] == "device"
    assert recs[0]["window"] == [2, 4]
    assert TT.validate_step_record(recs[0]) == []
    assert JT.validate_step_record(recs[0]) == []
    with open(sink.perfetto_path) as f:
        dev = [e for e in json.load(f)["traceEvents"]
               if e.get("pid") == TP.DEVICE_PID and e.get("ph") == "X"]
    assert len(dev) == len(attr.events)


class _Spy(TP.CaptureController):
    def __init__(self, **kw):
        self.steps, self.finishes = [], 0
        super().__init__(**kw)

    def on_step(self, step):
        self.steps.append(step)
        super().on_step(step)

    def finish(self):
        self.finishes += 1
        super().finish()


UNIFORM = ("-bpdx 2 -bpdy 2 -bpdz 2 -extent 6.283185307179586 "
           "-initCond taylorGreen -poissonSolver iterative -nu 1e-3 "
           "-dt 1e-3 -tend 0 -nsteps 3 -verbose 0 -device cpu")
AMR = ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 2 -levelStart 0 -Rtol 1e9 "
       "-Ctol 0 -extent 6.283185307179586 -initCond taylorGreen "
       "-poissonSolver iterative -nu 1e-3 -dt 1e-3 -tend 0 -nsteps 2 "
       "-verbose 0 -device cpu")


@pytest.mark.parametrize("argv,steps", [(UNIFORM, 3), (AMR, 2)],
                         ids=["uniform", "amr"])
def test_drivers_call_on_step_and_finish(argv, steps, tmp_path,
                                         monkeypatch):
    from cup3d_tpu_torch.__main__ import build_driver

    calls = []
    spy = _Spy(plan="once:1", window_steps=1, device="cpu",
               start_fn=lambda d: calls.append("start"),
               stop_fn=lambda: calls.append("stop"),
               sink=TT.TraceSink(enabled=False))
    monkeypatch.setattr(TP, "CONTROLLER", spy)
    d = build_driver((argv + f" -path4serialization {tmp_path}").split())
    assert d._obs_profile is spy
    assert spy.directory == os.path.join(str(tmp_path), "profile")
    assert spy.device == "cpu" or str(spy.device) == "cpu"
    d.init()
    d.simulate()
    assert spy.steps == list(range(steps))
    assert spy.finishes >= 1
    assert calls == ["start", "stop"] and spy.windows == 1


def test_cpu_window_counts_an_empty_capture(tmp_path):
    """A real torch.profiler window on the CPU: the capture is written
    gzipped, has no device track, lands no device number and no device
    record, and counts profile.empty_captures."""
    import torch

    sink = TT.TraceSink(enabled=True, directory=str(tmp_path / "trace"),
                        xla_annotate=True)
    ctl = TP.CaptureController(plan="once:1", window_steps=1,
                               directory=str(tmp_path / "prof"),
                               device="cpu", sink=sink)
    snap = TM.snapshot()
    before = snap.get("profile.empty_captures", 0)
    for step in range(3):
        ctl.on_step(step)
        with sink.annotation("PoissonSolve"):
            torch.ones(64) @ torch.ones(64)
    assert ctl.windows == 1 and not ctl.capturing
    files = TP.find_trace_files(str(tmp_path / "prof"))
    assert [os.path.basename(f) for f in files] == \
        ["window_0000001.trace.json.gz"]
    with open(files[0], "rb") as f:
        assert f.read(2) == b"\x1f\x8b"
    with gzip.open(files[0], "rt") as f:
        ev = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "user_annotation"
               and e.get("name") == "PoissonSolve" for e in ev)
    after = TM.snapshot()
    assert after["profile.empty_captures"] == before + 1
    for key in ("profile.capture_errors", "profile.parse_errors"):
        assert after.get(key, 0) == snap.get(key, 0)
    assert ctl.last_attribution is None
    new_gauges = {k for k in after if k.startswith("profile.device_ms")
                  and after[k] != snap.get(k)}
    assert not new_gauges
    sink.close()
    assert not os.path.exists(sink.jsonl_path)


def test_selftest_runs():
    TP.selftest()
