"""The port's runtime sanitizers (cup3d_tpu_torch/analysis/runtime.py)
against the JAX package's (cup3d_tpu/analysis/runtime.py) on the CPU.

One steady step of each configuration runs under both packages'
``no_implicit_transfers``, and the step's sanctioned transfer sites (the
multiset of ``TRANSFER_SITES`` tags it fired) must match exactly, apart
from the port-only tags of ``ALLOWLIST`` (the Krylov chunk read, the
pinned mirror uploads, the stream's group copy, ...): the uniform
Taylor-Green at 16^3 per step and pipelined (the host dt chain, both
streams read at backpressure only), the fish at 32^3 (BASELINE config #2
cut to size), the 8-block forest and a K = 4 megaloop.  The JAX fish
step is not clean under its own guard (``dt_eff = max(dt, 1e-12)`` with
a device dt, cup3d_tpu/models/fish/stefanfish.py:167, uploads a scalar
implicitly), so its side of that case counts its tags with the guard
off; counting does not depend on the guard.

On the CPU torch has no sync debug mode: the port's guard keeps the
allowlist and the counters there.  The mode itself is exercised with a
stand-in for ``torch.cuda``'s two calls (nesting and restore, and only
the sites that wait opening it), and on the card by chip_smoke.py's
sanitizer phase.  Also: an unknown tag under
an allowlist raises in both packages, the ``transfers.sanctioned``
counters, ``RecompileCounter`` (no build on a second step; the ``aot
probe`` JSON counts as the registry deltas did), and ``debug_nans``
raising ``FloatingPointError`` on a NaN-injected step in both packages,
naming the op, and naming the kernel at a launch wrapper."""

import json

import pytest
import torch

from cup3d_tpu.analysis import runtime as JR
from cup3d_tpu.__main__ import build_driver as jax_build_driver
from cup3d_tpu_torch.__main__ import build_driver
from cup3d_tpu_torch.analysis import runtime as R
from cup3d_tpu_torch.obs import metrics as M

from test_torch_jax_twins import argv, jax_driver

PIPE = ["-pipelined", "1", "-dtDevice", "0"]
MEGA = ["-pipelined", "1", "-scan_k", "4", "-freqDiagnostics", "0"]
#: the per-step cases: (twin kind, extra CLI flags, steps before the
#: compared one)
CASES = {"uniform": ("uniform", [], 2), "pipelined": ("uniform", PIPE, 2),
         "fish": ("fish", [], 2), "amr_tgv": ("amr", [], 2)}

_jax_extra = {}
#: the JAX package's tags (the first eight of the port's ALLOWLIST)
ALL_JAX = {t for t, s in R.ALLOWLIST.items() if s.jax is not None}


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _delta(sites, before):
    return {k: v - before.get(k, 0) for k, v in sites.items()
            if v - before.get(k, 0)}


def _step_tags(sites, guard, step, n):
    """The tags each of ``n`` steps fired, each under ``guard``."""
    out = []
    for _ in range(n):
        before = dict(sites)
        with guard():
            step()
        out.append(_delta(sites, before))
    return out


def _jax(kind, extra, tmp, nsteps):
    if not extra:
        return jax_driver(kind, tmp, nsteps)
    key = (kind, tuple(extra))
    if key not in _jax_extra:  # built once a process (compiles)
        d = jax_build_driver(argv(kind, tmp, nsteps) + extra)
        d.init()
        _jax_extra[key] = d
    return _jax_extra[key]


def _port(kind, extra, tmp, nsteps):
    d = build_driver(argv(kind, tmp, nsteps) + extra + ["-device", "cpu"])
    d.init()
    return d


def _no_reads_until_backpressure(*drivers):
    for d in drivers:
        d._pack_reader._ready = staticmethod(lambda batch: False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_fires_the_jax_packages_sites(tmp_path, case):
    kind, extra, warm = CASES[case]
    n = warm + 3
    jd = _jax(kind, extra, tmp_path, 10)
    pd = _port(kind, extra, tmp_path, 10)
    if "-pipelined" in extra:
        _no_reads_until_backpressure(jd, pd)
    # the JAX fish step trips its own guard (the module docstring)
    jguard = _Nothing if kind == "fish" else JR.no_implicit_transfers
    jtags = _step_tags(JR.TRANSFER_SITES, jguard,
                       lambda: jd.advance(jd.calc_max_timestep()), n)
    ptags = _step_tags(
        R.TRANSFER_SITES, lambda: R.no_implicit_transfers(device="cpu"),
        lambda: pd.advance(pd.calc_max_timestep()), n)
    ported = [{k: v for k, v in t.items() if k not in R.PORT_ONLY}
              for t in ptags]
    assert ported[warm:] == jtags[warm:], (ptags, jtags)
    assert set().union(*ptags) <= set(R.ALLOWLIST)
    assert all(ALL_JAX >= set(t) for t in jtags)


def test_megaloop_fires_the_jax_packages_sites(tmp_path):
    jd = _jax("uniform", MEGA, tmp_path, 16)
    pd = _port("uniform", MEGA, tmp_path, 16)
    out = {}
    for name, d, rt, guard in (
            ("jax", jd, JR, JR.no_implicit_transfers),
            ("port", pd, R, lambda: R.no_implicit_transfers(device="cpu"))):
        assert d._scan_ready()
        out[name] = _step_tags(rt.TRANSFER_SITES, guard, d.advance_megaloop,
                               3)
    ported = [{k: v for k, v in t.items() if k not in R.PORT_ONLY}
              for t in out["port"]]
    # the first dispatch seeds the carry (one more scan-carry-upload)
    assert ported == out["jax"] == [{"scan-carry-upload": 2},
                                    {"scan-carry-upload": 1},
                                    {"scan-carry-upload": 1}]
    assert all(t["krylov-chunk-read"] > 0 for t in out["port"])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_unknown_tag_under_an_allowlist_raises(pkg):
    rt = JR if pkg == "jax" else R
    guard = (rt.no_implicit_transfers(allow=["umax-read"]) if pkg == "jax"
             else rt.no_implicit_transfers(allow=["umax-read"],
                                           device="cpu"))
    with guard:
        with rt.sanctioned_transfer("umax-read"):
            pass
        with pytest.raises(RuntimeError, match="qoi-read"):
            with rt.sanctioned_transfer("qoi-read"):
                pass
    with rt.sanctioned_transfer("qoi-read"):  # no allowlist outside
        pass


class _FakeMode:
    """Stand-in for torch.cuda's sync debug mode on a CPU build."""

    def __init__(self):
        self.mode, self.sets = 0, []

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.sets.append(self.mode)


def test_guard_sets_the_mode_and_nested_blocks_restore(monkeypatch):
    fake = _FakeMode()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    with R.no_implicit_transfers(allow=R.ALLOWLIST, device="cuda"):
        assert fake.mode == 2
        with R.sanctioned_transfer("qoi-read"):
            assert fake.mode == 0
            with R.sanctioned_transfer("umax-read"):
                assert fake.mode == 0
            assert fake.mode == 0
        assert fake.mode == 2
        with R.no_implicit_transfers(allow=["dt-upload"], device="cuda"):
            assert fake.mode == 2
            with pytest.raises(RuntimeError, match="qoi-read"):
                with R.sanctioned_transfer("qoi-read"):
                    pass
        assert fake.mode == 2 and R._allowed_tags() == set(R.ALLOWLIST)
        with pytest.raises(ValueError):
            with R.no_implicit_transfers(device="cuda"):
                raise ValueError("the body's error passes through")
        assert fake.mode == 2
    assert fake.mode == 0 and R._allowed_tags() is None
    assert R._cuda_guards[0] == 0
    # outside any guard a sanctioned block leaves the mode alone
    n = len(fake.sets)
    with R.sanctioned_transfer("qoi-read"):
        pass
    assert len(fake.sets) == n


@pytest.mark.parametrize("tag", sorted(R.ALLOWLIST))
def test_only_waiting_sites_open_the_mode(monkeypatch, tag):
    """A site that does not wait (the uploads, the stream's copies) is
    counted and stays under "error", so a blocking copy put in its place
    raises on the card; only the reads set the mode back to "default"."""
    fake = _FakeMode()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    waits = R.ALLOWLIST[tag].waits
    assert waits == (tag.endswith("-read") or tag == "resilience-snapshot")
    with R.no_implicit_transfers(allow=R.ALLOWLIST, device="cuda"):
        with R.sanctioned_transfer(tag):
            assert fake.mode == (0 if waits else 2)
        assert fake.mode == 2
        if not waits:
            n, sites = len(fake.sets), R.TRANSFER_SITES.get(tag, 0)
            R.upload([1.0, 2.0], torch.float32, "cpu", tag=tag)
            assert len(fake.sets) == n
            assert R.TRANSFER_SITES[tag] == sites + 1
    assert fake.mode == 0


def test_cuda_guard_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with R.no_implicit_transfers(device="cuda"):
            pass
    # device None on a CPU machine: allowlist and counters only
    with R.no_implicit_transfers(allow=["dt-upload"]):
        with R.sanctioned_transfer("dt-upload"):
            pass


def test_sanctioned_counter_and_device_scalar():
    key = "transfers.sanctioned{site=dt-upload}"
    before, sites = M.snapshot().get(key, 0), R.TRANSFER_SITES.get(
        "dt-upload", 0)
    t = R.device_scalar(0.1, torch.float32, "cpu", tag="dt-upload")
    assert t.dtype == torch.float32 and t.dim() == 0
    assert t.item() == torch.tensor(0.1, dtype=torch.float32).item()
    assert M.snapshot()[key] == before + 1
    assert R.TRANSFER_SITES["dt-upload"] == sites + 1


@pytest.mark.parametrize("kind", ["uniform", "amr"])
def test_second_step_builds_nothing(tmp_path, kind):
    env = {"CUP3D_FUSED": "1"} if kind == "amr" else {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        pd = _port(kind, [], tmp_path, 10)
        with R.RecompileCounter() as first:
            pd.advance(pd.calc_max_timestep())
        with R.RecompileCounter() as rc:
            pd.advance(pd.calc_max_timestep())
    assert rc.total_compiles == 0
    rc.assert_steady_state(budget=0)
    assert set(rc.compiles) == set(R.BUILD_COUNTERS)
    assert first.total_compiles >= 0
    M.counter("bucket.table_builds").inc()
    with pytest.raises(AssertionError, match="bucket.table_builds"):
        with R.RecompileCounter() as bad:
            M.counter("bucket.table_builds").inc()
        bad.assert_steady_state(budget=0)


def test_aot_probe_json_counts_the_registry_deltas(tmp_path, capsys):
    from cup3d_tpu_torch.aot import cli

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps([
        {"kind": "tgv", "n": 16, "nsteps": 4, "cfl": 0.3, "tenant": "x"},
        {"kind": "amr_tgv", "bpd": 2, "levelMax": 2, "nsteps": 4,
         "tenant": "y"}]))
    snap0 = M.snapshot()
    rc = cli.main(["probe", "-device", "cpu", "--scenarios", str(spec),
                   "--workdir", str(tmp_path / "w")])
    snap = M.snapshot()
    assert rc == 0
    report = json.loads(capsys.readouterr().out)

    def delta(key):
        return int(snap.get(key, 0) - snap0.get(key, 0))

    tables = delta("bucket.table_builds") + delta("forest.table_builds")
    assert report["advance_compiles"] == delta("fleet.executable_builds")
    assert report["nvcc_builds"] == delta("kernels.nvcc_builds") == 0
    assert report["table_builds"] == tables >= 1
    assert report["total_compiles"] == (report["advance_compiles"]
                                        + report["nvcc_builds"] + tables)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_debug_nans_raises_on_a_nan_injected_step(tmp_path, pkg):
    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        d = jax_driver("uniform", tmp_path, 10)
        d.advance(d.calc_max_timestep())
        dt = d.calc_max_timestep()
        d.sim.state["vel"] = d.sim.state["vel"].at[1, 2, 3, 0].set(jnp.nan)
        # op by op: the jitted step donates its fields, and the de-
        # optimized re-run jax_debug_nans makes would read deleted buffers
        with pytest.raises(FloatingPointError, match="nan"):
            with jax.disable_jit(), JR.debug_nans():
                d.advance(dt)
        return
    d = _port("uniform", [], tmp_path, 10)
    d.advance(d.calc_max_timestep())
    dt = d.calc_max_timestep()
    d.sim.state["vel"][1, 2, 3, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"aten\.\w+"):
        with R.debug_nans():
            d.advance(dt)
    assert R.NAN_CHECKS[0] == 0
    # the mode is gone: the same op on NaN input passes silently
    assert torch.isnan(d.sim.state["vel"] * 2.0).any()


def test_debug_nans_names_the_kernel_at_its_wrapper():
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fab
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    bad = torch.tensor([1.0, float("inf")])
    fb._count("update", torch.float32, bad)  # checks off: counted only
    with R.debug_nans():
        with pytest.raises(FloatingPointError, match=r"B1 \(cup3d_update"):
            fb._count("update", torch.float32, torch.ones(2), bad)
        with pytest.raises(FloatingPointError, match=r"B13 \(amr_finish"):
            fab._count("amr_finish", torch.float32, bad)
        fb._count("lap", torch.float32, torch.ones(3))  # finite: passes
        # an allocation's bytes are not values: empty never trips
        torch.empty(1024)
    assert R.NAN_CHECKS[0] == 0
    fb.reset_launches()
    fab.reset_launches()
