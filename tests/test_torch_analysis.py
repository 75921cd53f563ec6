"""The port's lint (cup3d_tpu_torch/analysis/{rules,lint,__main__}.py):
each ported rule on a hazard snippet that it flags and a clean twin that
it does not, the catalog against the JAX package's, the suppression
comments and the baseline, the port's own tree (clean, every annotation
with a reason, a baseline of at most 15 reasoned entries, as
tests/test_analysis.py holds the JAX tree) and the CLI."""

import json
import subprocess
import sys
import textwrap

import pytest

from cup3d_tpu.analysis.rules import RULES as JAX_RULES
from cup3d_tpu_torch.analysis import lint as L
from cup3d_tpu_torch.analysis.rules import PORTED, RULES

SIM = "cup3d_tpu_torch/sim/fixture.py"
OPS = "cup3d_tpu_torch/ops/fixture.py"
FLEET = "cup3d_tpu_torch/fleet/fixture.py"
MODELS = "cup3d_tpu_torch/models/fixture.py"

#: rule -> ((path, hazard source), (path, clean twin source))
CASES = {
    "JX001": (
        (SIM, """
            def advance(self, dt):
                u = torch.max(self.vel)
                n = int(u.shape[0])
                return u.item() + float(u)
            """),
        (SIM, """
            def advance(self, dt):
                u = torch.max(self.vel)
                n = int(u.shape[0]) + u.numel()
                with sanctioned_transfer("umax-read"):
                    return float(u)
            """)),
    "JX004": (
        (SIM, """
            def advance(self, dt):
                for k in range(3):
                    x = torch.zeros(4, device=self.device)
            """),
        (SIM, """
            def advance(self, dt):
                x = torch.zeros(4, device=self.device)
                for k in range(3):
                    x = x + k
            """)),
    "JX005": (
        (OPS, """
            def f(x):
                y = x.double()
                return torch.zeros(4, dtype=torch.float64, device=x.device)
            """),
        (OPS, """
            def f(x):
                z = torch.zeros(4, dtype=torch.float64)
                return x.cpu().to(torch.float64).numpy()
            """)),
    "JX006": (
        ("tools/fixture.py", """
            def bench(fn):
                t0 = time.perf_counter()
                fn()
                return time.perf_counter() - t0
            """),
        ("tools/fixture.py", """
            def bench(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            """)),
    "JX008": (
        (SIM, """
            import time
            def section(fn):
                t0 = time.perf_counter()
                fn()
            """),
        ("cup3d_tpu_torch/obs/fixture.py", """
            import time
            def section(fn):
                t0 = time.perf_counter()
                fn()
            """)),
    "JX009": (
        ("cup3d_tpu_torch/io/fixture.py", """
            def load(path):
                try:
                    return open(path).read()
                except OSError:
                    pass
            """),
        ("cup3d_tpu_torch/io/fixture.py", """
            def load(path):
                try:
                    return open(path).read()
                except OSError:
                    M.counter("io.read_errors").inc()
            """)),
    "JX010": (
        (MODELS, """
            def __call__(self, dt):
                return upload(self.position, torch.float32, self.device)
            """),
        (MODELS, """
            def __call__(self, dt):
                return self.position_dev(torch.float32)
            """)),
    "JX011": (
        (OPS, """
            def dot(a, b):
                a16 = a.to(torch.bfloat16)
                return torch.sum(a16 * b)
            """),
        (OPS, """
            def dot(a, b):
                a16 = a.to(torch.bfloat16)
                return torch.sum(a16 * b, dtype=torch.float32)
            """)),
    "JX012": (
        (SIM, """
            def window(fn):
                from torch.profiler import profile
                with profile() as p:
                    fn()
            """),
        ("cup3d_tpu_torch/obs/fixture.py", """
            def window(fn):
                from torch.profiler import profile
                with profile() as p:
                    fn()
            """)),
    "JX013": (
        (FLEET, """
            def advance(self):
                for lane in range(self.B):
                    self.out[lane] = torch.sum(self.x[lane])
            """),
        (FLEET, """
            def advance(self):
                names = [f"lane-{lane}" for lane in range(self.B)]
                self.out = torch.sum(self.x, dim=1)
            """)),
    "JX014": (
        (SIM, """
            import time
            def run(fn):
                t0 = time.time()
                fn()
                return time.time() - t0
            """),
        (SIM, """
            import time
            def stamp():
                return {"wall": time.time(), "hour_ago": time.time() - 3600}
            """)),
    "JX015": (
        (FLEET, """
            def reseed(self, carries):
                self.carry = torch.stack([c["vel"] for c in carries])
            """),
        (FLEET, """
            def __init__(self, carries):
                self.carry = torch.stack([c["vel"] for c in carries])
            """)),
    "JX016": (
        ("cup3d_tpu_torch/parallel/fixture.py", """
            def advance(self):
                return self.vel.cpu().numpy()
            """),
        ("cup3d_tpu_torch/parallel/fixture.py", """
            def advance(self):
                with sanctioned_transfer("qoi-read"):
                    return self.vel.cpu().numpy()
            """)),
    "JX017": (
        ("bench_fixture.py", """
            def roofline(bytes_moved):
                return bytes_moved / 3.35e12
            """),
        ("bench_fixture.py", """
            def roofline(bytes_moved):
                return bytes_moved / device_peaks()["bytes"] / 1e12
            """)),
    "JX018": (
        (SIM, """
            import torch.distributed as dist
            def exchange(x):
                dist.all_reduce(x)
            """),
        (SIM, """
            def exchange(x, dist):
                return dist.get("peer")
            """)),
    "JX019": (
        (SIM, """
            def fast(fn):
                return torch.compile(fn)
            """),
        ("cup3d_tpu_torch/aot/fixture.py", """
            def fast(fn):
                return torch.compile(fn)
            """)),
    "JX020": (
        (SIM, """
            import time
            def stamp():
                return time.monotonic()
            """),
        ("cup3d_tpu_torch/obs/trace.py", """
            import time
            def now():
                return time.monotonic()
            """)),
    "JX021": (
        (FLEET, """
            def tick(self, job):
                job.status = "done"
            """),
        (FLEET, """
            def retire(self, job):
                job.status = "done"
            """)),
    "JX022": (
        ("cup3d_tpu_torch/ops/fixture.py", """
            import torch
            def fast_matmul():
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.set_float32_matmul_precision("high")
            """),
        ("cup3d_tpu_torch/ops/fixture.py", """
            import torch
            def exact_matmul():
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.set_float32_matmul_precision("highest")
            """)),
}


def _failing_rules(path, src):
    return {v.rule for v in L.failing(L.lint_source(textwrap.dedent(src),
                                                    path))}


@pytest.mark.parametrize("rule,twin", [(r, t) for r in sorted(CASES)
                                       for t in ("hazard", "clean")])
def test_rule_flags_the_hazard_and_not_its_twin(rule, twin):
    hazard, clean = CASES[rule]
    if twin == "hazard":
        assert rule in _failing_rules(*hazard)
    else:
        assert rule not in _failing_rules(*clean)


def test_every_ported_rule_has_a_case():
    assert set(CASES) == set(PORTED)


def test_catalog_covers_the_jax_rules():
    """Every JAX rule ID is in the port's catalog, ported or marked not
    applicable with the reason; JX022 (TF32) is the port's own."""
    assert set(JAX_RULES) <= set(RULES)
    assert set(RULES) - set(JAX_RULES) == {"JX022"}
    for rid, rule in RULES.items():
        if rule.applies:
            assert rule.rationale.strip(), rid
        else:
            assert len(rule.not_applicable) > 20, rid
    assert {r for r in RULES if not RULES[r].applies} == {
        "JX002", "JX003", "JX007", "JP001", "JP002", "JP003", "JP004",
        "JP005"}


def test_suppression_parsing():
    src = textwrap.dedent("""
        def advance(self):
            u = torch.max(self.vel)
            a = u.item()  # torch-lint: allow(JX001, read (once) a run)
            # torch-lint: allow(JX001, a wrapped reason that goes on
            # over two comment lines)
            b = u.item()
            c = u.item()  # jax-lint: allow(JX001, the other package's)
        """)
    sup = L.parse_suppressions(src)
    assert sup[4] == {"JX001": "read (once) a run"}
    assert sup[7]["JX001"].startswith("a wrapped reason")
    vs = sorted((v for v in L.lint_source(src, SIM) if v.rule == "JX001"),
                key=lambda v: v.line)
    assert [v.suppressed for v in vs] == [True, True, False]
    assert vs[0].suppression_reason == "read (once) a run"


def test_baseline_roundtrip_and_count_cap(tmp_path):
    src = textwrap.dedent("""
        def advance(self):
            u = torch.max(self.vel)
            return u.item() + u.item()
        """)
    path = tmp_path / "cup3d_tpu_torch" / "sim" / "b.py"
    path.parent.mkdir(parents=True)
    path.write_text(src)
    bp = str(tmp_path / "baseline.json")
    vs = L.lint_paths([str(path)])
    assert len(L.failing(vs)) == 2
    L.write_baseline(vs, bp)
    entries = json.load(open(bp))["entries"]
    assert entries == [{"rule": "JX001", "path": "cup3d_tpu_torch/sim/b.py",
                        "func": "advance", "count": 2,
                        "reason": "TODO: justify or fix"}]
    assert not L.failing(L.lint_paths([str(path)], baseline_path=bp))
    # a third finding in the same function is new: it fails
    path.write_text(src.replace("u.item() + u.item()",
                                "u.item() + u.item() + u.item()"))
    assert len(L.failing(L.lint_paths([str(path)], baseline_path=bp))) == 1


def _port_root():
    import cup3d_tpu_torch

    return cup3d_tpu_torch.__path__[0]


def test_port_lints_clean_with_reasons():
    bp = L.default_baseline_path()
    vs = L.lint_paths([_port_root()], baseline_path=bp)
    bad = L.failing(vs)
    assert not bad, "\n".join(v.format() for v in bad)
    for v in vs:
        if v.suppressed:
            assert v.suppression_reason, f"reason-less: {v.format()}"
    entries = json.load(open(bp))["entries"]
    assert len(entries) <= 15
    assert all(e.get("reason", "").strip() and "TODO" not in e["reason"]
               for e in entries)


def test_cli_exits_zero_on_the_port_and_imports_no_torch():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['x', sys.argv[1], '-q']; "
         "import cup3d_tpu_torch.analysis.__main__ as m; rc = m.main(); "
         "print('torch' in sys.modules, 'jax' in sys.modules); "
         "sys.exit(rc)", _port_root()],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "False False"
    assert "0 failing" in proc.stdout


def test_cli_lists_rules():
    proc = subprocess.run(
        [sys.executable, "-m", "cup3d_tpu_torch.analysis", "--list-rules"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for rid in RULES:
        assert rid in proc.stdout
    assert proc.stdout.count("[not applicable:") == 8
