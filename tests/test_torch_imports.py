"""The PyTorch port stands alone: every ``cup3d_tpu_torch`` module imports
with JAX blocked, and no module imports the JAX package ``cup3d_tpu``."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "cup3d_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def _is_jax_package(name: str) -> bool:
    return name == "cup3d_tpu" or name.startswith("cup3d_tpu.")


def test_no_module_imports_the_jax_package_or_jax():
    offenders = []
    for path, mod in _modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if _is_jax_package(name) or top in ("jax", "jaxlib"):
                    offenders.append(f"{mod}: {name}")
    assert not offenders, offenders
    # the check itself: the port's own name must not count as the JAX one
    assert not _is_jax_package("cup3d_tpu_torch.ops")
    assert _is_jax_package("cup3d_tpu.ops") and _is_jax_package("cup3d_tpu")


def test_every_module_imports_with_jax_blocked():
    mods = [m for _, m in _modules()]
    # the walk finds the forest modules (the AMR slice), the
    # self-healing loop's (the resilience slice), the fish's and the
    # sharded forest's too
    assert {f"cup3d_tpu_torch.{m}" for m in (
        "grid.sfc", "grid.octree", "grid.blocks", "grid.faces", "grid.flux",
        "grid.adapt", "ops.amr_ops", "ops.fused_amr_bicgstab", "sim.amr",
        "obs.metrics", "obs.flight", "obs.trace", "resilience",
        "resilience.faults", "resilience.writeguard", "resilience.recovery",
        "io.checkpoint", "ops.getz_cg",
        # the fish slice's
        "models", "models.base", "models.factory", "models.pipeline",
        "models.fish", "models.fish.interpolation", "models.fish.schedulers",
        "models.fish.frenet", "models.fish.shapes", "models.fish.midline",
        "models.fish.curvature", "models.fish.rasterize",
        "models.fish.stefanfish", "ops.chi", "ops.penalization",
        "ops.surface",
        # the sharded forest's
        "grid.bucket", "parallel", "parallel.compat", "parallel.ring",
        "parallel.forest", "parallel.faces",
        # the pipelined stepping and the megaloop
        "stream", "stream.qoi", "sim.megaloop",
        "models.fish.device_midline",
        # the uniform driver complete, and the output path
        "ops.diffusion", "utils.flows", "utils.geometry", "models.sphere",
        "models.naca", "models.collisions", "io.dump", "stream.dump",
        "stream.checkpoint", "sim.fused",
        # bodies on the forest (the forest's probe, fluid divergence and
        # state carry live in these)
        "ops.diagnostics", "sim.data",
        # the bucketed forest, the native lab-table builder, the
        # surface-point records
        "native", "grid.adapt", "grid.faces", "grid.flux", "ops.krylov",
        # the slab mesh of the megaloop and its collectives
        "parallel.mesh", "parallel.topology", "parallel.collectives",
        # the fleet: lane batching, isolation, the journal, the server,
        # migration, the CLI, and the observability under it
        "fleet", "fleet.batch", "fleet.isolate", "fleet.journal",
        "fleet.server", "fleet.migrate", "fleet.cli", "obs.federate",
        # device-time attribution, the exporter, cost accounting
        "obs.export", "obs.profile", "obs.costs",
        # the compiled store, the background compile service, their CLI
        "aot", "aot.store", "aot.compiler", "aot.cli",
        # the analysis layer: the lint, its catalog and CLI, the sanitizers
        "analysis", "analysis.rules", "analysis.lint", "analysis.__main__",
        "analysis.runtime",
    )} <= set(mods)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'cup3d_tpu' "
        "or m.startswith('cup3d_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(" f"{mods!r}" "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
