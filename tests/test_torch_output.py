"""The port's output path against the JAX package: field dumps (XDMF2 +
raw, the reference's tool/post.py layout) on the uniform grid and on a
27-block forest, written by the JAX ``io/dump.dump_fields`` and by the
port's single writer and its sharded ``AsyncDumper`` from the same numpy
fields, byte for byte, and read back; an ``AsyncCheckpointer`` file that
both packages' loaders restore, the port's resumed run bitwise equal to
an uninterrupted one; an armed ``dump.write_fail`` that the run survives
and counts; a failed background checkpoint write that falls back to a
synchronous one under recovery and raises without it; the forest
driver's dumps and checkpoints; and the
coiled-vorticity initial condition at 16^3 within 1e-5 of the JAX
package's (f32, tests/test_torch_grid_ops.py's bound)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.grid import uniform as ju
from cup3d_tpu.io import dump as jdump
from cup3d_tpu_torch.__main__ import build_driver
from cup3d_tpu_torch.grid import uniform as tu
from cup3d_tpu_torch.io import dump as tdump
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.stream.dump import AsyncDumper, dump_fields_sharded
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TGV = ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 1 -extent 6.283185307179586 "
       "-initCond taylorGreen -poissonSolver iterative -nu 0.02 -CFL 0.3 "
       "-rampup 0 -tend 0 -verbose 0")


def _grids(kind):
    if kind == "uniform":
        shape, ext = (16, 8, 8), (2.0, 1.0, 1.0)
        bcs = ("periodic", "wall", "periodic")
        return (ju.UniformGrid(shape, ext, bcs),
                tu.UniformGrid(shape, ext, bcs))
    from cup3d_tpu.grid.blocks import BlockGrid as JBlockGrid
    from cup3d_tpu.grid.octree import Octree as JOctree
    from cup3d_tpu.grid.octree import TreeConfig as JTreeConfig
    from cup3d_tpu_torch.grid.blocks import BlockGrid
    from cup3d_tpu_torch.grid.octree import Octree, TreeConfig

    ext = (1.5, 1.5, 1.5)
    jg = JBlockGrid(JOctree(JTreeConfig((3, 3, 3), 2, (True,) * 3), 0), ext)
    tg = BlockGrid(Octree(TreeConfig((3, 3, 3), 2, (True,) * 3), 0), ext)
    assert tg.nb == jg.nb == 27
    return jg, tg


def _files(prefix):
    d, base = os.path.split(prefix)
    return {n[len(base):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(base)}


@pytest.mark.parametrize("kind", ["uniform", "forest"])
def test_dumps_are_the_jax_packages_bytes(tmp_path, monkeypatch, kind):
    jg, tg = _grids(kind)
    ncell = 16 * 8 * 8 if kind == "uniform" else 27 * 512
    rng = np.random.default_rng(4)
    fields = {"chi": rng.uniform(size=ncell).astype(np.float32),
              "velx": rng.standard_normal(ncell).astype(np.float32)}
    want = tmp_path / "jax" / "dump_0000003"
    jdump.dump_fields(str(want), 0.125, jg, fields)
    ref = _files(str(want))
    assert len(ref) == 5  # geometry, and (raw, xdmf2) for each field
    one = tmp_path / "single" / "dump_0000003"
    tdump.dump_fields(str(one), 0.125, tg, fields)
    assert _files(str(one)) == ref
    shard = tmp_path / "shards" / "dump_0000003"
    out = dump_fields_sharded(str(shard), 0.125, tg, fields, nshards=3)
    assert out["shards"] == 3 and _files(str(shard)) == ref
    # geometry jobs smaller than a shard, ending inside one
    from cup3d_tpu_torch.stream import dump as sdump

    monkeypatch.setattr(sdump, "GEOM_CHUNK", 1000)
    chunks = tmp_path / "chunks" / "dump_0000003"
    dump_fields_sharded(str(chunks), 0.125, tg, fields, nshards=3)
    assert _files(str(chunks)) == ref
    d = AsyncDumper(nshards=2)
    staged = tmp_path / "async" / "dump_0000003"
    d.submit(str(staged), 0.125, tg,
             {k: torch.as_tensor(v) for k, v in fields.items()}, step=3)
    d.wait()
    assert _files(str(staged)) == ref
    assert d.health()["ok"] and d.stats["dumps"] == 1
    centers, attr = tdump.read_dump(f"{staged}.velx.xdmf2")
    jc, ja = jdump.read_dump(f"{want}.velx.xdmf2")
    np.testing.assert_array_equal(attr, fields["velx"])
    np.testing.assert_array_equal(centers, jc)


def test_output_cadence_is_the_jax_packages():
    want, got = jdump.OutputCadence(0.3, 4, 5), tdump.OutputCadence(0.3, 4, 5)
    for step, t in enumerate(np.arange(0.0, 2.0, 0.17)):
        assert got.dump_due(t, step) == want.dump_due(t, step)
        assert got.save_due(step) == want.save_due(step)
        assert got.next_dump == want.next_dump


def test_async_checkpoint_restores_in_both_packages(tmp_path):
    from cup3d_tpu.io.checkpoint import load_checkpoint as jax_load

    from cup3d_tpu_torch.io.checkpoint import load_checkpoint

    def run(nsteps, out, extra=""):
        d = build_driver(f"{TGV} -nsteps {nsteps} -path4serialization "
                         f"{out} {extra} -device cpu".split())
        d.init()
        d.simulate()
        return d

    full = run(4, tmp_path / "full")
    part = run(2, tmp_path / "part", "-saveFreq 2 -tdump 0.01")
    # the checkpoint is taken as step 2 starts: none at step 2 of a
    # 2-step run, so save one more through the async checkpointer
    path = part._checkpointer.save(part)
    part.drain_streams()
    assert part._checkpointer.health()["ok"]
    j = jax_load(path)
    np.testing.assert_array_equal(np.asarray(j.sim.state["vel"]),
                                  part.sim.state["vel"].numpy())
    assert j.sim.cadence.next_dump == part.sim.cadence.next_dump > 0
    r = load_checkpoint(path, device="cpu")
    assert r.sim.step == 2 and r.sim.cadence.next_dump == \
        part.sim.cadence.next_dump
    r.cfg.nsteps = 4
    r.simulate()
    assert r.sim.step == 4 and r.sim.time == full.sim.time
    assert torch.equal(r.sim.state["vel"], full.sim.state["vel"])
    assert torch.equal(r.sim.state["p"], full.sim.state["p"])


def test_dump_write_fail_is_survived_and_counted(tmp_path):
    faults.clear()
    faults.arm("dump.write_fail", 0, count=3)  # all 3 attempts of step 0
    try:
        d = build_driver(f"{TGV} -nsteps 3 -fdump 2 -path4serialization "
                         f"{tmp_path} -device cpu".split())
        d.init()
        d.simulate()
    finally:
        faults.clear()
    assert d.sim.step == 3
    st = d._dumper.stats
    assert st["dumps"] == 2 and st["write_failures"] == 3
    assert st["dropped"] == 1 and not d._dumper.health()["ok"]
    names = os.listdir(tmp_path)
    assert "dump_0000002.chi.xdmf2" in names
    assert not any(n.startswith("dump_0000000") for n in names)


def test_forest_driver_dumps_and_checkpoints(tmp_path):
    from cup3d_tpu_torch.io.checkpoint import load_checkpoint

    argv = (TGV.replace("-levelMax 1", "-levelMax 2 -levelStart 0 "
                        "-Rtol 100 -Ctol 0")
            + f" -nsteps 3 -fdump 2 -saveFreq 2 -dumpVelocity 1 "
            f"-dumpOmega 1 -path4serialization {tmp_path} -device cpu")
    d = build_driver(argv.split())
    d.init()
    d.simulate()
    names = os.listdir(tmp_path)
    for k in ("chi", "velx", "omega"):
        assert f"dump_0000002.{k}.xdmf2" in names
    _, attr = tdump.read_dump(str(tmp_path / "dump_0000002.velx.xdmf2"))
    assert attr.size == d.grid.nb * 512 and np.all(np.isfinite(attr))
    r = load_checkpoint(str(tmp_path / "ckpt_0000002.pkl"), device="cpu")
    assert r.step_idx == 2 and r._cadence.next_dump == 0.0


def test_vorticity_ic_matches_jax():
    from cup3d_tpu.utils.flows import coil_velocity_uniform as jcoil

    from cup3d_tpu_torch.utils.flows import coil_velocity_uniform

    shape, ext = (16, 16, 16), (2.0, 2.0, 2.0)
    want = np.asarray(jcoil(ju.UniformGrid(shape, ext)))
    got = coil_velocity_uniform(tu.UniformGrid(shape, ext)).numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    # chunked nearest-point search: the same field at any chunk size
    from cup3d_tpu_torch.utils.flows import coil_vorticity

    xc = tu.UniformGrid(shape, ext).cell_centers()
    assert torch.equal(coil_vorticity(xc, chunk=37), coil_vorticity(xc))


def test_failed_async_checkpoint_falls_back_under_recovery(tmp_path,
                                                           monkeypatch):
    """A background checkpoint write that fails every attempt surfaces at
    the next save; under recovery that save falls back to one synchronous
    write and the run goes on (without recovery the failure raises)."""
    from cup3d_tpu_torch.obs import metrics

    argv = (f"{TGV} -nsteps 3 -saveFreq 1 -path4serialization {tmp_path} "
            "-device cpu").split()
    before = metrics.snapshot()
    faults.clear()
    faults.arm("ckpt.write_fail", 1, count=3)  # all 3 attempts of step 1
    try:
        d = build_driver(argv)
        d.init()
        d.simulate()
    finally:
        faults.clear()
    delta = metrics.delta(before)
    assert d.sim.step == 3
    assert delta.get("resilience.ckpt_sync_fallbacks", 0) == 1
    assert sorted(os.listdir(tmp_path)).count("ckpt_0000002.pkl") == 1
    assert "ckpt_0000001.pkl" not in os.listdir(tmp_path)
    monkeypatch.setenv("CUP3D_RECOVER", "0")
    faults.arm("ckpt.write_fail", 1, count=3)
    try:
        d = build_driver(argv)
        d.init()
        with pytest.raises(faults.InjectedFault):
            d.simulate()
    finally:
        faults.clear()
