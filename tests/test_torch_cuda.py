"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test needs an NVIDIA GPU and ``nvcc`` and skips
without them (the kernels have no CPU mode).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Small shapes, other BCs and a non-cubic grid than chip_smoke.py's 256^3
periodic run: each stage at T = 24 tiles within the bounds chip_smoke.py
states (2e-6 elementwise, 1e-5 getz, partials 1e-5 of the per-tile sum
of |terms|), the whole fused solve within +-1 iteration and 1e-4, and a
short driver run whose launch counts match its iterations.  The same for
the AMR forest's kernels on a small two-level forest (periodic and
closed), plus a bitwise-equal rerun of the kernel solve.  The tile-only
getZ (B3, B10) in fused solves whose getz_tile launches are twice the
executed iterations, and the CG getZ (B7) on both layouts, with a scalar
and a per-tile shift, and in a CUP3D_GETZ=cg solve whose launches equal
its preconditioner applications.  The fish (BASELINE config #2 at 32^3)
for 3 steps on the card, held against the port on the CPU.  The ring
shift (B14) against its plain version, bitwise, at odd byte counts and
misaligned slices, and inside ``ring_all_to_all`` (one launch); its
strided reads and landings; the two-level getZ (B2) at ragged tile
counts, and the tile-only getZ (B3, B10) on its core at the same counts,
at one h2 and at a column of distinct h^2; the CG getZ (B7) at lanes-layout
tile counts that leave a CTA's 8 tiles ragged, at 0, 1 and 24 sweeps, and
on right-hand sides that are nonzero on one face or one edge of each tile
(every face and edge of the tile in turn); bitwise reruns of all four.
The forest's two-level getZ (B9) on the shared core at 8, 27, 9,472 and
a ragged block count, rerun bitwise; the device midline's Frenet kernel
against its plain loop; the fish pipelined on the card against the port
on the CPU; the two-level getZ (B2) and the Laplacian (B4) on
wall-bounded lanes (BASELINE config #5's walls), rerun bitwise.  The
pipelined forest (obstacle-free on the device dt chain, and two spheres
with the rigid state chained on the device) for 3 steps on the card
against the port on the CPU.  The bf16 builds of B1-B6 and B8-B13
against their bf16 plain versions by chip_smoke.py's stage rule (stored
bf16 outputs bitwise on >= 99.9% of the cells, each within one ulp or
the f32 bound near 0; partials within 2e-5 of the per-tile sum of
|terms| of the sum over the kernel's own stored output), and fused bf16
solves on both grids against their plain versions (+-1 iteration, x
within 1e-2), the bf16 launches counted apart.  B14 at the x-slab
megaloop's halo shapes (strided component planes of vector slabs) and
RK3 on the slabs bitwise the unsharded RK3 on the card.  The Laplacian
(B4), which reads its neighbour faces from w, on periodic, walls-in-y
and closed grids whose z runs of four tiles are whole or ragged, at f32
and bf16: Aw bitwise its plain version (the face planes of
make_tile_planes and laplacian_faces), its partial-free call bitwise
make_laplacian_tiles."""

import math

import numpy as np
import pytest
import torch

from cup3d_tpu_torch.grid.uniform import UniformGrid
from cup3d_tpu_torch.ops import fused_bicgstab as fb
from cup3d_tpu_torch.ops import krylov

pytestmark = pytest.mark.cuda

T = 24


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _vecs(dev, seed, n):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((T, 8, 8, 8)),
                            dtype=torch.float32, device=dev)
            for _ in range(n)]


def _row(dev, *vals):
    return fb._scalars(*(torch.tensor(v, device=dev) for v in vals))


def _close(got, want, rtol, scale=None):
    scale = float(torch.max(torch.abs(want))) if scale is None else scale
    err = float(torch.max(torch.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _tile_abs_sum(x):
    return float(torch.max(torch.sum(torch.abs(x), dim=(1, 2, 3))))


def _lap_grid(bcs, shape=(16, 24, 32)):
    """A grid of T = 24 tiles (2 x 3 x 4) for B4, which reads its
    neighbour faces by the grid's tile counts and BCs."""
    return UniformGrid(shape, tuple(n / 32 for n in shape), bcs)


# B4's BC sets: periodic (the TGV), walls in y (BASELINE config #5) and no
# periodic axis; shapes whose z runs of 4 tiles are whole, ragged (5 and 3
# tiles along z) and a single tile along x and y
LAP_BCS = [("periodic",) * 3, ("periodic", "wall", "periodic"),
           ("wall", "freespace", "wall")]
LAP_SHAPES = [(32, 24, 32), (16, 8, 40), (8, 8, 24)]


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LAP_SHAPES)
@pytest.mark.parametrize("bcs", LAP_BCS)
def test_lap_reads_its_faces_on_every_bc_set(dev, bcs, shape, store):
    """B4 against its plain version (the face planes of make_tile_planes
    and laplacian_faces): Aw bitwise, the partials within 1e-5 (f32) or
    2e-5 (bf16, of its own stored Aw) of the per-tile sum of |terms|; the
    partial-free call (the warm start's residual) bitwise the plain
    Laplacian; a rerun bitwise; one launch a call."""
    grid = _lap_grid(bcs, shape)
    geom = fb.LapGeom(grid)
    T = grid.ncells // 512
    rng = np.random.default_rng(31)
    w, a = (torch.as_tensor(rng.standard_normal((T, 8, 8, 8)),
                            dtype=torch.float32, device=dev).to(store)
            for _ in range(2))
    inv_h2 = 1.0 / (grid.h * grid.h)
    fb.reset_launches()
    got = fb.lap(w, a, inv_h2, geom)
    want = fb.lap(w, a, inv_h2, geom, kernels=False)
    assert torch.equal(got[0], want[0])
    aw = got[0].float()
    if store == torch.float32:
        _close(got[1], want[1], 1e-5, _tile_abs_sum(a * aw))
        _close(got[2], want[2], 1e-5, _tile_abs_sum(aw * aw))
    else:
        _hold_part(got[1], fb._cellsum(a.float() * aw), a.float() * aw)
        _hold_part(got[2], fb._cellsum(aw * aw), aw * aw)
    again = fb.lap(w, a, inv_h2, geom)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    x = w.float()
    alone = fb.lap(x, None, inv_h2, geom)
    assert alone[1:] == (None, None)
    assert torch.equal(alone[0], krylov.make_laplacian_tiles(grid)(x))
    torch.cuda.synchronize()
    counts = fb.launches if store == torch.float32 else fb.launches_bf16
    assert counts["lap"] == 2 and fb.residual_launches["lap"] == 1
    assert sum(fb.launches.values()) + sum(
        fb.launches_bf16.values()) == 2


def test_stage_kernels_match_plain_versions(dev):
    fb.reset_launches()
    r, p, v, rhat, w, a, x, y = _vecs(dev, 0, 8)
    for vals in ((0.7, 1.3, 0.0), (0.0, 1.3, 1.0)):
        want = fb.update(r, p.clone(), v, rhat.clone(), _row(dev, *vals),
                         kernels=False)
        got = fb.update(r, p.clone(), v, rhat.clone(), _row(dev, *vals))
        _close(got[0], want[0], 2e-6)
        _close(got[1], want[1], 2e-6)
        _close(got[2], want[2], 1e-5, _tile_abs_sum(want[0]))
    aux = torch.randn((8, T), device=dev)
    _close(fb.getz_two(w, aux, 0.01), fb.getz_two(w, aux, 0.01,
                                                  kernels=False), 1e-5)
    geom = fb.LapGeom(_lap_grid(("periodic", "wall", "freespace")))
    want = fb.lap(w, a, 100.0, geom, kernels=False)
    got = fb.lap(w, a, 100.0, geom)
    assert torch.equal(got[0], want[0])
    _close(got[1], want[1], 1e-5, _tile_abs_sum(a * want[0]))
    _close(got[2], want[2], 1e-5, _tile_abs_sum(want[0] * want[0]))
    want = fb.axpy(r, v, _row(dev, 0.37), kernels=False)
    got = fb.axpy(r, v, _row(dev, 0.37))
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 1e-5, _tile_abs_sum(want[0]))
    sc = _row(dev, 0.37, 1.21)
    want = fb.finish(x.clone(), y, w, r.clone(), v, rhat, sc, kernels=False)
    got = fb.finish(x.clone(), y, w, r.clone(), v, rhat, sc)
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 2e-6)
    _close(got[2], want[2], 1e-5, _tile_abs_sum(want[1] * want[1]))
    _close(got[3], want[3], 1e-5, _tile_abs_sum(rhat * want[1]))
    torch.cuda.synchronize()
    _close(fb.getz_tile(w, 0.01), fb.getz_tile(w, 0.01, kernels=False),
           1e-5)
    torch.cuda.synchronize()
    assert fb.launches == {"update": 2, "getz_two": 1, "getz_tile": 1,
                           "lap": 1, "axpy": 1, "finish": 1}


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    r, v = _vecs(dev, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fb.axpy(r.transpose(1, 2), v, _row(dev, 0.5))
    with pytest.raises(ValueError, match="f32"):
        fb.axpy(r.double(), v.double(), _row(dev, 0.5))
    with pytest.raises(ValueError, match="contiguous"):
        fb.getz_tile(r.transpose(1, 2), 0.01)
    # lap reads w as float4: a view 4 bytes in is refused
    geom = fb.LapGeom(_lap_grid(("periodic",) * 3))
    bad = torch.zeros(T * 512 + 1, device=dev)[1:].view(T, 8, 8, 8)
    with pytest.raises(ValueError, match="aligned"):
        fb.lap(bad, v, 1.0, geom)
    # and a vector of another grid's tile count
    with pytest.raises(ValueError, match="tiles"):
        fb.lap(r[:12], v[:12], 1.0, geom)


@pytest.mark.parametrize("shape,bcs", [
    ((32, 32, 32), ("periodic",) * 3),
    ((16, 32, 16), ("wall", "periodic", "freespace")),
])
def test_fused_solve_kernels_match_plain(dev, shape, bcs):
    grid = UniformGrid(shape, tuple(s / 16 for s in shape), bcs)
    rng = np.random.default_rng(2)
    rhs = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device=dev)
    bt = krylov.to_lanes(rhs - torch.mean(rhs))
    x_k, _, k_k = fb.fused_bicgstab(grid, bt, maxiter=200)
    x_p, _, k_p = fb.fused_bicgstab(grid, bt, maxiter=200, kernels=False)
    assert abs(int(k_k) - int(k_p)) <= 1
    _close(x_k, x_p, 1e-4)


def test_driver_launch_counts_match_iterations(dev, monkeypatch, tmp_path):
    from cup3d_tpu_torch.__main__ import build_driver

    monkeypatch.setenv("CUP3D_FUSED", "1")
    d = build_driver(
        ("-bpdx 4 -bpdy 4 -bpdz 4 -extent 6.283185307179586 "
         "-initCond taylorGreen -poissonSolver iterative -nu 1e-3 "
         "-dt 1e-3 -tend 0 -nsteps 3 -verbose 0 -path4serialization "
         f"{tmp_path}").split())
    d.init()
    fb.reset_launches()
    d.simulate()
    iters = [int(row["iters"]) for row in d.step_log]
    executed = sum(krylov.ITER_CHUNK * math.ceil(k / krylov.ITER_CHUNK)
                   for k in iters)
    assert fb.iterations["executed"] == executed > 0
    assert fb.launches == {"update": executed, "getz_two": 2 * executed,
                           "getz_tile": 0, "lap": 2 * executed,
                           "axpy": executed, "finish": executed}
    # each step's solve starts warm: its residual is one B4 launch
    assert fb.residual_launches["lap"] == len(iters)
    assert torch.isfinite(d.sim.state["vel"]).all()


FISH = ("StefanFish L=0.4 T=1.0 xpos=0.5 ypos=0.515625 zpos=0.515625 "
        "bFixFrameOfRef=1 heightProfile=danio widthProfile=stefan")


def test_fish_steps_match_the_port_on_the_cpu(dev, monkeypatch, tmp_path):
    """BASELINE config #2 cut to 32^3 (the CPU tests' fish), 3 steps on
    the card with the kernels and on the CPU with their plain versions:
    the rigid pack within 1e-5, the force pack within 1e-4 of its largest
    entry, velocity within 1e-5 of max|u|, iterations within +-1 a step,
    and the card's launches equal to its executed iterations."""
    from cup3d_tpu_torch.__main__ import build_driver

    monkeypatch.setenv("CUP3D_FUSED", "1")
    argv = ("-bpdx 4 -bpdy 4 -bpdz 4 -extent 1 -CFL 0.4 -nu 1e-3 -rampup 100 "
            "-poissonSolver iterative -tend 0 -nsteps 3 -verbose 0 "
            f"-path4serialization {tmp_path}").split() + [
                "-factory-content", FISH]
    runs = {}
    for device in ("cpu", "cuda"):
        d = build_driver(argv + ["-device", device])
        d.init()
        fb.reset_launches()
        d.simulate()
        runs[device] = d
    card, cpu = runs["cuda"], runs["cpu"]
    iters = [int(row["iters"]) for row in card.step_log]
    executed = sum(krylov.ITER_CHUNK * math.ceil(k / krylov.ITER_CHUNK)
                   for k in iters)
    assert fb.iterations["executed"] == executed > 0
    assert fb.launches["update"] == executed
    assert fb.launches["getz_two"] == fb.launches["lap"] == 2 * executed
    for a, b in zip(card.step_log, cpu.step_log):
        assert abs(a["iters"] - b["iters"]) <= 1
    oc, op = card.sim.obstacles[0], cpu.sim.obstacles[0]
    vec = lambda ob, keys: np.concatenate(
        [np.atleast_1d(np.asarray(getattr(ob, k), np.float64)) for k in keys])
    rigid = ("transVel", "angVel", "position", "quaternion")
    assert np.abs(vec(oc, rigid) - vec(op, rigid)).max() <= 1e-5
    forces = ("pres_force", "visc_force", "torque", "pow_out", "thrust",
              "drag", "def_power")
    fp = vec(op, forces)
    assert np.abs(vec(oc, forces) - fp).max() <= 1e-4 * np.abs(fp).max()
    v = cpu.sim.state["vel"]
    _close(card.sim.state["vel"].cpu(), v, 1e-5)


# -- the AMR forest's kernels (B8, B9, B11, B12, B13) -------------------------


def _forest(dev, bcs=("periodic",) * 3, nref=2):
    """A 2x2x2 base forest, levelMax 2, ``nref`` octants refined, with
    its width-1 face tables, flux tables and block graph on ``dev``."""
    from cup3d_tpu_torch.grid.blocks import BlockGrid
    from cup3d_tpu_torch.grid.flux import build_flux_tables
    from cup3d_tpu_torch.grid.octree import Octree, TreeConfig

    tree = Octree(TreeConfig((2, 2, 2), 2, tuple(b == "periodic"
                                                  for b in bcs)), 0)
    for leaf in sorted(tree.leaves)[:nref]:
        tree.refine(leaf)
    g = BlockGrid(tree, (1.0,) * 3, bcs, 8)
    return (g, g.face_tables(1, dev), build_flux_tables(g, dev),
            krylov.block_graph_tables(g, dev))


def test_forest_stage_kernels_match_plain_versions(dev):
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    g, tab, ftab, _ = _forest(dev)
    n = g.nb
    rng = np.random.default_rng(5)

    def vec():
        return torch.as_tensor(rng.standard_normal((n, 8, 8, 8)),
                               dtype=torch.float32, device=dev)

    def col(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    vol, h2 = col(g.h ** 3), col(g.h ** 2)
    inv_h2 = 1.0 / h2
    fa.reset_launches()
    r, p, v, rhat, w, azf, x, y = (vec() for _ in range(8))
    for vals in ((0.7, 1.3, 0.0), (0.0, 1.3, 1.0)):
        want = fa.update(r, p.clone(), v, rhat.clone(), vol, _row(dev, *vals),
                         kernels=False)
        got = fa.update(r, p.clone(), v, rhat.clone(), vol, _row(dev, *vals))
        _close(got[0], want[0], 2e-6)
        _close(got[1], want[1], 2e-6)
        _close(got[2], want[2], 1e-5, _tile_abs_sum(want[0]) * float(vol.max()))
    zc = col(rng.standard_normal(n))
    _close(fa.getz_two(w, azf, zc, h2), fa.getz_two(w, azf, zc, h2,
                                                    kernels=False), 1e-5)
    lab = tab.assemble_scalar(w, 8).contiguous()
    corr = vec()
    want = fa.lap(lab, corr, rhat, inv_h2, kernels=False)
    got = fa.lap(lab, corr, rhat, inv_h2)
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 1e-5, _tile_abs_sum(rhat * want[0]))
    _close(got[2], want[2], 1e-5, _tile_abs_sum(want[0] * want[0]))
    want = fa.axpy(r, v, vol, _row(dev, 0.37), kernels=False)
    got = fa.axpy(r, v, vol, _row(dev, 0.37))
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 1e-5, _tile_abs_sum(want[0]) * float(vol.max()))
    sc = _row(dev, 0.37, 1.21)
    want = fa.finish(x.clone(), y, w, r.clone(), v, rhat, sc, kernels=False)
    got = fa.finish(x.clone(), y, w, r.clone(), v, rhat, sc)
    for gt, wt in zip(got[:2], want[:2]):
        _close(gt, wt, 2e-6)
    torch.cuda.synchronize()
    _close(fa.getz_tile(w, h2), fa.getz_tile(w, h2, kernels=False), 1e-5)
    torch.cuda.synchronize()
    assert fa.launches == {"amr_update": 2, "amr_getz_two": 1,
                           "amr_getz_tile": 1, "amr_lap": 1, "amr_axpy": 1,
                           "amr_finish": 1}
    with pytest.raises(ValueError, match="aligned"):
        bad = torch.zeros(n * 1000 + 1, device=dev)[1:].view(n, 10, 10, 10)
        fa.lap(bad, corr, rhat, inv_h2)


@pytest.mark.parametrize("bcs", [("periodic",) * 3,
                                 ("wall", "periodic", "freespace")])
def test_forest_fused_solve_kernels_match_plain_and_rerun(dev, bcs):
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    g, tab, ftab, graph = _forest(dev, bcs)
    vol = g.h_column(torch.float32, dev) ** 3
    rng = np.random.default_rng(6)
    rhs = torch.as_tensor(rng.standard_normal((g.nb, 8, 8, 8)),
                          dtype=torch.float32, device=dev)
    b = rhs - torch.sum(rhs * vol) / (torch.sum(vol) * 512)
    kw = dict(tab=tab, ftab=ftab, vol=vol, graph=graph, maxiter=200)
    _, _, k_k = fa.fused_amr_bicgstab(g, b, **kw)
    _, _, k_p = fa.fused_amr_bicgstab(g, b, kernels=False, **kw)
    assert abs(int(k_k) - int(k_p)) <= 1
    # walls cut the coarse graph's couplings: at the 1e-4 stopping target
    # two answers differ by ~5e-4 there, so x is compared once converged
    tight = dict(kw, tol_abs=0.0, tol_rel=1e-6)
    x_k, _, _ = fa.fused_amr_bicgstab(g, b, **tight)
    x_p, _, _ = fa.fused_amr_bicgstab(g, b, kernels=False, **tight)
    _close(x_k, x_p, 1e-4)
    x_k2, _, _ = fa.fused_amr_bicgstab(g, b, **tight)
    assert torch.equal(x_k, x_k2)


def test_amr_driver_launch_counts_match_iterations(dev, monkeypatch,
                                                   tmp_path):
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    monkeypatch.setenv("CUP3D_FUSED", "1")
    d = build_driver(
        ("-bpdx 3 -bpdy 3 -bpdz 3 -levelMax 2 -levelStart 0 "
         "-extent 6.283185307179586 -initCond taylorGreen -Rtol 1.8 "
         "-Ctol 0.05 -CFL 0.4 -rampup 0 -poissonSolver iterative "
         "-nu 1e-3 -tend 0 -nsteps 3 -verbose 0 -path4serialization "
         f"{tmp_path}").split())
    d.init()
    assert set(d.grid.level.tolist()) == {0, 1}
    d.adapt_enabled = False
    fa.reset_launches()
    d.simulate()
    iters = [int(row["iters"]) for row in d.step_log]
    executed = sum(krylov.ITER_CHUNK * math.ceil(k / krylov.ITER_CHUNK)
                   for k in iters)
    assert fa.iterations["executed"] == executed > 0
    assert fa.launches == {"amr_update": executed,
                           "amr_getz_two": 2 * executed, "amr_getz_tile": 0,
                           "amr_lap": 2 * executed, "amr_axpy": executed,
                           "amr_finish": executed}
    assert torch.isfinite(d.state["vel"]).all()


# -- the tile-only getZ (B3, B10) and the CG getZ (B7) ----------------------


def test_tile_only_fused_solves_launch_getz_tile(dev):
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    grid = UniformGrid((32, 32, 32), (2.0,) * 3)
    rng = np.random.default_rng(7)
    rhs = torch.as_tensor(rng.standard_normal((32, 32, 32)),
                          dtype=torch.float32, device=dev)
    bt = krylov.to_lanes(rhs - torch.mean(rhs))
    fb.reset_launches()
    _, _, k_k = fb.fused_bicgstab(grid, bt, maxiter=300, two_level=False)
    ex = fb.iterations["executed"]
    assert fb.launches["getz_tile"] == 2 * ex > 0
    assert fb.launches["getz_two"] == 0
    _, _, k_p = fb.fused_bicgstab(grid, bt, maxiter=300, two_level=False,
                                  kernels=False)
    # tile-only solves converge erratically in f32 (ROADMAP queue C)
    assert abs(int(k_k) - int(k_p)) <= 3

    g, tab, ftab, _ = _forest(dev)
    vol = g.h_column(torch.float32, dev) ** 3
    rhs = torch.as_tensor(rng.standard_normal((g.nb, 8, 8, 8)),
                          dtype=torch.float32, device=dev)
    b = rhs - torch.sum(rhs * vol) / (torch.sum(vol) * 512)
    fa.reset_launches()
    fa.fused_amr_bicgstab(g, b, tab=tab, ftab=ftab, vol=vol, graph=None,
                          maxiter=300)
    ex = fa.iterations["executed"]
    assert fa.launches["amr_getz_tile"] == 2 * ex > 0
    assert fa.launches["amr_getz_two"] == 0


def _face_or_edge_rhs(rng, n, kind):
    """(n, 8, 8, 8) right-hand sides nonzero on one face (``face``: tile t
    on face t % 6) or one edge (``edge``: tile t on edge t % 12) only."""
    b = np.zeros((n, 8, 8, 8))
    for t in range(n):
        if kind == "face":
            axis, side = divmod(t % 6, 2)
            idx = [slice(None)] * 3
            idx[axis] = 7 * side
        else:
            axis, corner = divmod(t % 12, 4)
            idx = [7 * (corner & 1), 7 * (corner >> 1)]
            idx.insert(axis, slice(None))
        b[(t, *idx)] = rng.standard_normal(b[(t, *idx)].shape)
    return b


@pytest.mark.parametrize("n,iters,shift,rhs", [
    (22, 12, "tile", "random"), (300, 24, 0.0, "random"),
    # lanes-layout tile counts that leave a CTA's 8 tiles ragged
    *[(n, 24, sh, "random") for n in (1, 7, 9, 4099) for sh in (0.0, "tile")],
    # 0, 1 and 24 sweeps; right-hand sides nonzero on one face or one edge
    # of each tile (a wrong source lane at a tile face shows there)
    *[(37, it, "tile", rhs) for it in (0, 1, 24)
      for rhs in ("random", "face", "edge")]])
def test_getz_cg_kernel_matches_plain_version(dev, n, iters, shift, rhs):
    """B7 in the blocks and the lanes layout against the plain version
    (1e-5 of max |plain|; exact zeros at 0 sweeps), the lanes layout
    bitwise equal to the blocks layout, reruns bitwise."""
    from cup3d_tpu_torch.ops import getz_cg

    rng = np.random.default_rng(n)
    b = (rng.standard_normal((n, 8, 8, 8)) if rhs == "random"
         else _face_or_edge_rhs(rng, n, rhs))
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    if shift == "tile":
        shift = torch.as_tensor(rng.random((n, 1, 1, 1)) + 0.5,
                                dtype=torch.float32, device=dev)
    getz_cg.reset_launches()
    got = getz_cg.cg_tiles_blocks(b, iters, shift)
    want = getz_cg.cg_tiles_blocks(b, iters, shift, kernels=False)
    if iters == 0:
        assert torch.equal(got, torch.zeros_like(b))
    else:
        _close(got, want, 1e-5)
    # the lanes layout, read in place by the same kernel
    bt = b.permute(1, 2, 3, 0).contiguous()
    st = shift.reshape(n) if isinstance(shift, torch.Tensor) else shift
    got_l = getz_cg.cg_tiles_lanes(bt, iters, st)
    assert torch.equal(got_l, got.permute(1, 2, 3, 0))
    if iters:
        _close(got_l, getz_cg.cg_tiles_lanes(bt, iters, st, kernels=False),
               1e-5)
    assert torch.equal(getz_cg.cg_tiles_blocks(b, iters, shift), got)
    assert torch.equal(getz_cg.cg_tiles_lanes(bt, iters, st), got_l)
    torch.cuda.synchronize()
    assert getz_cg.launches["getz_cg"] == 4


def test_cg_getz_solve_launches_match_preconditioner_applications(
        dev, monkeypatch):
    """The two-level legacy solve under CUP3D_GETZ=cg: one getz_cg launch
    per preconditioner application, and the same solve with B7's plain
    version on the card within +-1 iteration and 1e-4 relative in x."""
    from cup3d_tpu_torch.ops import getz_cg

    monkeypatch.setenv("CUP3D_GETZ", "cg")
    monkeypatch.setenv("CUP3D_FUSED", "1")
    grid = UniformGrid((32, 32, 32), (2.0,) * 3)
    rng = np.random.default_rng(8)
    rhs = torch.as_tensor(rng.standard_normal((32, 32, 32)),
                          dtype=torch.float32, device=dev)
    solve = krylov.build_iterative_solver(grid, maxiter=200, two_level=True)
    getz_cg.reset_launches()
    fb.reset_launches()
    krylov.iterations["executed"] = 0
    x_k, st = solve(rhs, with_stats=True)
    ex = krylov.iterations["executed"]
    assert getz_cg.launches["getz_cg"] == 2 * ex > 0
    assert fb.iterations["executed"] == 0  # the legacy composition ran
    # the same solve with the plain getZ on the card
    plain = krylov.build_iterative_solver(grid, maxiter=200, two_level=True,
                                          kernels=False)
    getz_cg.reset_launches()
    x_p, st_p = plain(rhs, with_stats=True)
    assert getz_cg.launches["getz_cg"] == 0
    assert abs(int(st[1]) - int(st_p[1])) <= 1, (st, st_p)
    assert torch.isfinite(x_k).all()
    err = float(torch.max(torch.abs(x_k - x_p)) / torch.max(torch.abs(x_p)))
    assert err <= 1e-4, err


@pytest.mark.parametrize("D", [2, 4, 8])
def test_ring_shift_kernel_matches_plain_version(dev, D):
    """B14 (csrc/ring.cu) against its plain per-shard copy, bitwise: f32
    and int32 shards, an odd byte count (uint8), and source and
    destination slices off 16-byte (f32, 4 bytes in) and 4-byte (uint8,
    1 byte in) alignment; each launch counted once."""
    from cup3d_tpu_torch.parallel import ring

    ring.reset_launches()
    x = torch.randn((D, 7, 3, 8, 8, 8), device=dev)
    xi = torch.randint(-2 ** 31, 2 ** 31 - 1, (D, 5, 3), device=dev,
                       dtype=torch.int32)
    odd = torch.randint(0, 255, (D, 37), device=dev, dtype=torch.uint8)
    cases = [(x, s) for s in (1, -1, 3, -3)] + [(xi, 1), (odd, -3)]
    for a, s in cases:
        assert torch.equal(ring.ring_shift_kernel(a, s),
                           ring.ring_shift_plain(a, s))
    for dtype, off in ((torch.float32, 1), (torch.uint8, 1)):
        n = D * 45
        buf = torch.arange(n + 2 * off, device=dev).to(dtype)
        src = buf[off:off + n].view(D, 45)
        out_buf = torch.zeros(n + 2 * off, device=dev, dtype=dtype)
        out = out_buf[off:off + n].view(D, 45)
        ring.ring_shift_kernel(src, 3, out=out)
        assert torch.equal(out, ring.ring_shift_plain(src, 3))
        assert not out_buf[:off].any() and not out_buf[off + n:].any()
    torch.cuda.synchronize()
    assert ring.launches["ring_shift"] == len(cases) + 2
    # the dispatch: CUDA shards take the kernel unless CUP3D_RING_DMA=0;
    # the whole exchange is one launch
    ring.reset_launches()
    send = torch.randn((D, D, 4, 3), device=dev)
    assert torch.equal(ring.ring_all_to_all(send),
                       send.transpose(0, 1).contiguous())
    assert ring.launches["ring_shift"] == 1


@pytest.mark.parametrize("form", ["two", "tile", "column"])
@pytest.mark.parametrize("T_", [1, 7, 4099, 9472, 40001])
def test_getz_two_at_ragged_tile_counts(dev, T_, form):
    """B2's persistent grid and the tile-only getZ on its core, B3 (one
    h2) and B10 (a column of distinct per-block h^2), at tile counts it
    does not divide (fewer tiles than a CTA's warps; one round of the
    1-stage build; the 2-stage ring at config #3's block count and past
    one round), against the plain version within the getz bound (1e-5 of
    max |plain|), and a rerun bitwise."""
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    rng = np.random.default_rng(T_)
    w = torch.as_tensor(rng.standard_normal((T_, 8, 8, 8)),
                        dtype=torch.float32, device=dev)
    h2 = (2 * math.pi / 64) ** 2
    if form == "two":
        aux = torch.as_tensor(rng.standard_normal((8, T_)),
                              dtype=torch.float32, device=dev)
        aux[7] = 0.0
        counts, name = fb.launches, "getz_two"

        def getz(kernels=None):
            return fb.getz_two(w, aux, h2, kernels=kernels)
    else:
        if form == "column":
            h2 = torch.as_tensor(rng.uniform(1e-4, 4e-3, T_),
                                 dtype=torch.float32, device=dev)
        mod = fb if form == "tile" else fa
        counts = mod.launches
        name = "getz_tile" if form == "tile" else "amr_getz_tile"

        def getz(kernels=None):
            return mod.getz_tile(w, h2, kernels=kernels)
    fb.reset_launches()
    fa.reset_launches()
    got = getz()
    torch.cuda.synchronize()
    assert counts[name] == 1
    _close(got, getz(kernels=False), 1e-5)
    assert torch.equal(getz(), got)


@pytest.mark.parametrize("n", [8, 27, 9472, 9473])
def test_forest_getz_two_on_the_shared_core(dev, n):
    """B9 (the shared core's kGzAmr instance): the 1-stage build at 8 and
    27 blocks, the 2-stage ring at config #3's 9,472 and at a count its
    CTAs' warps do not divide; per-block h^2 of three levels and zc;
    within the getz bound of the plain version, a rerun bitwise."""
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    rng = np.random.default_rng(n)
    w, azf = (torch.as_tensor(rng.standard_normal((n, 8, 8, 8)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    zc = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
    lev = rng.integers(0, 3, n)
    h2 = torch.as_tensor((2 * math.pi / 128 / 2.0 ** lev) ** 2,
                         dtype=torch.float32, device=dev)
    fa.reset_launches()
    got = fa.getz_two(w, azf, zc, h2)
    torch.cuda.synchronize()
    assert fa.launches["amr_getz_two"] == 1
    _close(got, fa.getz_two(w, azf, zc, h2, kernels=False), 1e-5)
    assert torch.equal(fa.getz_two(w, azf, zc, h2), got)


@pytest.mark.parametrize("n", [41, 105])
def test_frenet_kernel_matches_plain_version(dev, n):
    """The device midline's Frenet recurrence (csrc/frenet.cu) against its
    plain loop at the fish's midline sizes (32^3 and 128^3), on a gait-like
    curvature: within 1e-5 of max |plain|, one launch, a rerun bitwise."""
    from cup3d_tpu_torch.models.fish import device_midline as dm

    rng = np.random.default_rng(n)
    s = np.linspace(0.0, 1.0, n)
    rs = np.cumsum(rng.uniform(0.002, 0.006, n))
    rk = 20.0 * s * np.sin(2 * np.pi * (s - 0.3))
    vk = 40.0 * s * np.cos(2 * np.pi * (s - 0.3))
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (rs, rk, vk))
    dm.launches["frenet"] = 0
    got = dm._frenet_scan_dev(*args)
    torch.cuda.synchronize()
    assert dm.launches["frenet"] == 1
    want = dm._frenet_scan_dev(*args, kernels=False)
    for k in ("r", "v", "nor", "vnor", "bin", "vbin"):
        _close(got[k], want[k], 1e-5)
    again = dm._frenet_scan_dev(*args)
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_pipelined_fish_matches_the_port_on_the_cpu(dev, monkeypatch,
                                                     tmp_path):
    """The 32^3 fish pipelined (the rigid state chained on the device,
    the packs read through the QoI stream) for 6 steps on the card and on
    the CPU: the rigid state within 1e-5, velocity within 1e-5 of
    max|u|, iterations +-1 a step; the card's launches equal to its
    executed iterations."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.stream.qoi import QoIStream

    # reads at backpressure only: the same staleness on both devices
    monkeypatch.setattr(QoIStream, "_ready", staticmethod(lambda b: False))
    monkeypatch.setenv("CUP3D_FUSED", "1")
    argv = ("-bpdx 4 -bpdy 4 -bpdz 4 -extent 1 -CFL 0.4 -nu 1e-3 -rampup 100 "
            "-poissonSolver iterative -tend 0 -nsteps 6 -verbose 0 "
            f"-pipelined 1 -path4serialization {tmp_path}").split() + [
                "-factory-content", FISH]
    runs = {}
    for device in ("cpu", "cuda"):
        d = build_driver(argv + ["-device", device])
        d.init()
        fb.reset_launches()
        d.simulate()
        runs[device] = d
    card, cpu = runs["cuda"], runs["cpu"]
    iters = [int(row["iters"]) for row in card.step_log]
    assert len(iters) == 6
    executed = sum(krylov.ITER_CHUNK * math.ceil(k / krylov.ITER_CHUNK)
                   for k in iters)
    assert fb.iterations["executed"] == executed > 0
    assert fb.launches["getz_two"] == fb.launches["lap"] == 2 * executed
    for a, b in zip(card.step_log, cpu.step_log):
        assert abs(a["iters"] - b["iters"]) <= 1
        assert a["dt"] == pytest.approx(b["dt"], rel=1e-5)
    oc, op = card.sim.obstacles[0], cpu.sim.obstacles[0]
    for k in ("transVel", "angVel", "position", "quaternion"):
        assert np.abs(np.asarray(getattr(oc, k))
                      - np.asarray(getattr(op, k))).max() <= 1e-5, k
    _close(card.sim.state["vel"].cpu(), cpu.sim.state["vel"], 1e-5)


def _wide(t: torch.Tensor, pad: int = 3) -> torch.Tensor:
    """t's values as a view inside wider rows of a larger buffer."""
    big = torch.full(t.shape[:-1] + (t.shape[-1] + 2 * pad,), float("nan"),
                     device=t.device, dtype=t.dtype)
    big[..., pad:pad + t.shape[-1]] = t
    return big[..., pad:pad + t.shape[-1]]


@pytest.mark.parametrize("D", [2, 4, 8])
def test_ring_steps_strided_and_in_place(dev, D):
    """B14's strided reads and landings against its plain version,
    bitwise: the all-to-all from a strided send buffer into a view of a
    wider buffer (faces.py's recv region) in one launch, and in D
    launches of one step each; a slab's x-ghost slice and one component
    of a vector slab (words at a 12-byte stride), read in place."""
    from cup3d_tpu_torch.parallel import compat, ring

    send = torch.randn((D, D, 5, 3, 8), device=dev)
    want = compat.all_to_all(send)
    for src in (send, _wide(send)):
        ext = torch.full((D, D * 5 + 3, 3, 8), float("nan"), device=dev)
        region = ext[:, 2:2 + D * 5].unflatten(1, (D, 5))
        ring.reset_launches()
        ring.ring_all_to_all(src, out=region)
        assert ring.launches["ring_shift"] == 1
        assert torch.equal(region, want)
        assert ext[:, :2].isnan().all() and ext[:, 2 + D * 5:].isnan().all()
        steps = torch.empty_like(send)
        for k in range(D):
            ring.ring_steps_kernel(src, steps, k, 1, chunked=True)
        assert torch.equal(steps, want)
        assert torch.equal(
            ring.ring_steps_plain(src, torch.empty_like(send), 0, D, True),
            want)
    f = torch.randn((D, 6, 9, 10), device=dev)
    u = torch.randn((D, 6, 9, 10, 3), device=dev)
    for x in (f[:, 4:], f[:, :2], u[..., 1][:, 3:], u[..., 2]):
        for k in (1, -1):
            assert torch.equal(ring.ring_shift(x, k),
                               ring.ring_shift_plain(x, k))
    torch.cuda.synchronize()


@pytest.mark.parametrize("bcs", [("periodic", "wall", "periodic"),
                                 ("wall",) * 3])
def test_getz_two_and_lap_on_wall_bounded_lanes(dev, bcs):
    """B2 and B4 on a wall-bounded grid's lanes (BASELINE config #5's
    walls in y, and walls everywhere): the face planes and the coarse aux
    built as the fused driver builds them, against the plain versions,
    and each rerun bitwise."""
    grid = UniformGrid((64, 32, 32), (2.0, 1.0, 1.0), bcs)
    rng = np.random.default_rng(23)
    T = grid.ncells // 512
    w, a = (torch.as_tensor(rng.standard_normal((T, 8, 8, 8)),
                            dtype=torch.float32, device=dev)
            for _ in range(2))
    zc = krylov._make_coarse_core(grid, 8)(torch.sum(w, dim=(1, 2, 3)))
    aux = torch.cat([krylov.make_face_deltas(grid, 8)(zc), zc[None, :],
                     zc.new_zeros(1, T)], dim=0)
    h2 = grid.h * grid.h
    got = fb.getz_two(w, aux, h2)
    _close(got, fb.getz_two(w, aux, h2, kernels=False), 1e-5)
    assert torch.equal(got, fb.getz_two(w, aux, h2))
    geom = fb.LapGeom(grid)
    got = fb.lap(w, a, 1.0 / h2, geom)
    want = fb.lap(w, a, 1.0 / h2, geom, kernels=False)
    assert torch.equal(got[0], want[0])
    for k in (1, 2):
        _close(got[k], want[k], 1e-5, _tile_abs_sum(
            (a if k == 1 else want[0]) * want[0]))
    again = fb.lap(w, a, 1.0 / h2, geom)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("case", ["free", "spheres"])
def test_pipelined_forest_matches_the_port_on_the_cpu(dev, monkeypatch,
                                                      tmp_path, case):
    """The pipelined forest for 3 steps on the card and on the CPU: the
    Taylor-Green forest at bpd 3 on the device dt chain, or two spheres
    on a bpd-1 forest of levelMax 2 at a fixed dt (the JAX package's
    pipelined case): iterations +-1 and dt within 1e-5 a step, velocity
    within 1e-5 of max|u|, the spheres' rigid state within 1e-5; the
    card's forest kernel launches equal to its executed iterations."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.stream.qoi import QoIStream

    monkeypatch.setattr(QoIStream, "_ready", staticmethod(lambda b: False))
    monkeypatch.setenv("CUP3D_FUSED", "1")
    if case == "free":
        argv = ("-bpdx 3 -bpdy 3 -bpdz 3 -levelMax 2 -levelStart 0 "
                "-extent 6.283185307179586 -initCond taylorGreen -Rtol 1.8 "
                "-Ctol 0.05 -CFL 0.4 -rampup 0 -dtDevice 1").split()
    else:
        argv = ("-bpdx 1 -bpdy 1 -bpdz 1 -levelMax 2 -levelStart 1 -extent 1 "
                "-Rtol 5 -Ctol 0.1 -CFL 0.4 -rampup 0 -dt 0.001").split() + [
                    "-factory-content",
                    "Sphere radius=0.12 xpos=0.35 ypos=0.5 zpos=0.5 xvel=0.3 "
                    "bForcedInSimFrame=1 bFixFrameOfRef=1\n"
                    "Sphere radius=0.1 xpos=0.7 ypos=0.45 zpos=0.5"]
    argv += ("-nu 1e-3 -poissonSolver iterative -tend 0 -nsteps 3 "
             f"-verbose 0 -pipelined 1 -path4serialization {tmp_path}"
             ).split()
    runs = {}
    for device in ("cpu", "cuda"):
        d = build_driver(argv + ["-device", device])
        d.init()
        d.adapt_enabled = False
        fa.reset_launches()
        d.simulate()
        runs[device] = d
    card, cpu = runs["cuda"], runs["cpu"]
    assert card._dt_chain == cpu._dt_chain == (case == "free")
    iters = [int(row["iters"]) for row in card.step_log]
    assert len(iters) == 3
    executed = sum(krylov.ITER_CHUNK * math.ceil(k / krylov.ITER_CHUNK)
                   for k in iters)
    assert fa.iterations["executed"] == executed > 0
    assert fa.launches["amr_getz_two"] == fa.launches["amr_lap"] == \
        2 * executed
    for a, b in zip(card.step_log, cpu.step_log):
        assert abs(a["iters"] - b["iters"]) <= 1
        assert a["dt"] == pytest.approx(b["dt"], rel=1e-5)
    for oc, op in zip(card.obstacles, cpu.obstacles):
        for k in ("transVel", "angVel", "position"):
            assert np.abs(np.asarray(getattr(oc, k))
                          - np.asarray(getattr(op, k))).max() <= 1e-5, k
    _close(card.state["vel"].cpu(), cpu.state["vel"], 1e-5)


# -- bf16 storage: the bf16 builds of B1-B6 and B8-B13 ------------------------


def _bf16(t):
    return t.to(torch.bfloat16)


def _hold_bf16(got, want, floor_rtol):
    """chip_smoke.py's stage rule for a stored bf16 output."""
    def bits(t):
        b = t.view(torch.int16).to(torch.int32)
        return torch.where(b < 0, -(b & 0x7FFF), b)

    og, ow = bits(got), bits(want)
    share = float((og == ow).double().mean())
    err = torch.abs(got.float() - want.float())
    floor = floor_rtol * float(torch.max(torch.abs(want.float())))
    ulps = int(torch.max(torch.where(err > floor, torch.abs(og - ow), 0)))
    assert share >= 0.999 and ulps <= 1, (share, ulps)


def _hold_part(got, own, terms):
    tol = 2e-5 * torch.sum(torch.abs(terms.float()), dim=(1, 2, 3))
    assert bool(torch.all(torch.abs(got - own) <= tol))


def test_bf16_stage_kernels_match_plain_versions(dev):
    fb.reset_launches()
    r, p, v, rhat, w, a, y, z = (_bf16(t) for t in _vecs(dev, 11, 8))
    x = _vecs(dev, 12, 1)[0]
    for vals in ((0.7, 1.3, 0.0), (0.0, 1.3, 1.0)):
        want = fb.update(r, p.clone(), v, rhat.clone(), _row(dev, *vals),
                         kernels=False)
        got = fb.update(r, p.clone(), v, rhat.clone(), _row(dev, *vals))
        _hold_bf16(got[0], want[0], 2e-6)
        _hold_bf16(got[1], want[1], 2e-6)
        _hold_part(got[2], fb._cellsum(got[0]), got[0])
    aux = torch.randn((8, T), device=dev)
    _hold_bf16(fb.getz_two(w, aux, 0.01),
               fb.getz_two(w, aux, 0.01, kernels=False), 1e-5)
    _hold_bf16(fb.getz_tile(w, 0.01), fb.getz_tile(w, 0.01, kernels=False),
               1e-5)
    geom = fb.LapGeom(_lap_grid(("periodic", "wall", "freespace")))
    want = fb.lap(w, a, 100.0, geom, kernels=False)
    got = fb.lap(w, a, 100.0, geom)
    assert torch.equal(got[0], want[0])
    aw = got[0].float()
    _hold_part(got[1], fb._cellsum(a.float() * aw), a.float() * aw)
    _hold_part(got[2], fb._cellsum(aw * aw), aw * aw)
    want = fb.axpy(r, v, _row(dev, 0.37), kernels=False)
    got = fb.axpy(r, v, _row(dev, 0.37))
    _hold_bf16(got[0], want[0], 2e-6)
    _hold_part(got[1], fb._cellsum(got[0]), got[0])
    sc = _row(dev, 0.37, 1.21)
    want = fb.finish(x.clone(), y, z, r.clone(), v, rhat, sc, kernels=False)
    got = fb.finish(x.clone(), y, z, r.clone(), v, rhat, sc)
    _close(got[0], want[0], 2e-6)
    _hold_bf16(got[1], want[1], 2e-6)
    rk = got[1].float()
    _hold_part(got[2], fb._cellsum(rk * rk), rk * rk)
    _hold_part(got[3], fb._cellsum(rhat.float() * rk), rhat.float() * rk)
    torch.cuda.synchronize()
    assert fb.launches_bf16 == {"update": 2, "getz_two": 1, "getz_tile": 1,
                                "lap": 1, "axpy": 1, "finish": 1}
    assert not any(fb.launches.values())
    with pytest.raises(ValueError, match="float32"):  # x stays f32
        fb.finish(_bf16(x), y, z, r.clone(), v, rhat, sc)
    with pytest.raises(ValueError, match="bfloat16"):  # one storage
        fb.axpy(r, v.float(), _row(dev, 0.5))


def test_bf16_forest_stage_kernels_match_plain_versions(dev):
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    g, tab, ftab, _ = _forest(dev)
    n = g.nb
    rng = np.random.default_rng(13)

    def vec(dtype=torch.bfloat16):
        return torch.as_tensor(rng.standard_normal((n, 8, 8, 8)),
                               dtype=torch.float32, device=dev).to(dtype)

    def col(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    vol, h2 = col(g.h ** 3), col(g.h ** 2)
    wt = vol[:, None, None, None]
    fa.reset_launches()
    r, p, v, rhat, w, y = (vec() for _ in range(6))
    for vals in ((0.7, 1.3, 0.0), (0.0, 1.3, 1.0)):
        want = fa.update(r, p.clone(), v, rhat.clone(), vol, _row(dev, *vals),
                         kernels=False)
        got = fa.update(r, p.clone(), v, rhat.clone(), vol, _row(dev, *vals))
        _hold_bf16(got[0], want[0], 2e-6)
        _hold_part(got[2], fb._cellsum(got[0].float() * wt),
                   got[0].float() * wt)
    azf, zc = vec(torch.float32), col(rng.standard_normal(n))
    _hold_bf16(fa.getz_two(w, azf, zc, h2),
               fa.getz_two(w, azf, zc, h2, kernels=False), 1e-5)
    _hold_bf16(fa.getz_tile(w, h2), fa.getz_tile(w, h2, kernels=False), 1e-5)
    lab = tab.assemble_scalar(w.float(), 8).contiguous()
    corr = vec(torch.float32)
    want = fa.lap(lab, corr, rhat, 1.0 / h2, kernels=False)
    got = fa.lap(lab, corr, rhat, 1.0 / h2)
    _hold_bf16(got[0], want[0], 2e-6)
    aw = got[0].float()
    _hold_part(got[1], fb._cellsum(rhat.float() * aw), rhat.float() * aw)
    want = fa.axpy(r, v, vol, _row(dev, 0.37), kernels=False)
    got = fa.axpy(r, v, vol, _row(dev, 0.37))
    _hold_bf16(got[0], want[0], 2e-6)
    x = vec(torch.float32)
    sc = _row(dev, 0.37, 1.21)
    want = fa.finish(x.clone(), y, w, r.clone(), v, rhat, sc, kernels=False)
    got = fa.finish(x.clone(), y, w, r.clone(), v, rhat, sc)
    _close(got[0], want[0], 2e-6)
    _hold_bf16(got[1], want[1], 2e-6)
    torch.cuda.synchronize()
    assert fa.launches_bf16 == {"amr_update": 2, "amr_getz_two": 1,
                                "amr_getz_tile": 1, "amr_lap": 1,
                                "amr_axpy": 1, "amr_finish": 1}
    assert not any(fa.launches.values())


def test_bf16_fused_solves_match_plain(dev):
    """A bf16 fused solve on each grid, kernels against plain versions:
    iterations +-1, x within 1e-2 of max |x| (the periodic systems' x up
    to a constant: mean-free), the reported residual at the target, the
    bf16 launches equal to the executed iterations."""
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    grid = UniformGrid((32, 32, 32), (2.0,) * 3)
    rng = np.random.default_rng(14)
    rhs = torch.as_tensor(rng.standard_normal((32,) * 3),
                          dtype=torch.float32, device=dev)
    bt = krylov.to_lanes(rhs - torch.mean(rhs))
    kw = dict(maxiter=200, store_dtype=torch.bfloat16)
    fb.reset_launches()
    x_k, rn_k, k_k = fb.fused_bicgstab(grid, bt, **kw)
    assert fb.launches_bf16["update"] == fb.iterations["executed"] > 0
    x_p, _, k_p = fb.fused_bicgstab(grid, bt, kernels=False, **kw)
    assert abs(int(k_k) - int(k_p)) <= 1
    _close(x_k - torch.mean(x_k), x_p - torch.mean(x_p), 1e-2)
    assert float(rn_k) <= 1.01 * max(1e-6, 1e-4 * float(
        torch.sqrt(torch.sum(bt * bt))))
    g, tab, ftab, graph = _forest(dev)
    vol = g.h_column(torch.float32, dev) ** 3
    rhs = torch.as_tensor(rng.standard_normal((g.nb, 8, 8, 8)),
                          dtype=torch.float32, device=dev)
    b = rhs - torch.sum(rhs * vol) / (torch.sum(vol) * 512)
    kw = dict(tab=tab, ftab=ftab, vol=vol, graph=graph, maxiter=200,
              store_dtype=torch.bfloat16)
    fa.reset_launches()
    x_k, _, k_k = fa.fused_amr_bicgstab(g, b, **kw)
    assert fa.launches_bf16["amr_update"] == fa.iterations["executed"] > 0
    x_p, _, k_p = fa.fused_amr_bicgstab(g, b, kernels=False, **kw)
    assert abs(int(k_k) - int(k_p)) <= 1

    def mean_free(x):  # the periodic forest's x is defined up to a constant
        return x - torch.sum(x * vol) / (torch.sum(vol) * 512)

    _close(mean_free(x_k), mean_free(x_p), 1e-2)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("bc_x", ["periodic", "wall"])
def test_ring_shift_at_the_slab_halo_shapes(dev, D, bc_x):
    """B14 at the x-slab megaloop's halo shapes against its plain version,
    bitwise: the (D, 3, ny, nz) ghost planes of one component of (D, sx,
    ny, nz, 3) slabs (words at a 12-byte stride) and of the scalar slabs
    of the projection's divergence; then RK3 on the slabs
    (``rk3_step(pad=pad_slab_vector)``) bitwise the unsharded RK3 on the
    card, with 3 components x 2 ring shifts a stage launched."""
    from cup3d_tpu_torch.grid.uniform import BC
    from cup3d_tpu_torch.ops.advection import rk3_step
    from cup3d_tpu_torch.parallel import ring

    n, w = 32, 3
    sx = n // D
    gen = torch.Generator(device=dev).manual_seed(5)
    u = torch.randn((D, sx, n, n, 3), device=dev, generator=gen)
    f = torch.randn((D, sx, n, n), device=dev, generator=gen)
    for x in ([u[..., c][:, sx - w:] for c in range(3)]
              + [u[..., c][:, :w] for c in range(3)]
              + [f[:, sx - 1:], f[:, :1]]):
        for k in (1, -1):
            assert torch.equal(ring.ring_shift_kernel(x, k),
                               ring.ring_shift_plain(x, k))
    grid = UniformGrid((n, n, n), (1.0,) * 3,
                       (BC(bc_x), BC.periodic, BC.wall))
    vel = u.reshape(n, n, n, 3)
    uinf = torch.tensor([0.2, -0.1, 0.3], device=dev)
    dt = torch.tensor(1e-3, device=dev)
    want = rk3_step(grid, vel, dt, 1e-2, uinf)
    ring.reset_launches()
    got = rk3_step(grid, u, dt, 1e-2, uinf,
                   pad=lambda v, wd: ring.pad_slab_vector(grid, v, wd))
    torch.cuda.synchronize()
    assert ring.launches["ring_shift"] == 3 * 3 * 2
    assert torch.equal(got.reshape(n, n, n, 3), want)


# -- the fleet's lanes: B8, B12, B13 with a scalar row a lane; the batched
# -- Frenet kernel -------------------------------------------------------------


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_forest_stages_take_a_scalar_row_a_lane(dev, store):
    """B8, B12 and B13 on L = 4 lanes of the forest's blocks, stacked
    along the block axis, each lane its own (8,) row of an (L, 8) block:
    each lane's outputs bitwise the one-lane launch on its blocks, the
    vectors within the stage tolerances of the plain versions, and the
    (1, 8) call bitwise the (8,) one."""
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    g, _, _, _ = _forest(dev)
    n, L = g.nb, 4
    rng = np.random.default_rng(9)

    def vec(dtype=store):
        return torch.as_tensor(rng.standard_normal((L * n, 8, 8, 8)),
                               dtype=torch.float32, device=dev).to(dtype)

    vol = torch.as_tensor(np.tile(g.h ** 3, L), dtype=torch.float32,
                          device=dev)
    rows = torch.as_tensor(rng.standard_normal((L, 8)), dtype=torch.float32,
                           device=dev)
    rows[:, 2] = torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev)
    r, p, v, rh, y, z, s, t = (vec() for _ in range(8))
    x = vec(torch.float32)
    fa.reset_launches()
    lanes = (fa.update(r, p.clone(), v, rh.clone(), vol, rows),
             fa.axpy(r, v, vol, rows),
             fa.finish(x.clone(), y, z, s.clone(), t, rh, rows))
    torch.cuda.synchronize()
    counts = fa.launches_bf16 if store == torch.bfloat16 else fa.launches
    assert (counts["amr_update"], counts["amr_axpy"],
            counts["amr_finish"]) == (1, 1, 1)
    plain = (fa.update(r, p.clone(), v, rh.clone(), vol, rows,
                       kernels=False),
             fa.axpy(r, v, vol, rows, kernels=False),
             fa.finish(x.clone(), y, z, s.clone(), t, rh, rows,
                       kernels=False))
    for lane in range(L):
        sl = slice(lane * n, (lane + 1) * n)
        one = (fa.update(r[sl], p[sl].clone(), v[sl], rh[sl].clone(),
                         vol[sl], rows[lane].contiguous()),
               fa.axpy(r[sl], v[sl], vol[sl], rows[lane].contiguous()),
               fa.finish(x[sl].clone(), y[sl], z[sl], s[sl].clone(), t[sl],
                         rh[sl], rows[lane].contiguous()))
        for got, want in zip(lanes, one):
            for a, b in zip(got, want):
                assert torch.equal(a[sl], b)
    # the vectors (the per-block partials against the plain sums are
    # test_forest_stage_kernels_match_plain_versions's, one lane)
    for got, want in zip(lanes, plain):
        for a, b in zip(got, want):
            if a.dim() > 1:
                _close(a.float(), b.float(),
                       2e-6 if store == torch.float32 else 8e-3)
    one = fa.axpy(r[:n], v[:n], vol[:n], rows[:1].contiguous())
    old = fa.axpy(r[:n], v[:n], vol[:n], rows[0].contiguous())
    assert all(torch.equal(a, b) for a, b in zip(one, old))
    with pytest.raises(ValueError):
        fa.axpy(r, v, vol, rows[:3].contiguous())


@pytest.mark.parametrize("n", [41, 105])
def test_frenet_kernel_lanes_match_plain_per_lane(dev, n):
    """The Frenet kernel on L = 3 midlines at once (one launch, a CTA a
    lane) against the plain loop on each lane: within 1e-5 of max
    |plain|; the lane launch bitwise the one-midline launches."""
    from cup3d_tpu_torch.models.fish import device_midline as dm

    rng = np.random.default_rng(n)
    s = np.linspace(0.0, 1.0, n)
    rs = np.stack([np.cumsum(rng.uniform(0.002, 0.006, n))
                   for _ in range(3)])
    rk = np.stack([a * s * np.sin(2 * np.pi * (s - 0.3))
                   for a in (20.0, 15.0, 25.0)])
    vk = np.stack([2 * a * s * np.cos(2 * np.pi * (s - 0.3))
                   for a in (20.0, 15.0, 25.0)])
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (rs, rk, vk))
    dm.launches["frenet"] = 0
    got = dm._frenet_scan_dev(*args)
    torch.cuda.synchronize()
    assert dm.launches["frenet"] == 1
    for lane in range(3):
        one = tuple(a[lane].contiguous() for a in args)
        want = dm._frenet_scan_plain(*one)
        solo = dm._frenet_scan_dev(*one)
        for k in ("r", "v", "nor", "vnor", "bin", "vbin"):
            _close(got[k][lane], want[k], 1e-5)
            assert torch.equal(got[k][lane], solo[k])


def test_capture_window_attributes_the_fused_solve(dev, monkeypatch,
                                                   tmp_path):
    """One real torch.profiler window on the card over a step of the
    fused TGV solve: the kernels land in the three BiCGSTAB sections, the
    sum invariant holds, nothing is counted as a telemetry failure, and
    the device record reaches the sink."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.obs import metrics as om
    from cup3d_tpu_torch.obs import profile as op
    from cup3d_tpu_torch.obs import trace as ot

    monkeypatch.setenv("CUP3D_FUSED", "1")
    sink = ot.TraceSink(enabled=True, directory=str(tmp_path / "trace"))
    ctl = op.CaptureController(plan="once:1", window_steps=1, sink=sink,
                               directory=str(tmp_path / "prof"))
    monkeypatch.setattr(op, "CONTROLLER", ctl)
    before = om.snapshot()
    d = build_driver(
        ("-bpdx 4 -bpdy 4 -bpdz 4 -extent 6.283185307179586 "
         "-initCond taylorGreen -poissonSolver iterative -nu 1e-3 "
         "-dt 1e-3 -tend 0 -nsteps 3 -verbose 0 -path4serialization "
         f"{tmp_path}").split())
    d.init()
    d.simulate()
    after = om.snapshot()
    for key in ("profile.capture_errors", "profile.parse_errors",
                "profile.empty_captures"):
        assert after.get(key, 0) == before.get(key, 0), key
    attr = ctl.last_attribution
    assert ctl.windows == 1 and attr is not None
    for s in ("bicgstab.update", "bicgstab.getz_lap", "bicgstab.finish"):
        assert attr.sections.get(s, 0.0) > 0.0, attr.sections
    assert abs(sum(attr.sections.values()) + attr.other_ms
               - attr.total_ms) < 1e-9 * max(1.0, attr.total_ms)
    sink.close()
    import json

    with open(sink.jsonl_path) as f:
        recs = [json.loads(x) for x in f if x.strip()]
    dev_recs = [r for r in recs if r.get("kind") == "device"]
    assert len(dev_recs) == 1 and ot.validate_step_record(dev_recs[0]) == []
