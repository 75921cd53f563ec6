"""The fleet's forest lanes (``amr_tgv``) under ``CUP3D_FUSED=1`` against
the JAX package's, on the CPU, and the lane-batched fused forest solve.

- two ``amr_tgv`` lanes at bpd 2, levelMax 2 drained by both packages'
  FleetServer: KE to 1e-4 relative, velocity to 1e-4 absolute, time and
  dt to 1e-4 relative, Krylov iterations within 1 a step;
- lanes of a genuinely two-level forest (bpd 3, Rtol 1.8, Ctol 0.05:
  coarse-fine faces, flux corrections, the block-graph coarse level)
  against the port's solo forest step (sim/amr.make_amr_tgv_step), fused
  and (``CUP3D_FUSED=0``) legacy;
- the stages B8, B12 and B13 with (L, 8) scalar rows: each lane's blocks
  bitwise the one-row call on them; the lane-batched solve against one
  solve a lane;
- a NaN injected into one forest lane leaves its siblings bitwise equal to
  the unfaulted drain."""

import numpy as np
import pytest
import torch

from cup3d_tpu.fleet.server import FleetServer as JFleetServer
from cup3d_tpu.resilience import faults as jax_faults
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.fleet.server import DONE, FleetServer
from cup3d_tpu_torch.ops import amr_ops
from cup3d_tpu_torch.ops import fused_amr_bicgstab as fab
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.sim.amr import AMRSimulation, make_amr_tgv_step
from cup3d_tpu_torch.sim.dtpolicy import ramped_cfl

KE_RTOL = 1e-4
VEL_ATOL = 1e-4
TIME_RTOL = 1e-4
ITERS_SLACK = 1

SPECS = (dict(kind="amr_tgv", bpd=2, levelMax=2, nsteps=8, cfl=0.3),
         dict(kind="amr_tgv", bpd=2, levelMax=2, nsteps=8, cfl=0.25))
#: a two-level forest (111 blocks): coarse-fine faces and the coarse level
TWO_LEVEL = dict(kind="amr_tgv", bpd=3, levelMax=2, levelStart=0, rtol=1.8,
                 ctol=0.05, nsteps=8)


@pytest.fixture(autouse=True)
def _fused(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("CUP3D_FUSED", "1")
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()
    torch.set_num_threads(n)


def _drain(cls, tmp, specs, **kw):
    srv = cls(workdir=str(tmp), **kw)
    ids = [srv.submit(f"tenant-{i}", dict(sp)) for i, sp in enumerate(specs)]
    srv.drain()
    return srv, ids


def _ke(vel):
    v = np.asarray(vel, np.float64)
    return float(np.sum(v * v))


def _close(a, b):
    ke_a, ke_b = _ke(a["vel"]), _ke(b["vel"])
    assert abs(ke_a - ke_b) <= KE_RTOL * max(abs(ke_b), 1e-12)
    np.testing.assert_allclose(a["vel"], b["vel"], rtol=0, atol=VEL_ATOL)
    for k in ("time", "dt"):
        np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=TIME_RTOL)


def test_amr_lanes_match_jax_fleet(tmp_path):
    """The port's forest lanes within the JAX package's bounds of the JAX
    server's lanes, Krylov iterations within one a step."""
    jsrv, jids = _drain(JFleetServer, tmp_path / "jax", SPECS)
    tsrv, tids = _drain(FleetServer, tmp_path / "port", SPECS,
                        device="cpu")
    for jid, tid in zip(jids, tids):
        assert jsrv.poll(jid)["status"] == DONE
        assert tsrv.poll(tid)["status"] == DONE
        jl = {k: np.asarray(v) for k, v in jsrv.lane_state(jid).items()}
        tl = {k: np.asarray(v) for k, v in tsrv.lane_state(tid).items()}
        assert sorted(jl) == sorted(tl)
        for k in jl:
            assert jl[k].shape == tl[k].shape and jl[k].dtype == tl[k].dtype
        _close(tl, jl)
        jr, tr = jsrv._jobs[jid].rows, tsrv._jobs[tid].rows
        assert np.all(np.abs(jr[:, 1] - tr[:, 1]) <= ITERS_SLACK)
        assert np.all(tr[:, 1] > 0)
        np.testing.assert_allclose(tr[:, -3:], jr[:, -3:], rtol=TIME_RTOL)


def _solo_forest(tmp, spec, cfl):
    """The port's solo forest step (sim/amr.make_amr_tgv_step) on the
    spec's frozen topology, with the lane's CFL chain."""
    cfg = SimulationConfig(
        bpdx=spec["bpd"], bpdy=spec["bpd"], bpdz=spec["bpd"],
        levelMax=spec["levelMax"],
        levelStart=spec.get("levelStart", spec["levelMax"] - 1),
        Rtol=spec.get("rtol", 1e9), Ctol=spec.get("ctol", -1.0),
        extent=2 * np.pi, nu=0.02, initCond="taylorGreen",
        step_2nd_start=0, nsteps=spec["nsteps"], tend=0.0, CFL=cfl,
        rampup=0, pipelined=True, verbose=False, freqDiagnostics=0,
        path4serialization=str(tmp))
    s = AMRSimulation(cfg, device="cpu")
    s.init()
    s.adapt_enabled = False
    uinf = s.uinf_device()
    carry = {"vel": s.state["vel"], "p": s.state["p"],
             "umax": torch.max(torch.abs(s.state["vel"] + uinf)),
             "time": torch.tensor(s.time, dtype=s.dtype),
             "dt": torch.tensor(s.dt, dtype=s.dtype)}
    step = make_amr_tgv_step(s)
    rows = []
    for k in range(spec["nsteps"]):
        carry, row = step(carry, torch.tensor(ramped_cfl(cfl, k, 0),
                                              dtype=s.dtype))
        rows.append(row.numpy())
    return {k: v.numpy() for k, v in carry.items()}, np.asarray(rows), s


@pytest.mark.parametrize("fused", ["1", "0"])
def test_two_level_lanes_match_port_solo(tmp_path, monkeypatch, fused):
    """Two lanes of a two-level forest (fused and legacy solves) each
    within the bounds of the port's solo forest step on its spec."""
    monkeypatch.setenv("CUP3D_FUSED", fused)
    cfls = (0.3, 0.35)
    specs = [dict(TWO_LEVEL, cfl=c) for c in cfls]
    srv, ids = _drain(FleetServer, tmp_path / "port", specs, device="cpu")
    for i, (jid, cfl) in enumerate(zip(ids, cfls)):
        assert srv.poll(jid)["status"] == DONE
        solo, rows, s = _solo_forest(tmp_path / f"solo{i}", TWO_LEVEL, cfl)
        assert s.grid.nb == 111 and len(set(s.grid.level)) == 2
        lane = {k: np.asarray(v) for k, v in srv.lane_state(jid).items()}
        _close(lane, solo)
        lrows = srv._jobs[jid].rows
        assert np.all(np.abs(lrows[:, 1] - rows[:, 1]) <= ITERS_SLACK)


def test_lane_rows_of_b8_b12_b13_bitwise():
    """With (L, 8) scalar rows, each lane's blocks of B8, B12 and B13
    (plain versions) equal the one-row call on those blocks bitwise, at
    f32 and bf16 storage."""
    g = torch.Generator().manual_seed(7)
    L, nb = 3, 5
    for store in (torch.float32, torch.bfloat16):
        def v(n=L * nb):
            return torch.randn((n, 8, 8, 8), generator=g).to(store)

        r, p, vv, rh, y, z, s_, t = (v() for _ in range(8))
        x = torch.randn((L * nb, 8, 8, 8), generator=g)
        vol = torch.rand(L * nb, generator=g)
        rows = torch.randn((L, 8), generator=g)
        rows[:, 2] = torch.tensor([0.0, 1.0, 0.0])  # one lane breaks down
        got_u = fab.update(r, p.clone(), vv, rh.clone(), vol, rows)
        got_a = fab.axpy(r, vv, vol, rows)
        got_f = fab.finish(x.clone(), y, z, s_.clone(), t, rh, rows)
        for lane in range(L):
            sl = slice(lane * nb, (lane + 1) * nb)
            want_u = fab.update(r[sl], p[sl].clone(), vv[sl], rh[sl].clone(),
                                vol[sl], rows[lane])
            want_a = fab.axpy(r[sl], vv[sl], vol[sl], rows[lane])
            want_f = fab.finish(x[sl].clone(), y[sl], z[sl], s_[sl].clone(),
                                t[sl], rh[sl], rows[lane])
            for got, want in ((got_u, want_u), (got_a, want_a),
                              (got_f, want_f)):
                for a, b in zip(got, want):
                    assert torch.equal(a[sl], b), store
        with pytest.raises(ValueError):
            fab.axpy(r, vv, vol, torch.zeros((4, 8)))


def test_lane_batched_solve_matches_one_solve_a_lane(tmp_path):
    """The fused forest solve of two systems as lanes against one solve a
    system, on the two-level forest: the same solution to the stopping
    tolerance's scale and the same iteration counts within one."""
    s = _solo_forest(tmp_path / "f", dict(TWO_LEVEL, nsteps=0), 0.3)[2]
    geo = s._geo
    g = torch.Generator().manual_seed(3)
    b = torch.randn((2,) + tuple(s.state["p"].shape), generator=g)
    b = b * geo.mask
    vol = geo.vol
    b = b - (torch.sum((b * vol).reshape(2, -1), dim=1)
             / (torch.sum(vol) * 512)).reshape(2, 1, 1, 1, 1)
    b = b * geo.mask
    kw = dict(tab=geo.tab1, ftab=geo.ftab, vol=vol, graph=geo.graph,
              tol_abs=1e-6, tol_rel=1e-4, maxiter=200)
    cap = b.shape[1]
    x, rn, k = fab.fused_amr_bicgstab(geo.geom, b.reshape(2 * cap, 8, 8, 8),
                                      lanes=2, **kw)
    assert rn.shape == (2,) and k.shape == (2,)
    for lane in range(2):
        xs, rs, ks = fab.fused_amr_bicgstab(geo.geom, b[lane], **kw)
        assert abs(int(k[lane]) - int(ks)) <= ITERS_SLACK
        scale = float(torch.max(torch.abs(xs)))
        np.testing.assert_allclose(x[lane * cap:(lane + 1) * cap].numpy(),
                                   xs.numpy(), rtol=0, atol=1e-3 * scale)
        assert float(rn[lane]) <= 1e-4 * float(torch.linalg.norm(b[lane]))


@pytest.mark.parametrize("fused", [True, False])
def test_frozen_lanes_do_not_hold_the_live_lanes(tmp_path, fused):
    """A lane marked not live (the fleet gate's finished and padding
    lanes) does not iterate: the live lane's solution, residual and count
    are bitwise those of the unmasked solve, the frozen lane comes back
    unsolved with count 0, and the loop stops when the live lane does
    (lane 0 is given the looser reference, so it stops first)."""
    from cup3d_tpu_torch.ops import krylov

    s = _solo_forest(tmp_path / "f", dict(TWO_LEVEL, nsteps=0), 0.3)[2]
    geo = s._geo
    g = torch.Generator().manual_seed(7)
    rhs = torch.randn((2,) + tuple(s.state["p"].shape), generator=g)
    core = amr_ops.build_amr_poisson_solver_dynamic(8, fused=fused)
    ref = torch.sqrt(torch.sum((rhs * rhs).reshape(2, -1), dim=1))
    ref = ref * torch.tensor([1e3, 1.0])
    kw = dict(tab_arg=geo.tab1, flux_arg=geo.ftab, geom=geo.geom,
              vol=geo.vol, pmask=geo.mask, graph=geo.graph, rnorm_ref=ref,
              with_stats=True, lanes=True)
    counter = fab.iterations if fused else krylov.iterations
    n0 = counter["executed"]
    x, st = core(rhs, None, **kw)
    n1 = counter["executed"]
    xm, stm = core(rhs, None, live=torch.tensor([True, False]), **kw)
    n2 = counter["executed"]
    assert torch.equal(xm[0], x[0]) and torch.equal(stm[0], st[0])
    assert int(stm[1, 1]) == 0 and int(st[1, 1]) > int(st[0, 1])
    assert int(st[0, 1]) <= n2 - n1 < n1 - n0


def test_amr_lane_nan_isolated_bitwise(tmp_path):
    """``fleet.lane_nan`` at lane 1 of three forest lanes: lanes 0 and 2
    bitwise equal to the unfaulted drain, lane 1 rolled back and done."""
    specs = [SPECS[0], SPECS[1], dict(SPECS[0], cfl=0.28)]
    ref, rid = _drain(FleetServer, tmp_path / "ref", specs, snap_every=4,
                      device="cpu")
    faults.arm("fleet.lane_nan", 1, 1)
    flt, fid = _drain(FleetServer, tmp_path / "flt", specs, snap_every=4,
                      device="cpu")
    for lane in (0, 2):
        a = ref._jobs[rid[lane]].batch.carry
        b = flt._jobs[fid[lane]].batch.carry
        for k in a:
            assert torch.equal(a[k][lane], b[k][lane]), k
        assert ref._jobs[rid[lane]].qoi_bytes() == \
            flt._jobs[fid[lane]].qoi_bytes()
    assert flt.poll(fid[1])["status"] == DONE
    assert flt.health()["rollbacks"] == 1
    assert ref.health()["rollbacks"] == 0


def test_forest_solve_lanes_front_end_legacy(tmp_path):
    """The solver front end's lane path: mean removal per lane, the masks,
    and (L, 2) stats, fused and legacy alike."""
    s = _solo_forest(tmp_path / "f", dict(TWO_LEVEL, nsteps=0), 0.3)[2]
    geo = s._geo
    g = torch.Generator().manual_seed(5)
    rhs = torch.randn((2,) + tuple(s.state["p"].shape), generator=g)
    core = amr_ops.build_amr_poisson_solver_dynamic(8, fused=False)
    kw = dict(tab_arg=geo.tab1, flux_arg=geo.ftab, geom=geo.geom,
              vol=geo.vol, pmask=geo.mask, graph=geo.graph,
              with_stats=True)
    x, st = core(rhs, None, lanes=True, **kw)
    assert st.shape == (2, 2)
    for lane in range(2):
        xs, ss = core(rhs[lane], None, **kw)
        assert abs(float(st[lane, 1]) - float(ss[1])) <= ITERS_SLACK
        scale = float(torch.max(torch.abs(xs)))
        np.testing.assert_allclose(x[lane].numpy(), xs.numpy(), rtol=0,
                                   atol=1e-3 * scale)
        assert float(torch.max(torch.abs(x[lane][s.grid.nb:]))) == 0.0
