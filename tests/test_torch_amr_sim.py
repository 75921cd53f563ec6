"""The port's AMR driver against the JAX package's, end to end on the CPU.

The configuration is BASELINE config #3 (Taylor-Green on a 2-level
forest, Rtol 1.8, Ctol 0.05, extent 2 pi, the iterative solver under
CUP3D_FUSED=1) at bpd 3 instead of 16: the vortex-core columns refine
(4 of 9), so both levels are present, and every block's vorticity score
lies at least 0.1 from either threshold, far outside rounding.

- after ``init()`` the octree leaf keys are equal;
- then 5 steps: kinetic energy within 1e-4 relative per step, solver
  iterations within +-1, velocity within 1e-3 of max|u|;
- ``build_driver`` with levelMax 2 and ``-device cpu`` gives the AMR
  driver, and the default device is CUDA (raising without one);
- the JAX state carries into the port through ``load_state_numpy`` and
  steps on to the same answer;
- regrids while stepping, held to JAX: one StefanFish towed at 1.0
  through a bpd-1 forest of levelMax 3 (finest h 1/32, fixed dt 0.01)
  leaves the periodic image of one octant and enters another within 4
  steps, so the forest coarsens and refines again; after each regrid the
  leaf keys are equal and the transferred vel, p, chi and udef within
  1e-5 of their scales.
"""

import os

import numpy as np
import pytest
import torch

from cup3d_tpu.config import SimulationConfig as JConfig
from cup3d_tpu.sim.amr import AMRSimulation as JAMR
from cup3d_tpu_torch import __main__ as tmain
from cup3d_tpu_torch.config import SimulationConfig as TConfig
from cup3d_tpu_torch.ops import amr_ops
from cup3d_tpu_torch.sim import amr as tamr
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 5
ARGV = ("-bpdx 3 -bpdy 3 -bpdz 3 -levelMax 2 -levelStart 0 "
        "-extent 6.283185307179586 -initCond taylorGreen -Rtol 1.8 "
        "-Ctol 0.05 -CFL 0.4 -rampup 0 -nu 1e-3 -poissonSolver iterative "
        "-poissonTol 1e-6 -poissonTolRel 1e-4 -tend 0 -verbose 0 "
        f"-nsteps {STEPS}").split()


def _cfg_kw(path):
    return dict(bpdx=3, bpdy=3, bpdz=3, levelMax=2, levelStart=0,
                extent=float(2 * np.pi), CFL=0.4, nu=1e-3, tend=0.0,
                nsteps=STEPS, rampup=0, Rtol=1.8, Ctol=0.05,
                poissonSolver="iterative", poissonTol=1e-6,
                poissonTolRel=1e-4, initCond="taylorGreen", verbose=False,
                path4serialization=str(path))


def _ke(vel, h):
    vel = np.asarray(vel, np.float64)
    return 0.5 * np.sum(np.sum(vel ** 2, -1) * (h ** 3)[:, None, None, None])


def _unpadded(js):
    nb = js.grid.nb
    return {k: np.asarray(js.state[k])[:nb] for k in ("vel", "p")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers: init, then STEPS steps; per step (KE, iterations,
    velocity)."""
    prev = os.environ.get("CUP3D_FUSED")
    os.environ["CUP3D_FUSED"] = "1"
    try:
        js = JAMR(JConfig(**_cfg_kw(tmp_path_factory.mktemp("jax"))))
        js.init()
        ts = tamr.AMRSimulation(TConfig(**_cfg_kw(
            tmp_path_factory.mktemp("torch"))), device="cpu")
        ts.init()
        out = dict(j_keys=list(js.grid.keys), t_keys=list(ts.grid.keys),
                   j_init=_unpadded(js), j_scalars=None, t_sim=ts,
                   score=amr_ops.vorticity_score(
                       ts._geom, ts.state["vel"], ts._tab1)[: ts.grid.nb]
                   .numpy())
        j_iters = []
        consume = js._consume_step_pack

        def record():
            for name, arr in js._pending_parts:
                if name == "psolve":
                    j_iters.append(float(np.asarray(arr)[1]))
            return consume()

        js._consume_step_pack = record
        rows = []
        for _ in range(STEPS):
            if not rows:
                out["j_scalars"] = dict(time=js.time, step=js.step_idx,
                                        dt=js.dt, uinf=js.uinf)
            js.advance(js.calc_max_timestep())
            ts.advance(ts.calc_max_timestep())
            jv = _unpadded(js)["vel"]
            rows.append(dict(j_ke=_ke(jv, js.grid.h),
                             t_ke=_ke(ts._unpad(ts.state["vel"]).numpy(),
                                      ts.grid.h),
                             j_vel=jv,
                             t_vel=ts._unpad(ts.state["vel"]).numpy().copy(),
                             t_iters=ts.step_log[-1]["iters"]))
        for row, k in zip(rows, j_iters):
            row["j_iters"] = k
        out["rows"] = rows
        return out
    finally:
        if prev is None:
            os.environ.pop("CUP3D_FUSED", None)
        else:
            os.environ["CUP3D_FUSED"] = prev


def test_init_converges_to_the_same_forest(runs):
    assert runs["t_keys"] == runs["j_keys"]
    levels = {k[0] for k in runs["t_keys"]}
    assert levels == {0, 1}
    # no score within rounding of a threshold: the tags are robust
    score = runs["score"]
    assert np.min(np.abs(score - 1.8)) > 0.1
    assert np.min(np.abs(score - 0.05)) > 0.1


def test_steps_match_jax(runs):
    rows = runs["rows"]
    assert len(rows) == STEPS
    for row in rows:
        assert abs(row["t_ke"] - row["j_ke"]) <= 1e-4 * row["j_ke"]
        assert abs(row["t_iters"] - row["j_iters"]) <= 1
        umax = np.abs(row["j_vel"]).max()
        assert np.abs(row["t_vel"] - row["j_vel"]).max() <= 1e-3 * umax
    # KE decays (viscous TGV)
    kes = [row["t_ke"] for row in rows]
    assert all(b < a for a, b in zip(kes, kes[1:]))


def test_state_carries_from_jax(runs, tmp_path, monkeypatch):
    """The JAX post-init state, loaded into a fresh port driver, steps on
    to the JAX package's first step."""
    monkeypatch.setenv("CUP3D_FUSED", "1")
    ts = tamr.AMRSimulation(TConfig(**_cfg_kw(tmp_path)), device="cpu")
    arrays = dict(runs["j_init"], keys=np.asarray(runs["j_keys"]))
    tamr.load_state_numpy(ts, arrays, runs["j_scalars"])
    assert ts.grid.keys == runs["j_keys"]
    ts.advance(ts.calc_max_timestep())
    row = runs["rows"][0]
    umax = np.abs(row["j_vel"]).max()
    assert np.abs(ts._unpad(ts.state["vel"]).numpy()
                  - row["j_vel"]).max() <= 1e-3 * umax
    # and back out: state_to_numpy round-trips bitwise
    a2, s2 = tamr.state_to_numpy(ts)
    ts2 = tamr.AMRSimulation(TConfig(**_cfg_kw(tmp_path)), device="cpu")
    tamr.load_state_numpy(ts2, a2, s2)
    assert ts2.grid.keys == ts.grid.keys and ts2.step_idx == ts.step_idx == 1
    for k in ("vel", "p"):
        assert torch.equal(ts2.state[k], ts.state[k])
    bad = dict(a2, p=a2["p"][:-1])
    with pytest.raises(ValueError, match="shape"):
        tamr.load_state_numpy(ts2, bad, s2)


def test_build_driver_dispatch_and_device(tmp_path, monkeypatch):
    argv = ARGV + ["-path4serialization", str(tmp_path)]
    d = tmain.build_driver(argv + ["-device", "cpu"])
    assert isinstance(d, tamr.AMRSimulation)
    assert d.device == torch.device("cpu") and d.adapt_enabled
    assert d.grid.nb == 27  # the base forest, before init adapts it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.build_driver(argv)


@pytest.mark.parametrize("flags", [
    ["-factory-content", "sphere L=0.1", "-pipelined", "1"],
    ["-pipelined", "1"],
    ["-implicitDiffusion", "1"],
    ["-bFixMassFlux", "1"],
    ["-uMax_forced", "0.5"],
], ids=["bodies-pipelined", "pipelined", "implicit", "fixmassflux",
        "forced"])
def test_lifted_options_run_on_the_forest(tmp_path, flags):
    """The options the forest refused before it was pipelined and carried
    its physics now run: init and 2 steps on a bpd-2 forest (the first
    occurrence of a flag wins), finite fields.  Their numbers are held
    to the JAX package in tests/test_torch_amr_pipelined*.py,
    test_torch_amr_physics.py and test_torch_amr_helmholtz.py."""
    argv = flags + "-bpdx 2 -bpdy 2 -bpdz 2 -nsteps 2".split() + ARGV + [
        "-path4serialization", str(tmp_path), "-device", "cpu"]
    d = tmain.build_driver(argv)
    d.init()
    d.simulate()
    assert d.step_idx == 2 and len(d.step_log) == 2
    assert all(bool(torch.isfinite(v).all()) for v in d.state.values())
    assert d.cfg.pipelined == ("-pipelined" in flags)


def test_bodies_on_the_sharded_forest_raise(tmp_path):
    """Bodies on the sharded forest, once refused, now run (their numbers
    are held to the unsharded port and to the JAX package in
    tests/test_torch_sharded_bodies.py): the body is built, its chi is
    taken on the padded forest, and the padding rows of every field stay
    0 through a step."""
    from cup3d_tpu_torch.parallel.forest import make_block_mesh

    cfg = TConfig(factory_content="sphere L=1.0", **_cfg_kw(tmp_path))
    d = tamr.AMRSimulation(cfg, device="cpu",
                           mesh=make_block_mesh([torch.device("cpu")] * 2))
    d.init()
    d.advance(d.calc_max_timestep())
    nb = d.grid.nb
    assert d.state["chi"].shape[0] == d.forest.nb_pad
    assert float(d.state["chi"][:nb].sum()) > 0
    for k, v in d.state.items():
        assert bool(torch.isfinite(v).all()), k
        assert not v[nb:].any(), k


def test_scan_k_runs_on_the_forest(tmp_path):
    """The forest driver never reads scan_k (as in the JAX package):
    scan_k=8 runs and gives the scan_k=0 run's fields bitwise."""
    kw = dict(bpdx=2, bpdy=2, bpdz=2, levelMax=2, levelStart=0,
              extent=float(2 * np.pi), Rtol=100.0, Ctol=0.0, nu=0.02,
              CFL=0.3, rampup=0, tend=0.0, nsteps=2, initCond="taylorGreen",
              poissonSolver="iterative", verbose=False)
    fields = []
    for k in (8, 0):
        d = tamr.AMRSimulation(TConfig(
            scan_k=k, path4serialization=str(tmp_path / f"k{k}"), **kw),
            device="cpu")
        d.init()
        d.simulate()
        assert d.grid.nb <= 27 and d.step_idx == 2
        fields.append({n: v.clone() for n, v in d.state.items()})
    for n in fields[0]:
        assert torch.equal(fields[0][n], fields[1][n]), n


TOW_ARGV = ("-bpdx 1 -bpdy 1 -bpdz 1 -levelMax 3 -levelStart 2 -extent 1 "
            "-Rtol 5 -Ctol 0.1 -nu 1e-3 -rampup 0 -dt 0.01 "
            "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
            "-tend 0 -nsteps 4 -verbose 0").split()
TOWED = ("StefanFish L=0.4 T=1.0 xpos=0.2 ypos=0.265625 zpos=0.265625 "
         "xvel=1.0 bForcedInSimFrame=1 heightProfile=danio "
         "widthProfile=stefan")
TOW_STEPS = 4


def _watch_regrids(d, log):
    """Record (step, stepping, keys, unpadded fields) after each regrid
    that changed the forest."""
    apply = d._apply_states

    def hook(states):
        changed = apply(states)
        if changed:
            nb = d.grid.nb
            fields = {k: np.array(np.asarray(d._unpad(d.state[k])))[:nb]
                      for k in ("vel", "p", "chi", "udef")}
            log.append((d.step_idx, getattr(d, "_stepping", False),
                        list(d.grid.keys), fields))
        return changed

    d._apply_states = hook


@pytest.fixture(scope="module")
def towed(tmp_path_factory):
    """The towed fish on both drivers: init, then TOW_STEPS steps, every
    regrid recorded; the port's tag scores at every adaptation."""
    saved = {k: os.environ.get(k) for k in ("CUP3D_FUSED", "CUP3D_BUCKET")}
    os.environ.pop("CUP3D_FUSED", None)
    os.environ["CUP3D_BUCKET"] = "0"  # the JAX package's unpadded path
    try:
        from cup3d_tpu.__main__ import build_driver as jbuild

        js = jbuild(TOW_ARGV + ["-path4serialization",
                                str(tmp_path_factory.mktemp("jax")),
                                "-factory-content", TOWED])
        os.environ["CUP3D_FUSED"] = "1"
        ts = tmain.build_driver(TOW_ARGV + [
            "-path4serialization", str(tmp_path_factory.mktemp("torch")),
            "-factory-content", TOWED, "-device", "cpu"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {"j": [], "t": [], "scores": [], "t_nb": [], "j_nb": []}
    _watch_regrids(js, out["j"])
    _watch_regrids(ts, out["t"])
    adapt = ts.adapt_mesh

    def adapt_hook():
        vort, near = ts.scores()
        out["scores"].append((vort.numpy().copy(), near.numpy().copy()))
        return adapt()

    ts.adapt_mesh = adapt_hook
    js.init()
    ts.init()
    js._stepping = ts._stepping = True
    for _ in range(TOW_STEPS):
        for d, nbs in ((js, out["j_nb"]), (ts, out["t_nb"])):
            d.advance(d.calc_max_timestep())
            nbs.append(d.grid.nb)
    return out


def test_regrids_while_stepping_match_jax(towed):
    j, t = towed["j"], towed["t"]
    assert towed["t_nb"] == towed["j_nb"]
    during = [r for r in t if r[1]]
    # the forest changed while stepping (not only in init), both ways
    assert len(during) >= 2 and len(set(towed["t_nb"])) >= 2
    assert [(r[0], r[1]) for r in t] == [(r[0], r[1]) for r in j]
    for (_, stepping, jk, jf), (_, _, tk, tf) in zip(j, t):
        assert tk == jk
        for k in ("vel", "p", "chi", "udef"):
            scale = np.abs(jf[k]).max()
            # while stepping every field is non-zero (in init the fluid
            # is at rest: equal zeros)
            assert scale > 0 or not stepping, k
            assert np.abs(tf[k] - jf[k]).max() <= 1e-5 * scale, k
    # no tag decision within rounding of a threshold: away from the
    # bodies every score is at least 1% off Rtol 5 and Ctol 0.1
    for vort, near in towed["scores"]:
        free = vort[~near]
        assert np.min(np.abs(free - 5.0)) > 0.05
        assert np.min(np.abs(free - 0.1)) > 1e-3
