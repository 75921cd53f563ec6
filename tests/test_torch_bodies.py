"""The sphere, the NACA foil, the triangle geometry helpers and the
collision pass of the port against the JAX package, on the same numpy
inputs, and two StefanFish stepping together.

Tolerances: chi, sdf and udef of a body within 1e-5 of their scale (f32,
tests/test_torch_fish_rasterize.py's bound); the geometry helpers within
1e-5 relative; the overlap sums within 1e-6 of the summed magnitudes (a
sum's f32 rounding scales with its terms, not with its result) and the
count exactly; the impulse algebra (float64 on the host in both
packages) within 1e-12; two spheres closing on each other, rigid
velocities after the collision pass within 1e-5; two StefanFish (the
run.sh factory lines, their centres on cell centres as
tests/test_torch_jax_twins.py's fish: at 32^3 a section is thinner than
a cell) for 3 steps, rigid state and kinetic energy within 1e-4 of their
scale (tests/test_torch_fish_sim.py's bound)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.__main__ import build_driver as jax_build_driver
from cup3d_tpu.models import collisions as jcol
from cup3d_tpu.utils import geometry as jgeo
from cup3d_tpu_torch.__main__ import build_driver
from cup3d_tpu_torch.models import collisions as tcol
from cup3d_tpu_torch.utils import geometry as tgeo
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BOX = ("-bpdx 4 -bpdy 4 -bpdz 4 -levelMax 1 -extent 1 -CFL 0.4 -nu 1e-3 "
       "-rampup 100 -tend 0 -nsteps 3 -verbose 0")
TWO_FISH = ("StefanFish L=0.4 T=1.0 xpos=0.2 ypos=0.515625 zpos=0.515625 "
            "planarAngle=180 heightProfile=danio widthProfile=stefan "
            "bFixFrameOfRef=1\n"
            "StefanFish L=0.4 T=1.0 xpos=0.7 ypos=0.515625 zpos=0.515625 "
            "heightProfile=danio widthProfile=stefan")


def _drivers(tmp_path, body, extra=""):
    argv = (f"{BOX} {extra} -path4serialization {tmp_path}".split()
            + ["-factory-content", body])
    js = jax_build_driver(argv)
    ts = build_driver(argv + ["-device", "cpu"])
    js.init()
    ts.init()
    return js, ts


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("body", [
    "sphere L=0.3 xpos=0.45 ypos=0.5 zpos=0.55",
    "naca L=0.4 xpos=0.5 ypos=0.5 zpos=0.5 planarAngle=30 tRatio=0.15",
])
def test_body_fields_match_jax(tmp_path, body):
    js, ts = _drivers(tmp_path, body)
    for d in (js, ts):
        d.pipeline[0](0.0)  # CreateObstacles
    jo, to = js.sim.obstacles[0], ts.sim.obstacles[0]
    assert type(to).__name__ == type(jo).__name__
    for name in ("sdf", "chi", "udef"):
        _close(getattr(to, name), getattr(jo, name), 1e-5)
    assert float(torch.sum(to.chi)) > 100  # the body owns cells


def test_geometry_matches_jax():
    rng = np.random.default_rng(3)
    v0, v1, v2, o, d, p = (rng.standard_normal((64, 3)).astype(np.float32)
                           for _ in range(6))
    hit_j, t_j = jgeo.ray_intersects_triangle(*map(jnp.asarray,
                                                   (o, d, v0, v1, v2)))
    hit_t, t_t = tgeo.ray_intersects_triangle(*map(torch.as_tensor,
                                                   (o, d, v0, v1, v2)))
    hit_j = np.asarray(hit_j)
    np.testing.assert_array_equal(hit_t.numpy(), hit_j)
    assert 0 < hit_j.sum() < 64
    np.testing.assert_allclose(t_t.numpy()[hit_j], np.asarray(t_j)[hit_j],
                               rtol=1e-5)
    assert np.all(np.isinf(t_t.numpy()[~hit_j]))
    # one triangle against many points, and many against many
    for args in ((p, v0[:1], v1[:1], v2[:1]), (p, v0, v1, v2)):
        want = jgeo.point_triangle_sqr_distance(*map(jnp.asarray, args))
        got = tgeo.point_triangle_sqr_distance(*map(torch.as_tensor, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _overlap_inputs(seed=7, n=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal((n, n, n) + s).astype(np.float32)
    chi_i = rng.uniform(size=(n, n, n)).astype(np.float32)
    chi_j = rng.uniform(size=(n, n, n)).astype(np.float32)
    ax = (np.arange(n) + 0.5) / n
    xc = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                  -1).astype(np.float32)
    return chi_i, chi_j, f(3), f(3), f(3), f(3), xc


def test_overlap_reductions_match_jax():
    args = _overlap_inputs()
    chi_i, chi_j, gi, gj, ui, uj, xc = args
    assert int(tcol.overlap_count(torch.as_tensor(chi_i),
                                  torch.as_tensor(chi_j))) == \
        int(jcol.overlap_count(jnp.asarray(chi_i), jnp.asarray(chi_j)))
    want = jcol.pair_overlap_summary(*map(jnp.asarray, args))
    got = tcol.pair_overlap_summary(*map(torch.as_tensor, args))
    mask = ((chi_i > 0.5) & (chi_j > 0.5)).reshape(-1)
    assert float(got["m"]) == float(want["m"]) == mask.sum()
    unit = lambda g: g.reshape(-1, 3) / np.linalg.norm(
        g.reshape(-1, 3), axis=-1, keepdims=True)
    mags = {"pos": np.abs(xc.reshape(-1, 3)[mask]).sum(0),
            "ivec": np.abs(unit(gi)[mask]).sum(0),
            "jvec": np.abs(unit(gj)[mask]).sum(0)}
    for k, mag in mags.items():
        assert np.all(np.abs(got[k].numpy() - np.asarray(want[k]))
                      <= 1e-6 * mag), k
    for k in ("imom", "jmom"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_elastic_collision_matches_jax():
    rng = np.random.default_rng(9)
    J1, J2 = (np.diag(rng.uniform(0.5, 2.0, 3)) for _ in range(2))
    vecs = [rng.standard_normal(3) for _ in range(10)]
    n = vecs[6] / np.linalg.norm(vecs[6])
    args = (1.3, 0.7, J1, J2, *vecs[:6], n, *vecs[7:])
    for g, w in zip(tcol.elastic_collision(*args),
                    jcol.elastic_collision(*args)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


SPHERES = ("sphere L=0.3 xpos=0.4 ypos=0.5 zpos=0.5 xvel=0.2\n"
           "sphere L=0.3 xpos=0.62 ypos=0.52 zpos=0.5 xvel=-0.1 yvel=0.05")


def test_prevent_colliding_spheres_matches_jax(tmp_path):
    js, ts = _drivers(tmp_path, SPHERES)
    from functools import partial

    from cup3d_tpu.ops.chi import grad_chi as jgrad
    from cup3d_tpu_torch.ops.chi import grad_chi as tgrad

    hits = []
    for d, col, grad in ((js, jcol, jgrad), (ts, tcol, tgrad)):
        d.pipeline[0](0.0)
        for k, ob in enumerate(d.sim.obstacles):
            ob.mass = 0.05 + 0.01 * k
            ob.J = np.diag([1e-3, 2e-3, 1.5e-3]) * (1 + k)
        ubs = [ob.body_velocity_field() for ob in d.sim.obstacles]
        hits.append(col.prevent_colliding_obstacles(
            d.sim.obstacles, ubs, partial(grad, d.sim.grid), d.sim.xc,
            1e-3))
    assert hits == [True, True]
    for jo, to in zip(js.sim.obstacles, ts.sim.obstacles):
        for name in ("transVel", "angVel", "collision_vel"):
            _close(getattr(to, name), getattr(jo, name), 1e-5)
        assert to.collision_counter == pytest.approx(jo.collision_counter)
        assert not to.supports_device_update()


def _rigid(d):
    return np.concatenate([np.concatenate(
        [ob.transVel, ob.angVel, ob.position, ob.quaternion])
        for ob in d.sim.obstacles])


def test_two_fish_match_jax(tmp_path):
    js, ts = _drivers(tmp_path, TWO_FISH, "-poissonSolver iterative")
    names = [type(op).__name__ for op in ts.pipeline]
    assert names == [type(op).__name__ for op in js.pipeline]
    for _ in range(3):
        dt_j = js.calc_max_timestep()
        dt_t = ts.calc_max_timestep()
        assert abs(dt_t - dt_j) <= 1e-5 * dt_j
        js.advance(dt_j)
        ts.advance(dt_t)
        r_j, r_t = _rigid(js), _rigid(ts)
        assert np.abs(r_t - r_j).max() <= 1e-4 * np.abs(r_j).max()
        v_j = np.asarray(js.sim.state["vel"], np.float64)
        v_t = ts.sim.state["vel"].numpy().astype(np.float64)
        ke_j, ke_t = (0.5 * float(np.sum(v * v)) for v in (v_j, v_t))
        assert abs(ke_t - ke_j) <= 1e-4 * ke_j
    assert all(float(torch.sum(ob.chi)) > 0 for ob in ts.sim.obstacles)


def test_pipelined_bodies_refused_as_in_jax(tmp_path):
    from cup3d_tpu.sim.simulation import Simulation as JaxSimulation

    from cup3d_tpu_torch.sim.simulation import Simulation

    argv = (f"{BOX} -pipelined 1 -path4serialization {tmp_path}".split()
            + ["-factory-content", TWO_FISH])
    from cup3d_tpu.config import parse_args as jparse

    from cup3d_tpu_torch.config import parse_args

    with pytest.raises(ValueError) as jerr:
        JaxSimulation(jparse(argv)).init()
    with pytest.raises(ValueError) as terr:
        Simulation(parse_args(argv), device="cpu").init()
    assert str(terr.value) == str(jerr.value)
