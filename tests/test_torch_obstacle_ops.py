"""The port's obstacle operators against the JAX package's on the same
seeded numpy inputs (a fish-sized body on 32^3): ``momentum_integrals``
-> ``pack_moments`` (19 values), ``rigid_update_device`` (the RIGID_PACK
row), the quaternion helpers, ``penalize``, ``penalization_force``,
``per_obstacle_penalization_force``, ``grad_chi``, ``surface_delta``,
``heaviside`` and ``fluid_divergence_max``, each within 1e-5 of its
largest entry; and the port's host rigid path against its device path.  The surface probe
``force_integrals_probe_uniform`` -> ``pack_forces`` is held on the
fish's own fields in tests/test_torch_fish_sim.py, where the JAX
driver has already compiled it (its compile takes ~9 s on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.grid.uniform import UniformGrid as JGrid
from cup3d_tpu.models import base as jbase
from cup3d_tpu.ops import chi as jchi
from cup3d_tpu.ops import penalization as jpen
from cup3d_tpu_torch.grid.uniform import UniformGrid as TGrid
from cup3d_tpu_torch.models import base as tbase
from cup3d_tpu_torch.ops import chi as tchi
from cup3d_tpu_torch.ops import penalization as tpen
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 32
H = 1.0 / N
SHAPE = (N, N, N)
EXT = (1.0, 1.0, 1.0)
TOL = 1e-5


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.fixture(scope="module")
def fields():
    """An ellipsoidal body (semi-axes 0.2, 0.06, 0.04: about the fish's
    size) in a random velocity field: sdf (>0 inside), Towers chi,
    udef, vel, p, all f32."""
    rng = np.random.default_rng(7)
    x = (np.arange(N) + 0.5) * H
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    c = np.array([0.49, 0.52, 0.51])
    ax = np.array([0.2, 0.06, 0.04])
    q = np.sqrt(((X - c[0]) / ax[0]) ** 2 + ((Y - c[1]) / ax[1]) ** 2
                + ((Z - c[2]) / ax[2]) ** 2)
    sdf = ((1.0 - q) * ax.min()).astype(np.float32)
    lab = np.pad(sdf, 1, mode="edge")
    chi = _np(jax.jit(jchi.towers_chi, static_argnums=1)(
        jnp.asarray(lab), H)).astype(np.float32)
    f32 = lambda a: a.astype(np.float32)
    return dict(sdf=sdf, chi=chi, c=c,
                vel=f32(rng.standard_normal(SHAPE + (3,)) * 0.1),
                vel2=f32(rng.standard_normal(SHAPE + (3,)) * 0.1),
                udef=f32(rng.standard_normal(SHAPE + (3,)) * 0.05
                         * (chi > 0)[..., None]),
                p=f32(rng.standard_normal(SHAPE) * 0.01))


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def test_moments_and_rigid_update(fields):
    jg, tg = JGrid(SHAPE, EXT), TGrid(SHAPE, EXT)
    cm = fields["c"] + 0.003
    # jitted as the JAX driver runs them (one compile, not one per op)
    mj = jax.jit(lambda c, v, m: jbase.pack_moments(
        jbase.momentum_integrals(jg, c, v, m)))(
        _j(fields["chi"]), _j(fields["vel"]), _j(cm))
    mt = tbase.pack_moments(tbase.momentum_integrals(
        tg, _t(fields["chi"]), _t(fields["vel"]), _t(cm)))
    assert mt.shape == (19,)
    _close(mt, mj)
    # the rigid update from those moments, with one forced and one
    # blocked component, and an upstream frame velocity
    state = np.concatenate([[0.01, -0.02, 0.003], [0.1, -0.05, 0.2],
                            [0.5, 0.51, 0.52], [0.4, 0.5, 0.5],
                            cm, [0.9, 0.1, -0.2, 0.3]])
    state[15:19] /= np.linalg.norm(state[15:19])
    forced = np.array([False, True, False])
    block = np.array([True, False, False])
    uinf = np.array([-0.01, 0.0, 0.002])
    dt = 2e-3
    rj = jax.jit(jbase.rigid_update_device)(
        _j(mj), _j(state), jnp.asarray(forced), jnp.asarray(block),
        _j(uinf), jnp.asarray(dt, jnp.float32))
    rt = tbase.rigid_update_device(mt, _t(state), torch.tensor(forced),
                                   torch.tensor(block), _t(uinf),
                                   torch.tensor(dt, dtype=torch.float32))
    assert rt.shape == (tbase.RIGID_PACK,)
    _close(rt[:tbase.RIGID_STATE], rj[:jbase.RIGID_STATE])
    _close(rt, rj)


def test_penalization_and_its_force(fields):
    lam, dt = 1.0 / 2e-3, 2e-3
    vj = jax.jit(jpen.penalize)(_j(fields["vel"]), _j(fields["chi"]),
                                _j(fields["vel2"]), lam, dt)
    vt = tpen.penalize(_t(fields["vel"]), _t(fields["chi"]),
                       _t(fields["vel2"]), lam, dt)
    _close(vt, vj)
    xj = JGrid(SHAPE, EXT).cell_centers(jnp.float32)
    xt = TGrid(SHAPE, EXT).cell_centers(torch.float32)
    cm = fields["c"]
    chi2 = np.roll(fields["chi"], 3, axis=0)  # a second, overlapping body
    fj = jax.jit(jpen.per_obstacle_penalization_force)(
        vj, _j(fields["vel"]), (_j(fields["chi"]), _j(chi2)), dt, H ** 3, xj,
        _j(np.stack([cm, cm + 0.1])))
    ft = tpen.per_obstacle_penalization_force(
        vt, _t(fields["vel"]), (_t(fields["chi"]), _t(chi2)), dt, H ** 3, xt,
        _t(np.stack([cm, cm + 0.1])))
    assert ft.shape == (2, 6)
    _close(ft, fj)


@pytest.mark.parametrize("name", ["grad_chi", "surface_delta"])
def test_chi_gradients(fields, name):
    gj = jax.jit(lambda c: getattr(jchi, name)(JGrid(SHAPE, EXT), c))(
        _j(fields["chi"]))
    gt = getattr(tchi, name)(TGrid(SHAPE, EXT), _t(fields["chi"]))
    _close(gt, gj)


def test_heaviside_penalization_force_and_fluid_divergence(fields):
    _close(tchi.heaviside(_t(fields["sdf"]), H),
           jax.jit(jchi.heaviside, static_argnums=1)(_j(fields["sdf"]), H))
    _close(tpen.penalization_force(_t(fields["vel2"]), _t(fields["vel"]),
                                   2e-3, H),
           jax.jit(jpen.penalization_force, static_argnums=(2, 3))(
               _j(fields["vel2"]), _j(fields["vel"]), 2e-3, H))
    # the fluid-region divergence gate chip_smoke.py holds the fish to,
    # on a periodic and on a walled grid
    from cup3d_tpu.ops.diagnostics import fluid_divergence_max as j_fdiv
    from cup3d_tpu_torch.ops.diagnostics import fluid_divergence_max

    for bcs in (("periodic",) * 3, ("wall", "freespace", "periodic")):
        jg, tg = JGrid(SHAPE, EXT, bcs), TGrid(SHAPE, EXT, bcs)
        want = float(jax.jit(lambda v, c: j_fdiv(jg, v, c))(
            _j(fields["vel"]), _j(fields["chi"])))
        got = float(fluid_divergence_max(tg, _t(fields["vel"]),
                                         _t(fields["chi"])))
        assert abs(got - want) <= TOL * want


def test_quaternion_helpers():
    rng = np.random.default_rng(3)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    om = rng.standard_normal(3)
    _close(tbase.quat_to_rot_dev(_t(q)), jbase.quat_to_rot_dev(_j(q)))
    _close(tbase.quat_to_rot_dev(_t(q)), tbase.quat_to_rot(q))
    for w in (om, np.zeros(3)):
        _close(tbase.quat_integrate_dev(_t(q), _t(w), 0.05),
               jbase.quat_integrate_dev(_j(q), _j(w), 0.05))
        np.testing.assert_allclose(tbase.quat_integrate(q, w, 0.05),
                                   jbase.quat_integrate(q, w, 0.05),
                                   rtol=0, atol=1e-15)


def test_host_rigid_path_matches_the_device_path(tmp_path):
    """The host fallback (compute_velocities + update, the path a fish
    with roll correction takes) against the device fast path, on the
    port's 32^3 fish (the JAX package's test_sphere.py twin)."""
    from cup3d_tpu_torch.__main__ import build_driver
    from test_torch_jax_twins import argv

    def run(force_host):
        d = build_driver(argv("fish", tmp_path / str(force_host), 4)
                         + ["-device", "cpu"])
        d.init()
        if force_host:
            d.sim.obstacles[0].supports_device_update = lambda: False
        d.simulate()
        return d

    fast, host = run(False), run(True)
    of, oh = fast.sim.obstacles[0], host.sim.obstacles[0]
    assert of._dev_rigid is None and oh._dev_rigid is None
    assert np.abs(of.transVel).max() > 0
    np.testing.assert_allclose(of.transVel, oh.transVel, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(of.angVel, oh.angVel, atol=5e-6)
    np.testing.assert_allclose(of.position, oh.position, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(of.quaternion, oh.quaternion, atol=1e-6)
    np.testing.assert_allclose(of.centerOfMass, oh.centerOfMass, atol=1e-6)
    np.testing.assert_allclose(of.force, oh.force, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(_np(of.penal_force), _np(oh.penal_force),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(_np(fast.sim.state["vel"]),
                               _np(host.sim.state["vel"]), atol=1e-5)
