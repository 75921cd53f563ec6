"""The pipelined forest (sim/amr.py ``advance_pipelined*``) against the
JAX package's pipelined forest, in its cases and bounds
(tests/test_amr_pipelined.py, at its sizes); the port's pipelined step
against its own host path is tests/test_torch_amr_pipelined_paths.py.

- the obstacle-free pipelined Taylor-Green forest (bpd 2, levelMax 2,
  6 steps at dt 1e-3): velocity within 2e-5 of the JAX pipelined run's,
  and bitwise the port's host path (the same operators in the same
  order);
- two spheres pipelined on the bpd-1 forest at levelMax 2 against the
  JAX pipelined run over its first two steps (the JAX package compiles
  its megastep once a pressure order, ~25 s each on the CPU): position
  rtol 1e-6, transVel rtol 1e-3, force rtol 2e-3, velocity atol 5e-5;
- ``rigid_update_bodies`` against the JAX vmap of
  ``rigid_update_device``, ``dt_device_implicit`` against the JAX
  function;
- ``QoIStream.stage`` counts its bytes;
- a roll-corrected fish is refused with the JAX package's ValueError.
"""

import numpy as np
import pytest
import torch

import test_torch_jax_twins as twins
from cup3d_tpu_torch.__main__ import build_driver
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PIPE_STEPS = 6
JAX_SPHERE_STEPS = 2


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    for k in ("CUP3D_FUSED", "CUP3D_FAULT", "CUP3D_RECOVER", "CUP3D_GETZ",
              "CUP3D_RING_HALO"):
        monkeypatch.delenv(k, raising=False)


def _port(kind, tmp, nsteps, *extra, adapt=True):
    # the first occurrence of a flag wins: ``extra`` overrides the base
    d = build_driver(list(extra) + twins.argv(kind, tmp, nsteps)
                     + ["-device", "cpu"])
    d.init()
    d.adapt_enabled = adapt
    return d


def _jax(kind, tmp, nsteps, adapt=True):
    d = twins.jax_driver(kind, tmp, nsteps)
    d.adapt_enabled = adapt
    d.simulate()
    return d


def test_pipelined_free_matches_jax_and_host_path(tmp_path):
    js = _jax("amr_pipe", tmp_path / "jax", PIPE_STEPS, adapt=False)
    pipe = _port("amr_pipe", tmp_path / "p", PIPE_STEPS, adapt=False)
    pipe.simulate()
    host = _port("amr_pipe", tmp_path / "h", PIPE_STEPS, "-pipelined", "0",
                 adapt=False)
    host.simulate()
    assert pipe.grid.keys == list(js.grid.keys) == host.grid.keys
    assert not pipe._pack_reader and pipe.step_idx == PIPE_STEPS
    assert [r["step"] for r in pipe.step_log] == list(range(PIPE_STEPS))
    np.testing.assert_allclose(twins.velocity(pipe), twins.velocity(js),
                               atol=2e-5)
    assert torch.equal(pipe.state["vel"], host.state["vel"])
    assert torch.equal(pipe.state["p"], host.state["p"])
    assert pipe.time == pytest.approx(js.time, rel=1e-12)


def test_pipelined_spheres_match_jax(tmp_path):
    js = _jax("amr_spheres", tmp_path / "jax", JAX_SPHERE_STEPS)
    js.flush_packs()
    pipe = _port("amr_spheres", tmp_path / "p", JAX_SPHERE_STEPS)
    pipe.simulate()
    assert pipe.grid.keys == list(js.grid.keys)
    for op, oj in zip(pipe.obstacles, js.obstacles):
        np.testing.assert_allclose(op.position, oj.position, rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(op.transVel, oj.transVel, rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(op.force, oj.force, rtol=2e-3,
                                   atol=1e-5)
    np.testing.assert_allclose(twins.velocity(pipe), twins.velocity(js),
                               atol=5e-5)
    np.testing.assert_allclose(pipe.uinf, js.uinf, rtol=1e-3, atol=1e-5)


def test_dt_device_implicit_matches_jax():
    import jax.numpy as jnp

    from cup3d_tpu.sim.dtpolicy import dt_device_implicit as jdt
    from cup3d_tpu_torch.sim.dtpolicy import dt_device_implicit

    for umax in (0.0, 0.3, 5.0):
        for past in (False, True):
            want = float(jdt(jnp.float32(umax), jnp.float32(0.4),
                             jnp.float32(0.05), jnp.float32(1e-3),
                             jnp.asarray(past)))
            got = float(dt_device_implicit(
                torch.tensor(umax, dtype=torch.float32), 0.4, 0.05, 1e-3,
                past))
            assert got == pytest.approx(want, rel=1e-6)


def test_rigid_update_bodies_matches_jax_vmap():
    import jax
    import jax.numpy as jnp

    from cup3d_tpu.models.base import rigid_update_device as jrigid
    from cup3d_tpu_torch.models.base import rigid_update_bodies

    rng = np.random.default_rng(3)
    n = 3
    mom = rng.normal(size=(n, 19)).astype(np.float32)
    mom[:, 0] = [1.5, 0.0, 2.0]  # a body with no mass keeps its state
    J = rng.normal(size=(n, 3, 3))
    mom[:, 10:19] = (J @ J.transpose(0, 2, 1) + 3 * np.eye(3)).reshape(
        n, 9)
    state = rng.normal(size=(n, 19)).astype(np.float32)
    state[:, 15:19] /= np.linalg.norm(state[:, 15:19], axis=1)[:, None]
    forced = np.array([[True] * 3, [False] * 3, [False, True, False]])
    blocked = np.array([[True] * 3, [False] * 3, [True, False, False]])
    uinf = np.float32([0.1, -0.2, 0.0])
    want = jax.vmap(jrigid, in_axes=(0, 0, 0, 0, None, None))(
        jnp.asarray(mom), jnp.asarray(state), jnp.asarray(forced),
        jnp.asarray(blocked), jnp.asarray(uinf), jnp.float32(1e-2))
    got = rigid_update_bodies(
        torch.tensor(mom), torch.tensor(state), torch.tensor(forced),
        torch.tensor(blocked), torch.tensor(uinf),
        torch.tensor(1e-2, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_stage_counts_its_bytes():
    from cup3d_tpu_torch.stream.qoi import QoIStream

    st = QoIStream(lambda e: None)
    x = torch.arange(10, dtype=torch.float32)
    copy = st.stage(x)
    assert st.stats["bytes_staged"] == 40 and not st
    np.testing.assert_array_equal(copy.values(), np.arange(10.0))
    st.stage(torch.zeros(3, dtype=torch.float64))
    assert st.snapshot()["bytes_staged"] == 64


def test_roll_corrected_fish_is_refused_pipelined(tmp_path):
    argv = twins.argv("amr_spheres", tmp_path, 1)
    argv[-1] = ("StefanFish L=0.4 T=1.0 xpos=0.3 ypos=0.5 zpos=0.5 "
                "heightProfile=danio widthProfile=stefan CorrectRoll=1")
    d = build_driver(argv + ["-device", "cpu"])
    with pytest.raises(ValueError, match=(
            r"^pipelined mode cannot run roll-corrected obstacles "
            r"\(host-side angVel mutation\) — run without -pipelined$")):
        d.init()


