"""The forest's physics that the megastep carries (sim/amr.py, ops/
diffusion.py): forcing and FixMassFlux, implicit diffusion and the
coiled-vorticity IC, the port against the JAX package on the CPU (the
forest Helmholtz solve's own pieces: tests/test_torch_amr_helmholtz.py).

- FixMassFlux on a walled forest channel (tests/test_torch_jax_twins.py
  "amr_channel", 5 steps at dt 5e-3), the port's host path and its
  pipelined step against the JAX host path: the same flux.txt rows (step,
  time and target equal, the bulk velocity within 1e-5 relative; the
  pipelined rows carry the producing step), velocity within 1e-5 of
  max|u|; ``uMax_forced`` alone the same way;
- a 3-step implicit-diffusion forest run ("amr_implicit"), the port's
  host path and pipelined step against the JAX host path, velocity
  within 1e-4 of max|u| (two Krylov solves stopped at 1e-4 relative);
- the coiled-vorticity IC on a fixed two-level forest against the JAX
  forest IC's composition (the coil, ``curl_blocks`` of its lab, the
  forest Poisson solve of each -curl component, vmapped over the three
  in one jit: the JAX driver's three eager solves take ~22 s on the CPU):
  velocity within 1e-4 of max|u|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_jax_twins as twins
from cup3d_tpu_torch.__main__ import build_driver
from test_torch_amr_grid import TWO, forests
from test_torch_amr_ops import close
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLUX_STEPS = 5
IMPLICIT_STEPS = 3


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    for k in ("CUP3D_FUSED", "CUP3D_FAULT", "CUP3D_RECOVER", "CUP3D_GETZ",
              "CUP3D_RING_HALO"):
        monkeypatch.delenv(k, raising=False)


def _port(kind, tmp, nsteps, *extra):
    # the first occurrence of a flag wins: ``extra`` overrides the base
    d = build_driver(list(extra) + twins.argv(kind, tmp, nsteps)
                     + ["-device", "cpu"])
    d.init()
    return d


def _flux_rows(path):
    with open(os.path.join(path, "flux.txt")) as f:
        return np.array([[float(x) for x in line.split()] for line in f])


@pytest.mark.parametrize("pipelined", ["0", "1"])
def test_fix_mass_flux_matches_jax(tmp_path, pipelined):
    js = twins.jax_driver("amr_channel", tmp_path / "jax", FLUX_STEPS)
    os.makedirs(tmp_path / "jax")
    js.logger.directory = str(tmp_path / "jax")  # bound when it was built
    js.simulate()
    js.logger.flush()
    d = _port("amr_channel", tmp_path / "p", FLUX_STEPS, "-pipelined",
              pipelined)
    d.simulate()
    assert d.grid.keys == list(js.grid.keys) and d.step_idx == FLUX_STEPS
    want, got = _flux_rows(tmp_path / "jax"), _flux_rows(tmp_path / "p")
    assert got.shape == want.shape == (FLUX_STEPS, 4)
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    # the bulk is an f32 sum of 8,192 cells in another order
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5)
    assert abs(got[-1, 2] - got[-1, 3]) < 0.05 * got[-1, 3]
    close(twins.velocity(d), twins.velocity(js))


@pytest.mark.parametrize("pipelined", ["0", "1"])
def test_umax_forced_matches_jax(tmp_path, pipelined):
    js = twins.jax_driver("amr_channel", tmp_path / "jax", FLUX_STEPS)
    js.cfg.bFixMassFlux = False  # the constant acceleration alone
    try:
        js.simulate()
    finally:
        js.cfg.bFixMassFlux = True
    d = _port("amr_channel", tmp_path / "p", FLUX_STEPS, "-pipelined",
              pipelined, "-bFixMassFlux", "0")
    d.simulate()
    assert not os.path.exists(tmp_path / "p" / "flux.txt")
    v = twins.velocity(d)
    assert v[..., 0].min() > 0
    close(v, twins.velocity(js))


@pytest.mark.parametrize("pipelined", ["0", "1"])
def test_implicit_forest_run_matches_jax(tmp_path, pipelined):
    js = twins.jax_driver("amr_implicit", tmp_path / "jax", IMPLICIT_STEPS)
    js.simulate()
    d = _port("amr_implicit", tmp_path / "p", IMPLICIT_STEPS, "-pipelined",
              pipelined)
    d.simulate()
    assert d.grid.keys == list(js.grid.keys)
    assert d.time == pytest.approx(js.time, rel=1e-12)
    close(twins.velocity(d), twins.velocity(js), rtol=1e-4)
    assert max(int(s[1]) for s in d._helm.last_stats) >= 1


def test_vorticity_ic_matches_jax(tmp_path):
    """The IC alone on a fixed two-level forest (bpd 2 at level 0, two
    octants refined, extent 2: the coil about (1, 1, 1) crosses the
    coarse-fine faces)."""
    from cup3d_tpu.grid.flux import build_flux_tables
    from cup3d_tpu.ops import amr_ops as jops
    from cup3d_tpu.utils.flows import coil_vorticity
    from cup3d_tpu_torch.config import SimulationConfig
    from cup3d_tpu_torch.sim.amr import AMRSimulation

    jg, tg = forests(("periodic",) * 3, TWO, extent=2.0)
    tab, ftab = jg.face_tables(1), build_flux_tables(jg)
    solver = jops.build_amr_poisson_solver(jg, tab=tab, flux_tab=ftab)

    @jax.jit
    def ic(xc):
        om = coil_vorticity(xc)
        curl = jops.curl_blocks(jg, tab.assemble_vector(om, jg.bs),
                                tab.width)
        return jax.vmap(lambda r: solver(-r, tab_arg=tab, flux_arg=ftab),
                        in_axes=-1, out_axes=-1)(curl)

    want = ic(jnp.asarray(jg.cell_centers(jnp.float32)))
    d = AMRSimulation(SimulationConfig(
        bpdx=2, bpdy=2, bpdz=2, levelMax=2, extent=2.0,
        initCond="vorticity", poissonSolver="iterative", verbose=False,
        path4serialization=str(tmp_path)), tree=tg.tree, device="cpu")
    d._ic()
    assert d.grid.keys == list(jg.keys)
    assert len(set(d.grid.level.tolist())) == 2
    close(twins.velocity(d), want, rtol=1e-4)
