"""The port's fish rasterization (models/fish/rasterize.py, ops/chi.py
``towers_chi``, ``StefanFish.create``) against the JAX package's, on a
32^3 grid at four gait phases of a yawed fish: sdf and udef within 1e-5
abs, chi within 1e-5 abs, the body volume sum(chi) within 1e-5 rel; and
the degenerate-tip far field (tests/test_fish_rasterize.py)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cup3d_tpu.grid.uniform import UniformGrid as JGrid
from cup3d_tpu.models.fish.rasterize import rasterize_midline as j_raster
from cup3d_tpu.models.fish.rasterize import rasterize_points as j_points
from cup3d_tpu.models.fish.stefanfish import StefanFish as JFish
from cup3d_tpu.ops.chi import towers_chi as j_towers
from cup3d_tpu_torch.grid.uniform import UniformGrid as TGrid
from cup3d_tpu_torch.models.base import quat_to_rot
from cup3d_tpu_torch.models.fish.rasterize import rasterize_midline
from cup3d_tpu_torch.models.fish.rasterize import rasterize_points
from cup3d_tpu_torch.models.fish.stefanfish import StefanFish as TFish
from cup3d_tpu_torch.ops.chi import towers_chi
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 32
H = 1.0 / N
DT = 1e-3
PHASES = (0.0, 0.25, 0.55, 0.8)
# config #2's fish, its centre on a cell centre (the section is thinner
# than a cell at 32^3) and yawed 20 degrees so the rotations count
SPEC = {"type": "StefanFish", "L": "0.4", "T": "1.0", "xpos": "0.5",
        "ypos": "0.515625", "zpos": "0.515625", "planarAngle": "20",
        "bFixFrameOfRef": "1", "heightProfile": "danio",
        "widthProfile": "stefan"}
MID_KEYS = ("r", "v", "nor", "vnor", "bin", "vbin", "width", "height")


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _fish_pair():
    ext = (1.0, 1.0, 1.0)
    jsim = types.SimpleNamespace(
        grid=JGrid((N, N, N), ext), dtype=jnp.float32,
        cfg=types.SimpleNamespace(pipelined=False), step=1,
        uinf=np.zeros(3))
    tsim = types.SimpleNamespace(
        grid=TGrid((N, N, N), ext), dtype=torch.float32,
        device=torch.device("cpu"), step=1, uinf=np.zeros(3))
    return JFish(jsim, SPEC), TFish(tsim, SPEC)


def _midline(cf):
    return {k: getattr(cf, k) for k in MID_KEYS}


@pytest.fixture(scope="module")
def phases():
    """Per gait phase: the JAX fish's create() fields and its midline,
    and the port's create() fields, both from the same host state."""
    fj, ft = _fish_pair()
    out = []
    for t in PHASES:
        fj.update_shape(t, DT)
        ft.update_shape(t, DT)
        fj.create(t)
        ft.create(t)
        out.append(dict(
            t=t, mid=_midline(fj.myFish), pos=fj.position.copy(),
            rot=quat_to_rot(fj.quaternion), window=ft._window_shape,
            j={k: _np(getattr(fj, k)) for k in ("sdf", "udef", "chi")},
            t_={k: _np(getattr(ft, k)) for k in ("sdf", "udef", "chi")}))
    return out


@pytest.mark.parametrize("i", range(len(PHASES)))
def test_rasterize_midline_and_towers_chi_match(phases, i):
    ph = phases[i]
    w = ph["window"]
    origin = np.array([0.1875, 0.21875, 0.25])
    jmid = {k: jnp.asarray(v, jnp.float32) for k, v in ph["mid"].items()}
    tmid = {k: torch.tensor(v, dtype=torch.float32)
            for k, v in ph["mid"].items()}
    sj, uj = j_raster(jnp.asarray(origin, jnp.float32),
                      jnp.asarray(H, jnp.float32), w, jmid,
                      jnp.asarray(ph["pos"], jnp.float32),
                      jnp.asarray(ph["rot"], jnp.float32))
    o32 = [float(np.float32(v)) for v in origin]
    st, ut = rasterize_midline(
        o32, float(np.float32(H)), w, tmid,
        torch.tensor(ph["pos"], dtype=torch.float32),
        torch.tensor(ph["rot"], dtype=torch.float32), chunk=7)
    sj, uj, st, ut = _np(sj), _np(uj), _np(st), _np(ut)
    assert (sj > 0).sum() > 0
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-5)
    # the Towers chi of one padded SDF
    lab = np.pad(sj, 1, mode="edge").astype(np.float32)
    cj = _np(j_towers(jnp.asarray(lab), H))
    ct = _np(towers_chi(torch.tensor(lab), H))
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("i", range(len(PHASES)))
def test_create_matches(phases, i):
    ph = phases[i]
    j, t = ph["j"], ph["t_"]
    assert j["chi"].sum() > 0
    for k in ("sdf", "udef", "chi"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5, err_msg=k)
    assert abs(t["chi"].sum() - j["chi"].sum()) <= 1e-5 * j["chi"].sum()


def test_degenerate_tips_far_field():
    """Sections of width = height = 0 at the tips paint no near-surface
    sdf far from the body (tests/test_fish_rasterize.py:113), and the
    port's points agree with the JAX package's."""
    nm = 32
    s = np.linspace(0, 0.3, nm)
    taper = np.sin(np.pi * s / 0.3)
    z = np.zeros((nm, 3))
    mid = {"r": np.stack([s, np.zeros(nm), np.zeros(nm)], 1), "v": z,
           "nor": np.tile([0.0, 1.0, 0.0], (nm, 1)), "vnor": z,
           "bin": np.tile([0.0, 0.0, 1.0], (nm, 1)), "vbin": z,
           "width": 0.002 * taper, "height": 0.04 * taper}
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.8, (4096, 3)).astype(np.float32)
    sj, _ = j_points(jnp.asarray(pts),
                     {k: jnp.asarray(v, jnp.float32) for k, v in mid.items()},
                     jnp.zeros(3, jnp.float32), jnp.eye(3, dtype=jnp.float32))
    st, _ = rasterize_points(
        torch.tensor(pts),
        {k: torch.tensor(v, dtype=torch.float32) for k, v in mid.items()},
        torch.zeros(3), torch.eye(3), chunk=5)
    sj, st = _np(sj), _np(st)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)
    td = np.min(np.linalg.norm(pts[:, None, :] - mid["r"][None], axis=-1),
                axis=1)
    far = td > 0.15
    assert far.sum() > 1000
    assert float(st[far].max()) < -0.1
    assert float(np.abs(-st[far] - td[far]).max()) < 0.05
