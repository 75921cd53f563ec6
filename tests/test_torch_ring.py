"""The port's ring transport (parallel/ring.py) against the JAX package's.

The JAX side runs under ``shard_map`` on the conftest's virtual CPU
devices, its ``ring_shift`` on the ``ppermute`` transport (the TPU
kernel B14 is off on the CPU); the port's shards are a leading axis of
one CPU tensor, its ``ring_shift`` on the plain per-shard copy (kernel
B14 runs on CUDA shards only: tests/test_torch_cuda.py, chip_smoke.py).
The same numpy inputs go through both:

- ``ring_shift`` at D = 2, 4, 8 and shifts +-1, +-3, and
  ``ring_all_to_all``: bitwise equal to JAX (pure data movement), and
  ``ring_all_to_all`` bitwise equal to the port's axis swap, from
  contiguous and strided sources, into new tensors and into views;
- the kernel wrapper's refusals, which it checks before it looks at the
  device (so they show on the CPU);
- ``pad_slab_scalar`` / ``pad_slab_vector`` at widths 1 and 3 on a
  64x16x16 grid cut into 8 x-slabs, periodic and wall: bitwise equal to
  JAX and to slices of the port's unsharded padding;
- ``make_laplacian_lanes_sharded`` on the same grids: within 1e-5 of
  the max |value| of JAX's (the stencil sums in another order; the JAX
  package holds its own sharded Laplacian to that bound against its
  unsharded one, tests/test_sharding.py) and of the port's unsharded
  ``krylov.make_laplacian_lanes``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from cup3d_tpu.grid.uniform import BC as JBC
from cup3d_tpu.grid.uniform import UniformGrid as JGrid
from cup3d_tpu.ops import krylov as jk
from cup3d_tpu.parallel import ring as jring
from cup3d_tpu.parallel.compat import shard_map
from cup3d_tpu_torch.grid.uniform import BC as TBC
from cup3d_tpu_torch.grid.uniform import UniformGrid as TGrid
from cup3d_tpu_torch.ops import krylov as tk
from cup3d_tpu_torch.parallel import compat, ring
from cup3d_tpu_torch.parallel.forest import make_block_mesh
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHIFTS = (1, -1, 3, -3)
DS = (2, 4, 8)
LAP_RTOL = 1e-5
SLABS = 8
SHAPE = (64, 16, 16)
WIDTHS = (1, 3)
CPU = torch.device("cpu")


def _mesh(D):
    return Mesh(np.asarray(jax.devices()[:D]), ("x",))


@pytest.fixture(scope="module")
def jax_ring():
    """Per D: the inputs and JAX's ring_shift at every shift and its
    ring_all_to_all, one jitted shard_map."""
    out = {}
    rng = np.random.default_rng(0)
    for D in DS:
        x = rng.standard_normal((D * 6, 5)).astype(np.float32)
        send = rng.standard_normal((D * D, 3, 4)).astype(np.float32)

        def body(xs, ss):
            return tuple(jring.ring_shift(xs, "x", k) for k in SHIFTS) + (
                jring.ring_all_to_all(ss, "x"),)

        f = jax.jit(shard_map(body, mesh=_mesh(D), in_specs=(P("x"), P("x")),
                              out_specs=(P("x"),) * (len(SHIFTS) + 1),
                              check_vma=False))
        out[D] = (x, send, [np.asarray(a) for a in f(x, send)])
    return out


def _strided(t: torch.Tensor, pad: int = 2) -> torch.Tensor:
    """t's values as a view whose last axis sits inside wider rows (a
    chunk of it is rows, not one contiguous run)."""
    big = torch.full(t.shape[:-1] + (t.shape[-1] + 2 * pad,), float("nan"))
    big[..., pad:pad + t.shape[-1]] = t
    return big[..., pad:pad + t.shape[-1]]


@pytest.mark.parametrize("D", DS)
def test_ring_shift_matches_jax(jax_ring, D):
    """Contiguous and strided shards (a chunk of rows, read in place by
    the kernel): the same function."""
    x, _, want = jax_ring[D]
    xt = torch.as_tensor(x).reshape(D, 6, 5)
    for k, w in zip(SHIFTS, want):
        for src in (xt, _strided(xt)):
            got = ring.ring_shift(src, k)
            np.testing.assert_array_equal(got.reshape(D * 6, 5).numpy(), w)
            assert torch.equal(got, torch.roll(xt, k, dims=0))


@pytest.mark.parametrize("D", DS)
def test_ring_all_to_all_matches_jax_and_the_swap(jax_ring, D):
    """Out of place and into a view of a wider buffer (the recv region
    of faces.py), from a contiguous and a strided send buffer, all
    steps at once and one step a call: the same function."""
    _, send, want = jax_ring[D]
    st = torch.as_tensor(send).reshape(D, D, 3, 4)
    got = ring.ring_all_to_all(st)
    np.testing.assert_array_equal(got.reshape(D * D, 3, 4).numpy(), want[-1])
    assert torch.equal(got, compat.all_to_all(st))
    for src in (st, _strided(st)):
        ext = torch.full((D, D * 3 + 2, 4), float("nan"))
        region = ext[:, 1:1 + D * 3].unflatten(1, (D, 3))
        ring.ring_all_to_all(src, out=region)
        assert torch.equal(region, got)
        assert ext[:, 0].isnan().all() and ext[:, -1].isnan().all()
        steps = torch.empty_like(st)
        for k in range(D):
            ring.ring_steps_plain(src, steps, k, 1, chunked=True)
        assert torch.equal(steps, got)


@pytest.mark.parametrize("case", ["cpu", "overlap", "stride", "repeat",
                                  "shape"])
def test_ring_step_kernel_refusals(case):
    """The kernel's wrapper refuses, before any launch: CPU shards, an
    out that overlaps the source, a chunk that is not rows of contiguous
    elements, an out that repeats elements, mismatched shapes."""
    x = torch.arange(4 * 6 * 6, dtype=torch.float32).reshape(4, 6, 6)
    out, chunked, match = torch.empty_like(x), False, "CUDA"
    if case == "overlap":
        out, match = x, "overlaps"
    elif case == "stride":
        x, match = x[:, ::2, ::2], "rows"
        out = torch.empty_like(x)
    elif case == "repeat":
        out, match = torch.zeros(1, 6, 6).expand(4, 6, 6), "repeats"
    elif case == "shape":
        out, chunked, match = torch.empty(4, 4, 6, 6), True, "D, D"
    with pytest.raises(ValueError, match=match):
        ring.ring_steps_kernel(x, out, 1, chunked=chunked)
    assert ring.launches["ring_shift"] == 0


def test_ring_dma_knob_on_cpu_shards(monkeypatch):
    """auto and 0: the plain transport on CPU shards (no launch); 1:
    raises, the kernel moves CUDA shards only."""
    x = torch.arange(12.0).reshape(4, 3)
    for v in ("auto", "0"):
        monkeypatch.setenv("CUP3D_RING_DMA", v)
        ring.reset_launches()
        assert torch.equal(ring.ring_shift(x, 1), torch.roll(x, 1, 0))
        assert ring.launches["ring_shift"] == 0
        assert not ring.use_ring_dma(CPU)
    monkeypatch.setenv("CUP3D_RING_DMA", "1")
    with pytest.raises(RuntimeError, match="CUP3D_RING_DMA=1"):
        ring.ring_shift(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ring.ring_shift_kernel(x, 1)


@pytest.fixture(scope="module")
def jax_slabs():
    """Per BC: the field, JAX's slab padding (scalar and vector, each
    width) and its sharded lanes Laplacian, one jitted shard_map."""
    out = {}
    rng = np.random.default_rng(7)
    f = rng.standard_normal(SHAPE).astype(np.float32)
    u = rng.standard_normal(SHAPE + (3,)).astype(np.float32)
    mesh = _mesh(SLABS)
    for bc in ("periodic", "wall"):
        jg = JGrid(SHAPE, (1.0, 0.25, 0.25), (JBC(bc),) * 3)

        def body(fs, us):
            return tuple(
                a for w in WIDTHS
                for a in (jring.pad_slab_scalar(jg, fs, w, "x"),
                          jring.pad_slab_vector(jg, us, w, "x")))

        pads = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"), P("x")),
                                 out_specs=(P("x"),) * (2 * len(WIDTHS)),
                                 check_vma=False))(f, u)
        t = jk.to_lanes(jnp.asarray(f))
        lap = jax.jit(jring.make_laplacian_lanes_sharded(jg, mesh))(t)
        out[bc] = (f, u, [np.asarray(a) for a in pads], np.asarray(lap))
    return out


@pytest.mark.parametrize("bc", ["periodic", "wall"])
def test_slab_padding_matches_jax_and_unsharded(jax_slabs, bc):
    f, u, want, _ = jax_slabs[bc]
    tg = TGrid(SHAPE, (1.0, 0.25, 0.25), (TBC(bc),) * 3)
    sx = SHAPE[0] // SLABS
    ft, ut = torch.as_tensor(f), torch.as_tensor(u)
    for i, w in enumerate(WIDTHS):
        got_s = ring.pad_slab_scalar(tg, ft.reshape(SLABS, sx, 16, 16), w)
        got_v = ring.pad_slab_vector(tg, ut.reshape(SLABS, sx, 16, 16, 3), w)
        np.testing.assert_array_equal(
            got_s.reshape((-1,) + tuple(got_s.shape[2:])).numpy(),
            want[2 * i])
        np.testing.assert_array_equal(
            got_v.reshape((-1,) + tuple(got_v.shape[2:])).numpy(),
            want[2 * i + 1])
        full_s, full_v = tg.pad_scalar(ft, w), tg.pad_vector(ut, w)
        for s in range(SLABS):
            assert torch.equal(got_s[s], full_s[s * sx:s * sx + sx + 2 * w])
            assert torch.equal(got_v[s], full_v[s * sx:s * sx + sx + 2 * w])


@pytest.mark.parametrize("bc", ["periodic", "wall"])
def test_sharded_lanes_laplacian_matches_jax_and_unsharded(jax_slabs, bc):
    f, _, _, want = jax_slabs[bc]
    tg = TGrid(SHAPE, (1.0, 0.25, 0.25), (TBC(bc),) * 3)
    t = tk.to_lanes(torch.as_tensor(f))
    got = ring.make_laplacian_lanes_sharded(
        tg, make_block_mesh([CPU] * SLABS))(t)
    ref = tk.make_laplacian_lanes(tg)(t)
    for other in (want, ref.numpy()):
        scale = float(np.abs(other).max())
        np.testing.assert_allclose(got.numpy(), other, rtol=0,
                                   atol=LAP_RTOL * scale)


def test_sharded_lanes_laplacian_rejects_ragged_slab():
    tg = TGrid((32, 16, 16), (1.0, 0.5, 0.5))
    with pytest.raises(ValueError, match="x-slab"):
        ring.make_laplacian_lanes_sharded(tg, make_block_mesh([CPU] * 8))
