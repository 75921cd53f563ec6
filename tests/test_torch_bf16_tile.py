"""The tile-only bf16 solve (``CUP3D_COARSE=0`` or the recovery ladder's
last rung under ``CUP3D_KRYLOV_DTYPE=bf16``) on BASELINE config #2's first
pressure system at 128^3, in both packages on the CPU.

The system is the one the card's run solves (chip_smoke.py phase 26
catches it there and holds it to ``data/config2_128_first_rhs.npz``, its
nonzero cells by flat index).  A tile-only bf16 solve of it is unstable:
with 1e-5 of max |rhs| of seeded noise added, the JAX package's own solve
breaks down (a NaN residual at iteration 693 of 1000) while its f32 solve
converges in under 40 iterations.  The port's solve of the same input
runs the same arithmetic in another summation order, so it may break
down too or converge; where it converges its residual is under the
target.  The best x a solve keeps, broken down or not, is what the
driver uses: JAX's and the port's are within 1e-2 of max |x| of JAX's
f32 x, their means removed as the solver front-end removes them (the
periodic system fixes x up to a constant; chip_smoke.py phase 26 holds
the card's kernel solves of this system by the same bound)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cup3d_tpu.grid.uniform import UniformGrid as JGrid
from cup3d_tpu.ops import fused_bicgstab as jfb
from cup3d_tpu.ops import krylov as jk
from cup3d_tpu_torch.grid.uniform import UniformGrid as TGrid
from cup3d_tpu_torch.ops import fused_bicgstab as tfb
from cup3d_tpu_torch.ops import krylov as tk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SYSTEM = os.path.join(os.path.dirname(__file__), "data",
                      "config2_128_first_rhs.npz")
NOISE = 1e-5        # of max |rhs|, one draw of default_rng(NOISE_SEED)
NOISE_SEED = 100
MAXITER = 1000
F32_ITS = 40        # the f32 tile-only solve converges under this
X_RTOL = 1e-2       # a converged bf16 x, of max |x| of the f32 x


def _rhs():
    z = np.load(SYSTEM)
    rhs = np.zeros(int(np.prod(z["shape"])), np.float32)
    rhs[z["idx"]] = z["val"]
    rhs = rhs.reshape(tuple(z["shape"]))
    rng = np.random.default_rng(NOISE_SEED)
    noise = rng.standard_normal(rhs.shape).astype(np.float32)
    return (rhs + NOISE * np.abs(rhs).max() * noise).astype(np.float32)


def test_tile_only_bf16_breaks_down_on_config2_in_jax():
    rhs = _rhs()
    n = rhs.shape[0]
    jg, tg = JGrid((n,) * 3, (1.0,) * 3), TGrid((n,) * 3, (1.0,) * 3)
    kw = dict(tol_abs=1e-6, tol_rel=1e-4, maxiter=MAXITER, two_level=False)

    def jsolve(r, store):
        bt = jk.to_lanes(r - jnp.mean(r))
        return jfb.fused_bicgstab(jg, bt, rnorm_ref=jnp.sqrt(jk._dot(bt, bt)),
                                  store_dtype=store, kernels=False, **kw)

    b = rhs - rhs.mean(dtype=np.float64)
    target = max(1e-6, 1e-4 * float(np.sqrt(np.sum(b.astype(np.float64)
                                                   ** 2))))
    x32, rn32, k32 = jax.jit(lambda r: jsolve(r, jnp.float32))(
        jnp.asarray(rhs))
    assert int(k32) < F32_ITS and float(rn32) <= 1.01 * target
    xj, rnj, kj = jax.jit(lambda r: jsolve(r, jnp.bfloat16))(
        jnp.asarray(rhs))
    # the reference breaks down: a NaN residual (or a stall at maxiter)
    assert not float(rnj) <= target, (int(kj), float(rnj))

    def centred(x):
        x = np.asarray(x, np.float64)
        return x - x.mean()

    x32 = centred(x32)
    scale = X_RTOL * np.abs(x32).max()
    assert np.abs(centred(xj) - x32).max() <= scale

    tr = torch.as_tensor(rhs)
    bt = tk.to_lanes(tr - torch.mean(tr))
    x_t, rn_t, k_t = tfb.fused_bicgstab(
        tg, bt, rnorm_ref=torch.sqrt(torch.sum(bt * bt)),
        store_dtype=torch.bfloat16, **kw)
    assert (float(rn_t) <= target and int(k_t) < MAXITER
            or int(k_t) == MAXITER or not np.isfinite(float(rn_t)))
    assert np.abs(centred(x_t.numpy()) - x32).max() <= scale
