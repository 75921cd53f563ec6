"""Mixed-precision policy knobs for the Krylov loop (port of
``cup3d_tpu/ops/precision.py``), with the same environment variables:

- ``CUP3D_KRYLOV_DTYPE``: storage dtype of the Krylov vectors, ``f32``
  (the default) or ``bf16``.  Under bf16 the fused drivers store r, rhat,
  p, v, y, z, s, t in bf16 and run the bf16 builds of their kernels;
  every dot, tile-solve transform and coarse solve accumulates in f32,
  and x stays f32.
- ``CUP3D_FUSED``: ``1`` routes ``build_iterative_solver`` through the
  fused per-iteration driver (the CUDA kernel path), ``0`` forces the
  legacy composition, ``auto`` (default) = fused iff bf16.

Where bf16 is asked for but the fused route is not taken (mean
constraint 1 or 3, ``CUP3D_GETZ=cg``, the forest under ``CUP3D_FUSED=0``,
the sharded forest's static solver) the legacy composition runs at f32,
as in the JAX package; only the uniform ``build_iterative_solver`` under
``CUP3D_FUSED=0`` refuses bf16 (:func:`check_policy`).

Read per call, like the JAX package, so tests can flip them.
"""

from __future__ import annotations

import os

import torch

_DTYPES = {
    "": torch.float32,
    "f32": torch.float32,
    "float32": torch.float32,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
}


def krylov_dtype():
    """Storage dtype for Krylov vectors (CUP3D_KRYLOV_DTYPE; f32 default)."""
    key = os.environ.get("CUP3D_KRYLOV_DTYPE", "").strip().lower()
    try:
        return _DTYPES[key]
    except KeyError:
        raise ValueError(
            f"CUP3D_KRYLOV_DTYPE={key!r}: expected one of "
            f"{sorted(k for k in _DTYPES if k)}"
        ) from None


def accum_dtype(dtype):
    """Accumulation dtype for reductions over ``dtype``: at least f32."""
    return torch.promote_types(dtype, torch.float32)


def use_fused() -> bool:
    """Whether build_iterative_solver routes through the fused driver
    (CUP3D_FUSED: auto = fused iff bf16 storage, 1 = fused, 0 = legacy)."""
    v = os.environ.get("CUP3D_FUSED", "auto").strip().lower()
    if v in ("1", "true", "yes"):
        return True
    if v in ("0", "false", "no"):
        return False
    return krylov_dtype() == torch.bfloat16


def check_policy(mean_constraint: int = 2) -> None:
    """Build-time validation of the knob combination: a bf16 request
    without the fused driver raises instead of silently downgrading (the
    uniform solver's rule; the forest's solver does not call this)."""
    if krylov_dtype() == torch.bfloat16 and not use_fused():
        raise ValueError(
            "CUP3D_KRYLOV_DTYPE=bf16 requires the fused iteration driver "
            "(its cast discipline keeps accumulations f32); unset "
            "CUP3D_FUSED=0 or use f32 storage"
        )


def check_fp32_matmul() -> None:
    """The tile solve, coarse level and spectral transforms run in true
    f32 (the JAX package's Precision.HIGHEST): a TF32 preconditioner
    stalls BiCGSTAB (cup3d_tpu/ops/tilesolve.py:26-29)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the Poisson "
            "solver's matmuls must run in full f32"
        )
