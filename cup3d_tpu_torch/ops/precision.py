"""Mixed-precision policy knobs for the Krylov loop (port of
``cup3d_tpu/ops/precision.py``), with the same environment variables:

- ``CUP3D_KRYLOV_DTYPE``: storage dtype of the Krylov vectors.  ``f32``
  (the default) is all the port's kernels take; ``bf16`` storage is
  still to be ported (ROADMAP "bf16 Krylov storage") and raises.
- ``CUP3D_FUSED``: ``1`` routes ``build_iterative_solver`` through the
  fused per-iteration driver (the CUDA kernel path), ``0`` forces the
  legacy composition, ``auto`` (default) = fused iff bf16.

Accumulations (dots, tile-solve transforms, coarse einsums) are f32.
Read per call, like the JAX package, so tests can flip them.
"""

from __future__ import annotations

import os

import torch

_F32_KEYS = ("", "f32", "float32")
_BF16_KEYS = ("bf16", "bfloat16")


def krylov_dtype():
    """Storage dtype for Krylov vectors (CUP3D_KRYLOV_DTYPE; f32 default)."""
    key = os.environ.get("CUP3D_KRYLOV_DTYPE", "").strip().lower()
    if key in _F32_KEYS:
        return torch.float32
    if key in _BF16_KEYS:
        raise NotImplementedError(
            "CUP3D_KRYLOV_DTYPE=bf16: bf16 Krylov storage is not ported to "
            "the CUDA kernels yet (ROADMAP queue B, 'bf16 Krylov storage')"
        )
    raise ValueError(
        f"CUP3D_KRYLOV_DTYPE={key!r}: expected one of "
        f"{sorted(k for k in _F32_KEYS + _BF16_KEYS if k)}"
    )


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
    return krylov_dtype() != torch.float32


def check_policy(mean_constraint: int = 2) -> None:
    """Build-time validation of the knobs (raises on bf16, see
    :func:`krylov_dtype`)."""
    krylov_dtype()


def check_fp32_matmul() -> None:
    """The tile solve, coarse level and spectral transforms run in true
    f32 (the JAX package's Precision.HIGHEST): a TF32 preconditioner
    stalls BiCGSTAB (cup3d_tpu/ops/tilesolve.py:26-29)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the Poisson "
            "solver's matmuls must run in full f32"
        )
