"""The port's cost accounting (obs/costs.py) against the JAX package's,
on the CPU.

- ``peaks_for_kind``: the H100 entry, and the nominal entry for the CPU
  and for cards with no entry, as the JAX package flags its fallback;
- a cost row's keys equal a JAX row's, and its numbers land in the JAX
  package's gauge names;
- the forest's fused solve, armed at the AMR driver's bind seam under
  ``CUP3D_COSTS=1``: its row's bytes are the JAX package's
  ``bytes_model()`` times the cells and the iterations it executed;
- ``memory_watermarks`` on the CPU returns ``{}`` without raising."""

import numpy as np
import pytest
import torch

from cup3d_tpu.obs import costs as JC
from cup3d_tpu.ops import fused_amr_bicgstab as JFA
from cup3d_tpu_torch.obs import costs as TC
from cup3d_tpu_torch.obs import metrics as TM
from cup3d_tpu_torch.ops import fused_amr_bicgstab as TFA


def test_peaks_for_kind():
    h100 = TC.peaks_for_kind("NVIDIA H100 80GB HBM3")
    assert not h100.nominal
    assert (h100.hbm_bytes_per_s, h100.bf16_flops, h100.f32_flops) == \
        (3.35e12, 989e12, 67e12)
    assert TC.peaks_for_kind("nvidia h100 80gb hbm3") is h100
    for kind in ("NVIDIA A100-SXM4-80GB", "cpu", "", "TPU v5 lite"):
        assert TC.peaks_for_kind(kind) is TC.NOMINAL_FALLBACK
    assert TC.NOMINAL_FALLBACK.nominal and JC.NOMINAL_FALLBACK.nominal
    # the JAX package's table holds no card of the port's and the port's
    # no TPU: each flags the other's kinds nominal
    assert JC.peaks_for_kind("NVIDIA H100 80GB HBM3").nominal
    assert TC.peaks_for_kind("TPU v6e").nominal
    keys = set(JC.NOMINAL_FALLBACK.as_dict())
    assert keys <= set(h100.as_dict())
    before = TM.snapshot().get("costs.unavailable{what=device_kind}", 0)
    assert TC.device_peaks("cpu") is TC.NOMINAL_FALLBACK
    assert TM.snapshot()["costs.unavailable{what=device_kind}"] == before + 1


def test_row_keys_equal_jax_and_gauges():
    import jax
    import jax.numpy as jnp

    compiled = jax.jit(lambda x: x * 2.0).lower(jnp.ones(8)).compile()
    jrow = JC.harvest_compiled("unit.double", compiled)
    x = torch.ones(8)
    row, out = TC.harvest_call(
        "unit.double", lambda v: v * 2.0, (x,),
        cost=TC.model_cost((64.0, lambda: 1)))
    assert torch.equal(out, 2 * x)
    assert row.keys() == jrow.keys()
    assert row["available"].keys() == jrow["available"].keys()
    # the counter did not move over the call: 0 bytes, cost available; no
    # CUDA allocator on the CPU
    assert row["bytes_accessed"] == 0.0 and row["available"]["cost"]
    assert not row["available"]["memory"] and row["peak_bytes"] is None
    assert TC.rows()["unit.double"] == row
    snap = TM.snapshot()
    assert snap["xla.bytes_accessed{executable=unit.double}"] == 0.0
    calls = []
    wrapped = TC.harvest_on_first_call(lambda v: calls.append(v) or v,
                                       "unit.once")
    for i in range(3):
        wrapped(i)
    assert calls == [0, 1, 2] and "unit.once" in TC.rows()
    assert not TC.rows()["unit.once"]["available"]["cost"]


AMR = ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 2 -levelStart 0 -Rtol 1e9 "
       "-Ctol 0 -extent 6.283185307179586 -initCond taylorGreen "
       "-poissonSolver iterative -nu 1e-3 -dt 1e-3 -tend 0 -nsteps 1 "
       "-verbose 0 -device cpu")


@pytest.mark.parametrize("krylov_dtype", ["f32", "bf16"])
def test_forest_fused_solve_row_bytes_equal_jax_model(
        krylov_dtype, tmp_path, monkeypatch):
    from cup3d_tpu_torch.__main__ import build_driver

    monkeypatch.setenv("CUP3D_COSTS", "1")
    monkeypatch.setenv("CUP3D_FUSED", "1")
    monkeypatch.setenv("CUP3D_KRYLOV_DTYPE", krylov_dtype)
    jdt = {"f32": None, "bf16": "bfloat16"}[krylov_dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[krylov_dtype]
    import jax.numpy as jnp

    d = build_driver((AMR + f" -path4serialization {tmp_path}").split())
    d.init()
    assert d._solver.__wrapped__ is not None  # armed at the bind seam
    rng = np.random.default_rng(3)
    p = d.state["p"]
    rhs = torch.as_tensor(rng.standard_normal(tuple(p.shape)),
                          dtype=p.dtype) * d._pmask
    rhs = rhs - torch.sum(rhs) / torch.sum(d._pmask * 512)
    rhs = rhs * d._pmask
    e0 = TFA.iterations["executed"]
    d._solver(rhs)
    executed = TFA.iterations["executed"] - e0
    assert executed > 0
    two = d._graph is not None
    cells = d._geom.nb * d.grid.bs ** 3
    jmodel = JFA.bytes_model(
        store_dtype=None if jdt is None else getattr(jnp, jdt),
        two_level=two)
    assert TFA.bytes_model(store_dtype=tdt, two_level=two) == jmodel
    row = TC.rows()["forest.poisson"]
    assert row["bytes_accessed"] == jmodel["total"] * cells * executed
    assert row["available"] == {"cost": True, "memory": False}
    # later solves pay the plain call
    e1 = TFA.iterations["executed"]
    d._solver(rhs)
    assert TC.rows()["forest.poisson"] == row
    assert TFA.iterations["executed"] > e1


def test_memory_watermarks_on_the_cpu():
    before = TM.snapshot().get("costs.unavailable{what=devices}", 0)
    assert TC.memory_watermarks() == {}
    assert TM.snapshot()["costs.unavailable{what=devices}"] == before + 1
