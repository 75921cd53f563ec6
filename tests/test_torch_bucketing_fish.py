"""One StefanFish on a small bucketed forest, the port's driver against
the JAX package's bucketed one (its production path, ``CUP3D_BUCKET``
at its default), on the CPU: BASELINE config #4's forest (bpd 1,
levelMax 3, levelStart 2; tests/test_torch_jax_twins.py's "amr_fish")
with its first fish alone, the port on the plain versions of its fused
forest stages.  After ``init()`` the leaf keys and capacities are equal;
over 2 steps dt within 1e-6 relative and the Poisson iterations +-1;
after them the fish's rigid state within 1e-5, its force pack within
1e-4 of its largest entry and the velocity within 1e-5 of max|u| (the
bounds of tests/test_torch_amr_fish.py); every padding row of the port's
fields is exactly 0."""

import os

import numpy as np
import torch

import test_torch_jax_twins as twins
from cup3d_tpu.__main__ import build_driver as jbuild
from cup3d_tpu_torch.__main__ import build_driver
from test_torch_amr_fish import FORCES, RIGID, _vec
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 2


def test_one_fish_bucketed_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("CUP3D_BUCKET", raising=False)
    monkeypatch.setenv("CUP3D_FUSED", "1")
    argv = twins.argv("amr_fish", tmp_path, STEPS)
    argv[-1] = twins.TWO_FISH.splitlines()[0]
    js = jbuild(argv)
    ts = build_driver(argv + ["-device", "cpu"])
    assert js._bucketing and ts._bucketing
    js.init()
    ts.init()
    assert ts.grid.keys == list(js.grid.keys)
    assert ts._cap == js._cap > ts.grid.nb
    for _ in range(STEPS):
        js.advance(js.calc_max_timestep())
        ts.advance(ts.calc_max_timestep())
        assert abs(ts.dt - js.dt) <= 1e-6 * js.dt
        j_iters = js.flight.residuals[-1]["iters"]
        assert abs(ts.step_log[-1]["iters"] - j_iters) <= 1
    (job,), (tob,) = js.obstacles, ts.obstacles
    assert np.abs(_vec(tob, RIGID) - _vec(job, RIGID)).max() <= 1e-5
    jf = _vec(job, FORCES)
    assert np.abs(_vec(tob, FORCES) - jf).max() <= 1e-4 * np.abs(jf).max()
    want = np.asarray(js._unpad(js.state["vel"]))
    got = ts._unpad(ts.state["vel"]).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    nb = ts.grid.nb
    for k, f in ts.state.items():
        assert f.shape[0] == ts._cap
        assert float(torch.max(torch.abs(f[nb:]))) == 0.0, k
    assert os.environ.get("CUP3D_BUCKET") is None
