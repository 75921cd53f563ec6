"""The port's native lab-table builder (cup3d_tpu_torch/native.py, its
own copy of the C++ source built with g++ at first use) against the
port's numpy builder, bitwise, and against the JAX package's numpy
tables, on a periodic forest, closed boundaries and a deep tree.  Also
``CUP3D_NO_NATIVE=1`` (numpy) and a failed build (raises with the
compiler's output; numpy is not taken in the library's place)."""

import numpy as np
import pytest

import cup3d_tpu.native as jnative
from cup3d_tpu.grid.blocks import BlockGrid as JGrid
from cup3d_tpu.grid.octree import Octree as JOctree
from cup3d_tpu.grid.octree import TreeConfig as JTreeConfig
from cup3d_tpu.grid.uniform import BC as JBC
from cup3d_tpu_torch import native
from cup3d_tpu_torch.grid.blocks import BlockGrid
from cup3d_tpu_torch.grid.octree import Octree, TreeConfig
from cup3d_tpu_torch.grid.uniform import BC

ARRAYS = ("g_idx", "g_w", "g_sign", "mask_coarse", "s_idx", "s_w", "s_sign",
          "interp_w")

#: (blocks per dim, levelMax, BCs, refinement rounds of the low corner)
FORESTS = {
    "periodic": ((2, 2, 2), 2, ("periodic",) * 3, 1),
    "closed": ((2, 2, 2), 2, ("periodic", "wall", "freespace"), 1),
    "deep": ((1, 2, 1), 4, ("wall", "periodic", "periodic"), 3),
}


def _refine(tree, rounds):
    """Refine the finest leaves touching the low corner, ``rounds`` times,
    each round's coarser neighbours refined too (the 2:1 balance of
    grid/adapt.valid_states)."""
    from cup3d_tpu_torch.grid.adapt import valid_states

    for _ in range(rounds):
        lvl = max(k[0] for k in tree.leaves)
        st = {k: "R" if k[0] == lvl and max(k[1:]) == 0 else "L"
              for k in tree.leaves}
        for key, v in valid_states(tree, st).items():
            if v == "R":
                tree.refine(key)
    tree.assert_balanced()


def _grids(kind):
    bpd, lmax, bcs, rounds = FORESTS[kind]
    periodic = tuple(b == "periodic" for b in bcs)
    tt = Octree(TreeConfig(bpd, lmax, periodic), 0)
    _refine(tt, rounds)
    jt = JOctree(JTreeConfig(bpd, lmax, periodic), 0)
    jt.leaves.clear()
    for key in tt.leaves:
        jt.leaves[key] = None
    ext = tuple(float(n) / max(bpd) for n in bpd)
    tg = BlockGrid(tt, ext, tuple(BC(b) for b in bcs), 8)
    jg = JGrid(jt, ext, tuple(JBC(b) for b in bcs), 8)
    assert tg.keys == list(jg.keys)
    return tg, jg


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("kind", sorted(FORESTS))
def test_native_tables_equal_numpy_and_jax(kind, width, monkeypatch):
    tg, jg = _grids(kind)
    nat = tg._build_lab_tables(width)  # the native builder (the default)
    ref = tg._build_lab_tables_numpy(width)
    for k in ARRAYS:
        assert nat[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(nat[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(nat["ghost_xyz"], ref["ghost_xyz"])
    assert nat["any_coarse"] == ref["any_coarse"]
    if kind != "periodic":
        assert nat["any_coarse"]
    # the JAX package's numpy build (its native library kept out)
    monkeypatch.setattr(jnative, "build_lab_tables", lambda *a, **k: None)
    jt = jg._build_lab_tables(width)
    for k in ARRAYS:
        np.testing.assert_array_equal(nat[k], np.asarray(getattr(jt, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(
        nat["ghost_xyz"], np.stack([np.asarray(a) for a in jt.ghost_xyz], -1))


def test_no_native_selects_numpy(monkeypatch):
    tg, _ = _grids("closed")

    def refuse(*a, **k):
        raise AssertionError("the native builder ran under CUP3D_NO_NATIVE")

    monkeypatch.setenv("CUP3D_NO_NATIVE", "1")
    monkeypatch.setattr(native, "build_lab_tables", refuse)
    assert not native.enabled()
    out = tg._build_lab_tables(1)
    np.testing.assert_array_equal(out["g_idx"],
                                  tg._build_lab_tables_numpy(1)["g_idx"])


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    tg, _ = _grids("periodic")
    monkeypatch.delenv("CUP3D_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="(?s)bad.cpp.*error"):
        tg._build_lab_tables(1)
    assert not list(tmp_path.glob("*.so"))
