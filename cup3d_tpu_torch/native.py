"""ctypes bridge to the native lab-table builder (port of
``cup3d_tpu/native.py``; the source is the port's own copy,
``cup3d_tpu_torch/csrc/tables.cpp``).

The reference's synchronizer set-up is C++ (SynchronizerMPI_AMR::_Setup,
main.cpp:1979-2322); so is ours: the per-topology gather-table build of
grid/blocks.py runs in a shared library built from that source with
``g++`` at its first use, into ``cup3d_tpu_torch/csrc/build/`` (named by
a hash of the source and the flags, so a changed source is never loaded
stale).  The numpy builder in grid/blocks.py stays as the reference
(bit-identical tables).

``CUP3D_NO_NATIVE=1`` selects the numpy builder.  Otherwise a failed
build raises with the compiler's output: the numpy builder is never
taken quietly in the library's place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "tables.cpp"
BUILD = SOURCE.parent / "build"
CXX = os.environ.get("CXX", "g++")
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """Whether the lab tables come from the native builder (read at
    each build: ``CUP3D_NO_NATIVE=1`` selects numpy)."""
    return os.environ.get("CUP3D_NO_NATIVE", "") in ("", "0")


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join((CXX,) + FLAGS).encode())
    return BUILD / f"libcup3d_tables_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is there (under a file lock, so
    parallel processes build it once); raise with the compiler's output
    when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "tables.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return out
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            try:
                res = subprocess.run(
                    [CXX, *FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True, timeout=300)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"building {SOURCE.name} failed ({CXX} exit "
                        f"{res.returncode}):\n{res.stdout}{res.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load() -> ctypes.CDLL:
    """The loaded library (built at the first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.cup3d_build_lab_tables.restype = ctypes.c_int
    lib.cup3d_build_lab_tables.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nb bs w lmax
        i64p, i32p, i32p, i64p,  # bpd bc levels ijk
        i32p, u8p, i64p,  # slot_flat int_flat lvl_off
        ctypes.c_int, i64p,  # ng gxyz
        i64p, f32p, f32p, u8p,  # g_idx g_w g_sign mask
        ctypes.c_int, i64p, f32p, f32p,  # cw s_idx s_w s_sign
        ctypes.POINTER(ctypes.c_int32),  # any_coarse
    ]
    _lib = lib
    return lib


_BC_CODE = {"periodic": 0, "wall": 1, "freespace": 2}


def build_lab_tables(grid, w: int, gxyz: np.ndarray, cw: int) -> dict:
    """Native lab-table build for BlockGrid ``grid`` at stencil width
    ``w``: ``gxyz`` (ng, 3) the lab-coordinate ghost list (the numpy
    builder's), ``cw`` the coarse halo depth.  Returns the per-block
    arrays g_idx, g_w, g_sign, mask_coarse, s_idx, s_w, s_sign and
    any_coarse, as the numpy builder's."""
    lib = load()
    nb, bs = grid.nb, grid.bs
    cfg = grid.tree.cfg
    ng = gxyz.shape[0]
    ns = (bs // 2 + 2 * cw) ** 3

    # the per-level dense maps, flattened
    lvl_off = np.zeros(cfg.level_max + 1, np.int64)
    for l in range(cfg.level_max):
        lvl_off[l + 1] = lvl_off[l] + grid._slot_maps[l].size
    slot_flat = np.concatenate(
        [m.reshape(-1) for m in grid._slot_maps]).astype(np.int32)
    int_flat = np.concatenate(
        [m.reshape(-1) for m in grid._int_maps]).astype(np.uint8)
    bc_codes = np.array([_BC_CODE[b.value] for b in grid.bc], np.int32)

    g_idx = np.empty((nb, ng, 8), np.int64)
    g_w = np.empty((nb, ng, 8), np.float32)
    g_sign = np.empty((nb, ng, 3), np.float32)
    mask = np.empty((nb, ng), np.uint8)
    s_idx = np.empty((nb, ns, 8), np.int64)
    s_w = np.empty((nb, ns, 8), np.float32)
    s_sign = np.empty((nb, ns, 3), np.float32)
    any_coarse = ctypes.c_int32(0)

    rc = lib.cup3d_build_lab_tables(
        nb, bs, w, cfg.level_max,
        np.ascontiguousarray(np.asarray(cfg.bpd, np.int64)),
        bc_codes,
        np.ascontiguousarray(grid.level.astype(np.int32)),
        np.ascontiguousarray(grid.ijk.astype(np.int64).reshape(-1)),
        slot_flat, int_flat, lvl_off,
        ng, np.ascontiguousarray(gxyz.astype(np.int64).reshape(-1)),
        g_idx.reshape(-1), g_w.reshape(-1), g_sign.reshape(-1),
        mask.reshape(-1),
        cw, s_idx.reshape(-1), s_w.reshape(-1), s_sign.reshape(-1),
        ctypes.byref(any_coarse),
    )
    if rc != 0:
        raise KeyError("unresolved owner: tree not 2:1 balanced?")
    return {
        "g_idx": g_idx, "g_w": g_w, "g_sign": g_sign,
        "mask_coarse": mask.astype(bool),
        "s_idx": s_idx, "s_w": s_w, "s_sign": s_sign,
        "any_coarse": bool(any_coarse.value),
    }
