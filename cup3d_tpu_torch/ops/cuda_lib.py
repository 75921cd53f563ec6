"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface; each is compiled
with its own ``nvcc`` for ``sm_90a`` into a shared library, all sources
at once (the compilers run in parallel), and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The builds happen at first
use, keyed on a hash of each source and the flags, into
``cup3d_tpu_torch/csrc/build/`` (listed in ``.gitignore``); a finished
build is reused by later processes of the same checkout.

Nothing here runs at import: the CPU tests import every module of the
port, and there is no ``nvcc`` there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: source -> {C entry point -> argtypes} (every pointer and the stream as
#: c_void_p); None: a hot-path entry point taking ctypes arrays (passed by
#: pointer, no per-argument conversion), bound with the GIL held
#: (KernelLibrary.fast)
#: the fused-BiCGSTAB stages; each has an f32 entry point and a ``_bf16``
#: one of the same arguments (bf16 Krylov vectors)
_STAGES = {
    "cup3d_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "cup3d_getz_two": [_P, _P, _P, _P, _P, _F, _I, _P],
    "cup3d_getz_tile": [_P, _P, _P, _P, _F, _P, _I, _P],
    "cup3d_lap": [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P],
    "cup3d_axpy": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "cup3d_finish": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "cup3d_getz_amr": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    "cup3d_lap_amr": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
}
SOURCES = {
    CSRC / "fused_bicgstab.cu": {
        **_STAGES, **{name + "_bf16": a for name, a in _STAGES.items()}},
    CSRC / "getz_cg.cu": {
        "cup3d_getz_cg": [_P, _P, _F, _P, _I, _L, _L, _I, _P],
    },
    CSRC / "ring.cu": {
        "cup3d_ring_steps": None,
    },
    CSRC / "frenet.cu": {
        "cup3d_frenet": [_P, _P, _P, _P, _I, _I, _P],
    },
}


SOURCES_ARGTYPES = {name: a for entries in SOURCES.values()
                    for name, a in entries.items()}


def stream(device) -> int:
    """The current stream of a CUDA device (a ``torch.device`` or its
    index) as the raw handle every entry point takes: the direct lookup,
    a twentieth of ``torch.cuda.current_stream``'s host time
    (tools/kernel_ab.py's host split)."""
    idx = device if isinstance(device, int) else device.index
    if idx is None:
        idx = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(idx)


class KernelLibrary:
    """The loaded libraries' entry points plus what their build reported."""

    def __init__(self, paths: list, build_s: float, log: str):
        self.paths = paths      # one .so per source
        self.build_s = build_s  # wall seconds of the build, 0.0 if reused
        self.log = log          # nvcc / ptxas output of this build
        self._fns = {}
        for path, entries in zip(paths, SOURCES.values()):
            lib, plib = ctypes.CDLL(str(path)), ctypes.PyDLL(str(path))
            for name, argtypes in entries.items():
                fn = getattr(lib if argtypes is not None else plib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self._fns[name] = fn

    def fast(self, name: str):
        """A hot-path entry point itself (no argtypes; returns the CUDA
        error code).  It keeps the GIL (ctypes.PyDLL): the call is a
        launch, shorter than releasing and retaking the GIL."""
        if SOURCES_ARGTYPES[name] is not None:
            raise ValueError(f"{name} takes typed arguments: use call()")
        return self._fns[name]

    def call(self, name: str, *args) -> None:
        """Launch one entry point; raise if the launch was refused."""
        err = self._fns[name](*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda)")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> tuple[list, float, str]:
    """Compile every source without a build of its exact text, one nvcc
    per source, all started together.  Returns (library paths, build
    seconds, compiler log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [_target(src) for src in SOURCES]
    todo = [(src, out) for src, out in zip(SOURCES, outs)
            if not out.exists()]
    if not todo:
        return outs, 0.0, ""
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    return outs, time.perf_counter() - t0, log


def load() -> KernelLibrary:
    """The kernel libraries, built on first use (thread-safe)."""
    global _loaded
    with _lock:
        if _loaded is None:
            paths, secs, log = build()
            _loaded = KernelLibrary(paths, secs, log)
        return _loaded
