"""Build and load the port's hand-written CUDA kernels.

``csrc/fused_bicgstab.cu`` has a plain C interface; it is compiled with
``nvcc`` for ``sm_90a`` into one shared library and loaded with
``ctypes`` (no PyTorch headers, so the build takes seconds).  The build
happens at first use, keyed on a hash of the sources and flags, into
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "fused_bicgstab.cu",)
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "cup3d_update": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    "cup3d_getz_two": [_P, _P, _P, _P, _P, _F, _I, _P],
    "cup3d_lap": [_P, _P, _P, _P, _P, _P, _F, _I, _P],
    "cup3d_axpy": [_P, _P, _P, _P, _P, _P, _I, _P],
    "cup3d_finish": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "cup3d_getz_amr": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    "cup3d_lap_amr": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
}


class KernelLibrary:
    """The loaded ``.so`` plus what its build reported."""

    def __init__(self, path: Path, build_s: float, log: str):
        self.path = path
        self.build_s = build_s  # 0.0 when an existing build was reused
        self.log = log          # nvcc / ptxas output of this build
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Launch one entry point; raise if the launch was refused."""
        err = getattr(self._lib, name)(*args)
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


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the sources unless a build of this exact source exists.
    Returns (library path, build seconds, compiler log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libcup3d_kernels_{_digest()}.so"
    if out.exists():
        return out, 0.0, ""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    elapsed = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, elapsed, log


def load() -> KernelLibrary:
    """The kernel library, built on first use (thread-safe)."""
    global _loaded
    with _lock:
        if _loaded is None:
            path, secs, log = build()
            _loaded = KernelLibrary(path, secs, log)
        return _loaded
