"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface; each is compiled
with its own ``nvcc`` for ``sm_90a`` into a shared library, all sources
at once (the compilers run in parallel), and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The builds happen at first
use, keyed on a hash of each source and the flags, into
``cup3d_tpu_torch/csrc/build/`` (listed in ``.gitignore``); a finished
build is reused by later processes of the same checkout.  With the
compiled store active (``CUP3D_AOT_STORE``, aot/store.py) a source with
no build here loads from its ``kernels`` record (keyed by the source's
sha256, the flags and ``nvcc --version``) and runs no nvcc; a miss or a
rejected record builds with nvcc from the repo's source and puts the
library there.  ``kernels.nvcc_builds`` and ``kernels.store_hits`` count
each source's way.

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

from cup3d_tpu_torch.obs import metrics as M

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
    """The loaded libraries' entry points plus what their build reported:
    ``origins`` (per source file name: "nvcc" built in this process,
    "build" an earlier build of this checkout reused, "store" unpacked
    from a ``kernels`` record of the compiled store) and ``build_s``."""

    def __init__(self, paths: list, build_s: float, log: str,
                 origins: dict | None = None):
        self.paths = paths      # one .so per source
        self.build_s = build_s  # wall seconds of the build, 0.0 if reused
        self.log = log          # nvcc / ptxas output of this build
        self.origins = dict(origins or {})
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


_NVCC_VERSION: list = []


def nvcc_version() -> str:
    """``nvcc --version``'s output (cached a process; "" without nvcc):
    part of a ``kernels`` record's key, so another compiler's library is
    never loaded."""
    if not _NVCC_VERSION:
        try:
            out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
        except (RuntimeError, OSError, subprocess.SubprocessError):
            out = ""
        _NVCC_VERSION.append(out.strip())
    return _NVCC_VERSION[0]


def kernel_sig(src: Path, version: str) -> tuple:
    """The compiled store's key of one source's library: its name, the
    sha256 of its text, the flags and the compiler's version."""
    return ("kernels", src.name, hashlib.sha256(src.read_bytes()).hexdigest(),
            NVCC_FLAGS, version)


def store_load(store, src: Path, version: str):
    """The library of ``src`` from a ``kernels`` record: its bytes
    written (atomically) to a file named by the record's digest under the
    store's own directory, whose path is returned; None on a miss (absent
    or rejected: the caller builds with nvcc).  A path is only ever
    written with the bytes of its digest, so a path that was loaded once
    is never overwritten with others (dlopen caches by path)."""
    from cup3d_tpu_torch.aot import store as aot_store
    from cup3d_tpu_torch.resilience import writeguard

    sig = kernel_sig(src, version)
    rec = store.get(sig, name=f"kernels.{src.stem}")
    if rec is None:
        return None
    data = rec.get("so") if isinstance(rec, dict) else None
    if not isinstance(data, bytes) or not data:
        store.reject(store.path_for(sig), "payload")
        return None
    path = store.lib_path(sig, src.stem)
    try:
        with open(path, "rb") as f:
            same = f.read() == data
    except OSError:
        same = False
    if not same:
        def write(tmp: str) -> None:
            with open(tmp, "wb") as f:
                f.write(data)

        writeguard.atomic_write(path, write, site="aot-store")
    M.counter("kernels.store_hits").inc()
    return Path(path)


def store_put(store, src: Path, version: str, lib: Path):
    """Put a built library's bytes into the store as ``src``'s record."""
    return store.put(kernel_sig(src, version),
                     {"so": lib.read_bytes(), "source": src.name,
                      "flags": NVCC_FLAGS, "nvcc": version},
                     name=f"kernels.{src.stem}")


def build() -> tuple[list, float, str, dict]:
    """Compile every source without a build of its exact text, one nvcc
    per source, all started together.  With the compiled store active
    (``CUP3D_AOT_STORE``) a source with no build here is first looked up
    in the store (a hit runs no nvcc), and every library this process
    built or reused is put there.  Returns (library paths, build seconds,
    compiler log, origin of each source's library)."""
    from cup3d_tpu_torch.aot import store as aot_store

    store = aot_store.active_store()
    version = nvcc_version() if store is not None else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [_target(src) for src in SOURCES]
    origins = {}
    todo = []
    for i, (src, out) in enumerate(zip(SOURCES, outs)):
        if out.exists():
            origins[src.name] = "build"
            continue
        hit = store_load(store, src, version) if store is not None else None
        if hit is not None:
            outs[i] = hit
            origins[src.name] = "store"
            continue
        todo.append((src, out))
    t0 = time.perf_counter()
    log = ""
    if todo:
        log = _nvcc_build(todo)
        for src, _ in todo:
            origins[src.name] = "nvcc"
            M.counter("kernels.nvcc_builds").inc()
    secs = time.perf_counter() - t0 if todo else 0.0
    if store is not None:
        for src, out in zip(SOURCES, outs):
            if (origins[src.name] != "store"
                    and not store.contains(kernel_sig(src, version))):
                store_put(store, src, version, out)
    return outs, secs, log, origins


def _nvcc_build(todo) -> str:
    """Run one nvcc a source, all at once; raise if any fails."""
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
    return log


def load() -> KernelLibrary:
    """The kernel libraries, built on first use (thread-safe)."""
    global _loaded
    with _lock:
        if _loaded is None:
            paths, secs, log, origins = build()
            _loaded = KernelLibrary(paths, secs, log, origins)
        return _loaded
