"""On-disk, content-addressed store of the port's compiled artifacts
(port of ``cup3d_tpu/aot/store.py``).

The JAX package persists XLA executables, so a restarted server traces
and compiles nothing for a signature it has seen before.  The port's
eager advance compiles nothing; before a fresh process can serve it
pays for the same two things in another form, and this store keeps
them:

- ``kernels`` records: the nvcc-built shared library of one
  ``csrc/*.cu`` source (ops/cuda_lib.py), keyed by the source's sha256,
  the flags and ``nvcc --version``;
- ``tables`` records: the host-built padded tables of one forest
  topology (sim/amr.py, parallel/forest.py), keyed by the octree
  signature and every config knob the build reads.

The fleet's lane-batched advance is not stored: binding it builds
nothing (it closes over the driver's tables and the loaded kernels), so
a warm process still binds it, and what it saves is the nvcc runs and
the table builds.

A record holds host data only (numpy arrays in nested dicts and tuples,
and bytes): no device tensor is pickled, and a load moves the arrays to
the caller's device (:func:`from_host`).  No CUDA graph is stored: a
graph does not outlive its process.

- **keying**: an entry's digest is ``blake2s(repr(sig) +
  fingerprint)``; the port's fingerprint carries ``framework="torch"``,
  the torch and CUDA versions, the platform, the device names, compute
  capabilities and count, and the driver version.  A record of another
  environment (the CPU's on the card, the JAX package's in the port and
  the reverse) is a different key, and a hand-copied one is rejected
  with reason ``fingerprint``.
- **format**: the JAX package's: the ``MAGIC`` line, a blake2s checksum
  line, then a pickled record ``{schema, fingerprint, sig, name,
  payload}``.  Loads verify magic, checksum, schema, fingerprint AND the
  full ``repr(sig)``; any defect is counted in
  ``aot.store_rejects{reason=...}``, the file is removed, and the caller
  builds live: never a wrong load.
- **writes** go through ``resilience/writeguard.atomic_write``.
- **GC**: mtime-LRU under ``CUP3D_AOT_MAX_BYTES`` (default 2 GiB); a hit
  ``os.utime``s its file.  Library files unpacked from ``kernels``
  records live in ``<root>/lib/`` and are removed with their record.

Everything is opt-in behind ``CUP3D_AOT_STORE``: with it unset
:func:`active_store` is None and every seam returns what it returned
before.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import importlib
import os
import pickle
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.resilience import faults, writeguard

#: bump on any change to the record layout (the JAX package's schema: a
#: record of either package reads as far as its fingerprint)
SCHEMA = 1

MAGIC = b"CUP3DAOT1\n"

SUFFIX = ".aotx"

#: the directory under the store root that holds unpacked libraries
LIB_DIR = "lib"

#: default GC bound (bytes) when CUP3D_AOT_MAX_BYTES is unset
DEFAULT_MAX_BYTES = 2 << 30


class StoreReject(Exception):
    """One unloadable store entry; ``reason`` feeds the reject counter."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


# -- environment fingerprint -------------------------------------------------

_FP_CACHE: Dict[int, dict] = {}
_FP_LOCK = threading.Lock()


def _driver_version() -> int:
    """The CUDA driver's version (``cuDriverGetVersion``), 0 without one."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int(0)
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            return int(v.value)
    # torch-lint: allow(JX009, no libcuda (a CPU host): the driver version 0 is
    # the key's answer)
    except OSError:
        pass
    return 0


def fingerprint() -> dict:
    """Everything that makes a stored artifact valid to reload here:
    the framework, the torch and CUDA versions, the platform, the
    devices (names, compute capabilities, count) and the driver.  The
    dict enters the store key and every record.  Cached a process; the
    first call initialises CUDA when there is a card, so callers make it
    on the dispatch thread (the compile service's worker makes no CUDA
    call).  Never raises."""
    with _FP_LOCK:
        cached = _FP_CACHE.get(0)
        if cached is not None:
            return dict(cached)
        fp = {"schema": SCHEMA, "framework": "torch",
              "torch": str(torch.__version__),
              "cuda": str(torch.version.cuda or "")}
        try:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            fp.update(
                platform="cuda" if n else "cpu",
                device_names=[torch.cuda.get_device_name(i)
                              for i in range(n)],
                capability=[list(torch.cuda.get_device_capability(i))
                            for i in range(n)],
                device_count=int(n),
                driver=_driver_version() if n else 0)
        except Exception:
            M.counter("aot.fingerprint_unavailable").inc()
            fp.update(platform="none", device_names=[], capability=[],
                      device_count=0, driver=0)
        _FP_CACHE[0] = fp
        return dict(fp)


def fingerprint_digest(fp: Optional[dict] = None) -> str:
    fp = fingerprint() if fp is None else fp
    blob = repr(sorted(fp.items())).encode()
    return hashlib.blake2s(blob).hexdigest()


def sig_digest(sig, fp: Optional[dict] = None) -> str:
    """Content address of one (signature, environment) pair."""
    blob = repr(sig).encode() + b"\0" + fingerprint_digest(fp).encode()
    return hashlib.blake2s(blob).hexdigest()


def sig_label(sig, n: int = 8) -> str:
    """Short deterministic label for metrics and log lines (``hash()`` is
    salted a process; this one survives restarts)."""
    return hashlib.blake2s(repr(sig).encode()).hexdigest()[:n]


# -- host payloads: the codec of the table structures ------------------------

_TENSOR = "__tensor__"
_OBJECT = "__object__"
_REF = "__ref__"
_PACKAGE = "cup3d_tpu_torch."


def _class_path(cls) -> str:
    path = f"{cls.__module__}:{cls.__qualname__}"
    if not path.startswith(_PACKAGE):
        raise TypeError(f"to_host: {path} is not a class of the port")
    return path


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(type(obj), "_fields")


def to_host(obj, refs: Optional[Dict[int, str]] = None):
    """A device structure (tensors inside the port's dataclasses, named
    tuples and plain classes, tuples, lists, dicts) as host data: each
    tensor becomes its numpy array (dtype and bits kept), each object a
    dict naming its class.  A plain class's private dict attributes are
    caches and are left out (rebuilt empty).  ``refs`` maps ``id()`` of
    shared objects (a forest the tables point back to) to names that
    :func:`from_host` resolves."""
    if refs and id(obj) in refs:
        return {_REF: refs[id(obj)]}
    if isinstance(obj, torch.Tensor):
        return {_TENSOR: obj.detach().cpu().numpy().copy()}
    if obj is None or isinstance(obj, (bool, int, float, str, bytes,
                                       np.ndarray, np.generic)):
        return obj
    if _is_namedtuple(obj):
        return {_OBJECT: _class_path(type(obj)),
                "items": [to_host(v, refs) for v in obj]}
    if isinstance(obj, tuple):
        return tuple(to_host(v, refs) for v in obj)
    if isinstance(obj, list):
        return [to_host(v, refs) for v in obj]
    if isinstance(obj, dict):
        return {"__dict__": [(k, to_host(v, refs)) for k, v in obj.items()]}
    if hasattr(obj, "__dict__"):
        plain = not dataclasses.is_dataclass(obj)
        caches = [k for k, v in vars(obj).items()
                  if plain and k.startswith("_") and isinstance(v, dict)]
        return {_OBJECT: _class_path(type(obj)), "caches": caches,
                "state": [(k, to_host(v, refs))
                          for k, v in vars(obj).items() if k not in caches]}
    raise TypeError(f"to_host: cannot store a {type(obj).__name__}")


def _resolve(path: str):
    if not path.startswith(_PACKAGE):
        raise StoreReject("payload", f"class {path} is not the port's")
    mod, qual = path.split(":", 1)
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def from_host(payload, device=None, refs: Optional[Dict[str, object]] = None):
    """Rebuild :func:`to_host`'s structure with every array a tensor on
    ``device`` (default the CPU), bitwise and of its stored dtype."""
    if isinstance(payload, dict):
        if _TENSOR in payload:
            arr = payload[_TENSOR]
            if not arr.flags.c_contiguous:
                arr = np.array(arr, order="C")  # keeps a 0-d array 0-d
            t = torch.from_numpy(arr)
            return t if device is None else t.to(device)
        if _REF in payload:
            return (refs or {})[payload[_REF]]
        if _OBJECT in payload:
            cls = _resolve(payload[_OBJECT])
            if "items" in payload:
                return cls(*[from_host(v, device, refs)
                             for v in payload["items"]])
            obj = cls.__new__(cls)
            for k in payload["caches"]:
                obj.__dict__[k] = {}
            for k, v in payload["state"]:
                obj.__dict__[k] = from_host(v, device, refs)
            return obj
        if "__dict__" in payload and len(payload) == 1:
            return {k: from_host(v, device, refs)
                    for k, v in payload["__dict__"]}
        # a plain host record (a library's bytes)
        return {k: from_host(v, device, refs) for k, v in payload.items()}
    if isinstance(payload, tuple):
        return tuple(from_host(v, device, refs) for v in payload)
    if isinstance(payload, list):
        return [from_host(v, device, refs) for v in payload]
    return payload


def tensors_equal(a, b) -> bool:
    """Whether two structures hold equal tensors leaf by leaf (same dtype,
    shape and bits: ``torch.equal`` on the same device) and equal other
    leaves."""
    ha, hb = to_host(a), to_host(b)
    return _host_equal(ha, hb)


def _host_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_host_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_host_equal(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


# -- the store ---------------------------------------------------------------


class ExecutableStore:
    """One directory of ``<digest>.aotx`` entries (module doc)."""

    def __init__(self, root: str, max_bytes: Optional[int] = None):
        self.root = str(root)
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get(
                    "CUP3D_AOT_MAX_BYTES", DEFAULT_MAX_BYTES))
            except ValueError:
                max_bytes = DEFAULT_MAX_BYTES
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        os.makedirs(self.root, exist_ok=True)

    def path_for(self, sig, fp: Optional[dict] = None) -> str:
        """The entry file of ``sig`` in the environment ``fp`` (default
        this process's fingerprint)."""
        return os.path.join(self.root, sig_digest(sig, fp) + SUFFIX)

    def contains(self, sig) -> bool:
        """Cheap presence probe (no load, no verification: a present
        entry may still reject at :meth:`get` time)."""
        return os.path.exists(self.path_for(sig))

    # -- load ----------------------------------------------------------------

    def _read_record(self, path: str) -> dict:
        """Read and verify one entry file; raises :class:`StoreReject` on
        any defect before the payload is used."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise StoreReject("io", str(e))
        if not blob.startswith(MAGIC):
            raise StoreReject("magic", path)
        body = blob[len(MAGIC):]
        nl = body.find(b"\n")
        if nl < 0:
            raise StoreReject("truncated", path)
        checksum, inner = body[:nl], body[nl + 1:]
        digest = hashlib.blake2s(inner).hexdigest().encode()
        if checksum != digest:
            raise StoreReject("checksum", path)
        try:
            rec = pickle.loads(inner)
        except Exception as e:
            raise StoreReject("unpickle", f"{path}: {e}")
        if not isinstance(rec, dict) or rec.get("schema") != SCHEMA:
            raise StoreReject("schema", path)
        return rec

    def reject(self, path: str, reason: str) -> None:
        """Count a defective entry by reason and remove it (and the
        library unpacked from it)."""
        M.counter("aot.store_rejects", reason=reason).inc()
        self._remove(path)

    def _remove(self, path: str) -> None:
        digest = os.path.basename(path)[:-len(SUFFIX)]
        for p in [path] + self._libs_of(digest):
            try:
                os.remove(p)
            # torch-lint: allow(JX009, an entry another process removed
            # first has left the store all the same)
            except OSError:
                pass

    def _libs_of(self, digest: str) -> List[str]:
        d = os.path.join(self.root, LIB_DIR)
        try:
            return [os.path.join(d, n) for n in os.listdir(d)
                    if n.startswith(digest)]
        except OSError:
            return []

    def get(self, sig, name: str = "exec", device=None):
        """The payload stored under ``sig``, or None (a miss: absent, or
        present but rejected).  With ``device`` the payload comes back
        through :func:`from_host` onto it.  Hits refresh the entry's LRU
        clock."""
        path = self.path_for(sig)
        if not os.path.exists(path):
            M.counter("aot.store_misses").inc()
            return None
        if faults.fire("aot.store_corrupt"):
            # chaos: garble bytes mid-record so this load takes the real
            # checksum-reject -> live-build path
            try:
                with open(path, "r+b") as f:
                    f.seek(max(len(MAGIC), os.path.getsize(path) // 2))
                    f.write(b"\xde\xad\xbe\xef")
            except OSError:
                M.counter("aot.store_corrupt_misfires").inc()
        try:
            rec = self._read_record(path)
            # the digest already encodes sig + fingerprint; re-checking
            # the record guards digest collisions and hand-copied files
            if rec.get("fingerprint") != fingerprint():
                raise StoreReject("fingerprint", path)
            if rec.get("sig") != repr(sig):
                raise StoreReject("sig-collision", path)
            payload = rec.get("payload")
            if device is not None:
                payload = from_host(payload, device)
        except StoreReject as e:
            self.reject(path, e.reason)
            M.counter("aot.store_misses").inc()
            return None
        except Exception:
            self.reject(path, "payload")
            M.counter("aot.store_misses").inc()
            return None
        try:
            os.utime(path)
        # torch-lint: allow(JX009, the LRU clock is best-effort: a failed
        # utime only ages the entry toward eviction)
        except OSError:
            pass
        M.counter("aot.store_hits").inc()
        return payload

    def lib_path(self, sig, name: str) -> str:
        """Where the library of a ``kernels`` record is unpacked: a file
        named by the record's digest (dlopen caches by path, so a path
        that was loaded once is never overwritten with other bytes)."""
        return os.path.join(self.root, LIB_DIR,
                            f"{sig_digest(sig)}-{name}.so")

    # -- write ---------------------------------------------------------------

    def put(self, sig, payload, name: str = "exec",
            fp: Optional[dict] = None) -> Optional[str]:
        """Write ``payload`` (host data) under ``sig``'s digest (atomic;
        GC'd to the size bound after).  ``fp``: the fingerprint of the
        environment the record is for, when the writer is not the process
        that loads it (the compile service's helper process writes for
        its parent and initialises no CUDA to take its own); default this
        process's.  Returns the path, or None when the payload does not
        pickle or the disk does not cooperate, both counted, never
        raised."""
        fp = fingerprint() if fp is None else dict(fp)
        rec = {"schema": SCHEMA, "fingerprint": fp,
               "sig": repr(sig), "name": str(name), "payload": payload}
        try:
            inner = pickle.dumps(rec, protocol=4)
        except Exception:
            M.counter("aot.store_write_failures", reason="pickle").inc()
            return None
        blob = MAGIC + hashlib.blake2s(inner).hexdigest().encode() \
            + b"\n" + inner
        path = self.path_for(sig, fp)

        def write(tmp: str) -> None:
            with open(tmp, "wb") as f:
                f.write(blob)

        try:
            with self._lock:
                writeguard.atomic_write(path, write, site="aot-store")
        except Exception:
            M.counter("aot.store_write_failures", reason="io").inc()
            return None
        M.counter("aot.store_writes").inc()
        self.gc()
        return path

    # -- inventory / GC ------------------------------------------------------

    def _files(self) -> List[Tuple[str, int, float]]:
        """[(path, bytes, mtime)] of every entry, oldest first."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for fname in names:
            if not fname.endswith(SUFFIX):
                continue
            path = os.path.join(self.root, fname)
            try:
                st = os.stat(path)
            # torch-lint: allow(JX009, an entry unlinked between listdir and
            # stat has left the store)
            except OSError:
                continue
            out.append((path, int(st.st_size), float(st.st_mtime)))
        out.sort(key=lambda e: e[2])
        return out

    def total_bytes(self) -> int:
        return sum(size for _, size, _ in self._files())

    def gc(self, max_bytes: Optional[int] = None) -> dict:
        """Evict oldest-touched entries until the store fits the byte
        bound.  Returns {evicted, bytes, files}."""
        bound = self.max_bytes if max_bytes is None else int(max_bytes)
        evicted = 0
        with self._lock:
            files = self._files()
            total = sum(size for _, size, _ in files)
            for path, size, _ in files:
                if total <= bound:
                    break
                if not os.path.exists(path):
                    continue
                self._remove(path)
                total -= size
                evicted += 1
                M.counter("aot.store_gc_evictions").inc()
        M.gauge("aot.store_bytes").set(float(total))
        return {"evicted": evicted, "bytes": total,
                "files": len(files) - evicted}

    def entries(self) -> List[dict]:
        """Metadata of every entry (the record header, not the payload):
        [{digest, name, sig, bytes, mtime}] or {..., defect}."""
        out = []
        for path, size, mtime in self._files():
            digest = os.path.basename(path)[:-len(SUFFIX)]
            try:
                rec = self._read_record(path)
            except StoreReject as e:
                out.append({"digest": digest, "bytes": size,
                            "mtime": mtime, "defect": e.reason})
                continue
            out.append({"digest": digest, "name": rec.get("name"),
                        "sig": rec.get("sig"), "bytes": size,
                        "mtime": mtime})
        return out

    def verify(self) -> dict:
        """Deep check: every entry must read, checksum, carry this
        environment's fingerprint and rebuild its payload on the CPU.
        Defective entries are rejected (counted and removed) as a failed
        :meth:`get` would.  Returns {ok, rejected, reasons}."""
        ok, rejected, reasons = 0, 0, {}
        for path, _, _ in self._files():
            try:
                rec = self._read_record(path)
                if rec.get("fingerprint") != fingerprint():
                    raise StoreReject("fingerprint", path)
                try:
                    from_host(rec.get("payload"))
                except StoreReject:
                    raise
                except Exception:
                    raise StoreReject("payload", path)
                ok += 1
            except StoreReject as e:
                self.reject(path, e.reason)
                rejected += 1
                reasons[e.reason] = reasons.get(e.reason, 0) + 1
        return {"ok": ok, "rejected": rejected, "reasons": reasons}

    def state(self) -> dict:
        """The /health payload: root, bound, inventory size."""
        files = self._files()
        return {
            "root": self.root,
            "max_bytes": self.max_bytes,
            "files": len(files),
            "bytes": sum(size for _, size, _ in files),
        }


# -- the active store (CUP3D_AOT_STORE) --------------------------------------

_STORES: Dict[str, ExecutableStore] = {}
_STORES_LOCK = threading.Lock()


def active_store() -> Optional[ExecutableStore]:
    """The process's persistent store, or None when ``CUP3D_AOT_STORE``
    is unset or empty (the default: every seam stays as before)."""
    root = os.environ.get("CUP3D_AOT_STORE", "")
    if not root:
        return None
    with _STORES_LOCK:
        st = _STORES.get(root)
        if st is None:
            st = _STORES[root] = ExecutableStore(root)
        return st
