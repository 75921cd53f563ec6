"""Buffered per-file logging and the section profiler.

Copies of ``cup3d_tpu/io/logging.py``'s ``BufferedLogger`` (the
reference's named append-only text streams, main.cpp:7232-7245,
10300-10345) and of the self-time span accumulator its ``Profiler``
wraps (``cup3d_tpu/obs/trace.py::SpanTimer``) without the trace sink,
which belongs to the observability layer not yet ported (ROADMAP A9).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List


class BufferedLogger:
    def __init__(self, directory: str = ".", flush_every: int = 100):
        self.directory = directory
        self.flush_every = flush_every
        self._buffers: Dict[str, List[str]] = defaultdict(list)
        self._counts: Dict[str, int] = defaultdict(int)

    def write(self, filename: str, text: str) -> None:
        self._buffers[filename].append(text)
        self._counts[filename] += 1
        if self._counts[filename] % self.flush_every == 0:
            self.flush(filename)

    def flush(self, filename: str | None = None) -> None:
        names = [filename] if filename else list(self._buffers)
        os.makedirs(self.directory, exist_ok=True)
        for name in names:
            buf = self._buffers.get(name)
            if not buf:
                continue
            with open(os.path.join(self.directory, name), "a") as f:
                f.write("".join(buf))
            buf.clear()


class Profiler:
    """Host wall time per named section, as SELF time: an inner section's
    wall is excluded from the enclosing one, so section totals partition
    the measured wall.  A section re-entering itself counts one call.
    On CUDA the sections time the host's enqueue, not the device, unless
    the section ends in a synchronising read."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack: List[float] = []
        self._active: Dict[str, int] = defaultdict(int)

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        self._stack.append(0.0)
        self._active[name] += 1
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            child = self._stack.pop()
            self.totals[name] += elapsed - child
            self._active[name] -= 1
            if self._active[name] == 0:
                self.counts[name] += 1
            if self._stack:
                self._stack[-1] += elapsed

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'section':<28}{'calls':>8}{'total_s':>12}{'share':>8}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<28}{self.counts[name]:>8}{t:>12.4f}{t / total:>8.1%}"
            )
        return "\n".join(lines)
