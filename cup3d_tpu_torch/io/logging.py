"""Buffered per-file logging and the section profiler.

Copies of ``cup3d_tpu/io/logging.py``'s ``BufferedLogger`` (the
reference's named append-only text streams, main.cpp:7232-7245,
10300-10345) and its ``Profiler``, the self-time span accumulator of
``obs/trace.py`` (``SpanTimer``) forwarding to the trace sink.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from cup3d_tpu_torch.obs.trace import SpanTimer


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


class Profiler(SpanTimer):
    """Host wall time per named section, as SELF time: an inner section's
    wall is excluded from the enclosing one, so section totals partition
    the measured wall.  A section re-entering itself counts one call.
    On CUDA the sections time the host's enqueue, not the device, unless
    the section ends in a synchronising read.  With tracing on
    (``CUP3D_TRACE=1``) each closed section is a span of the trace sink,
    and under ``CUP3D_TRACE_XLA=1`` a ``torch.profiler.record_function``
    range that a capture window attributes device time to
    (obs/profile.py); off, the cost is one attribute load and a test."""
