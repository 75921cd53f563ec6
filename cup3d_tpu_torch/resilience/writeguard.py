"""Atomic, retried host writes (port of
``cup3d_tpu/resilience/writeguard.py``).

A payload is written to ``<path>.tmp`` and promoted with ``os.replace``,
so a kill or an injected write failure at any instant leaves either the
previous complete file or none.  Transient failures are retried with
exponential backoff plus jitter; each retry is counted as
``resilience.write_retries{site=...}``.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable

from cup3d_tpu_torch.obs import metrics as _metrics


def backoff_sleep(attempt: int, base_delay: float = 0.05,
                  jitter: float = 0.5) -> None:
    """Exponential backoff before retry ``attempt`` (1-based), with a
    multiplicative jitter so concurrent writers decorrelate."""
    delay = base_delay * (2 ** (attempt - 1))
    time.sleep(delay * (1.0 + jitter * random.random()))


def atomic_write(path: str, write_fn: Callable[[str], None],
                 site: str = "write", retries: int = 2,
                 base_delay: float = 0.05) -> str:
    """Run ``write_fn(tmp_path)`` (which writes the COMPLETE file) then
    ``os.replace`` it over ``path``; on failure remove the tmp file and
    retry up to ``retries`` times.  Raises the last failure; returns
    ``path`` on success."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    last: Exception = RuntimeError("unreachable")
    for attempt in range(retries + 1):
        if attempt:
            _metrics.counter("resilience.write_retries", site=site).inc()
            backoff_sleep(attempt, base_delay)
        try:
            write_fn(tmp)
            os.replace(tmp, path)
            return path
        except Exception as e:
            last = e
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except OSError:
                _metrics.counter("resilience.tmp_unlink_failures").inc()
    raise last
