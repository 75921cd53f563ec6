"""Async host data-plane of the port (the QoI part of ``cup3d_tpu/stream/``).

- :mod:`cup3d_tpu_torch.stream.qoi` — streaming QoI reads: per-step packs
  are grouped on the device, copied into pinned host memory with
  ``non_blocking=True`` behind a CUDA event, and consumed strictly in
  order, with per-stream counters and per-config pack slimming.

The sharded dumps and the async checkpointer wait for ROADMAP A4's
second part.
"""

from cup3d_tpu_torch.stream.qoi import PackPolicy, QoIStream

__all__ = ["QoIStream", "PackPolicy"]
