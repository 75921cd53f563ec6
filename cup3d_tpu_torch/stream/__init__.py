"""Async host data-plane of the port (``cup3d_tpu/stream/``'s).

- :mod:`cup3d_tpu_torch.stream.qoi` — streaming QoI reads: per-step packs
  are grouped on the device, copied into pinned host memory with
  ``non_blocking=True`` behind a CUDA event, and consumed strictly in
  order, with per-stream counters and per-config pack slimming.
- :mod:`cup3d_tpu_torch.stream.dump` — sharded multi-writer field dumps
  staged the same way and written on a writer thread.
- :mod:`cup3d_tpu_torch.stream.checkpoint` — async checkpoints: a device
  snapshot on the main thread, the pickle written on a background
  thread.
"""

from cup3d_tpu_torch.stream.qoi import PackPolicy, QoIStream
from cup3d_tpu_torch.stream.dump import AsyncDumper, dump_fields_sharded
from cup3d_tpu_torch.stream.checkpoint import AsyncCheckpointer

__all__ = ["QoIStream", "PackPolicy", "AsyncDumper", "dump_fields_sharded",
           "AsyncCheckpointer"]
