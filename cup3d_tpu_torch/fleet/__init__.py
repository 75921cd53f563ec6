"""cup3d_tpu_torch.fleet: lane-batched many-simulation serving on one
card (port of ``cup3d_tpu/fleet/``).

- :mod:`fleet.batch`: the lane axis through the step bodies, one
  dispatch advancing L lanes K steps.
- :mod:`fleet.server`: job queue, capacity-bucketed batch assembly, the
  continuous-batching serve loop, per-tenant QoI fan-out.
- :mod:`fleet.isolate`: per-lane fault isolation (lane-scoped rollback
  with dt-halving; healthy lanes bitwise untouched).
- :mod:`fleet.journal`, :mod:`fleet.migrate`: durability, crash recovery
  and live migration; :mod:`fleet.cli` the ``fleet`` command.
"""

from cup3d_tpu_torch.fleet.batch import (  # noqa: F401
    build_fleet_advance,
    fleet_mesh,
    reseed_lane_carry,
    reseed_lane_gaits,
    stack_carries,
    stack_gaits,
)
from cup3d_tpu_torch.fleet.server import (  # noqa: F401
    CANCELLED,
    DONE,
    FAILED,
    QUEUED,
    RUNNING,
    FleetAdmissionError,
    FleetJob,
    FleetServer,
    live_servers,
)
