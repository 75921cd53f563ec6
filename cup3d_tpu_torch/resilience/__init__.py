"""Self-healing step loop (port of ``cup3d_tpu/resilience``): fault
injection at named seams (``faults``), atomic retried writes
(``writeguard``) and the rollback/retry RecoveryEngine both drivers run
their ``simulate()`` loop through (``recovery``).

Env knobs, as in the JAX package:

- ``CUP3D_RECOVER``     1 (default) installs recovery in ``simulate()``;
                        0 keeps the crash-on-fault loop.
- ``CUP3D_FAULT``       ``site@step[:count]`` (``;``-separated) arms
                        deterministic fault injection.
- ``CUP3D_SNAP_EVERY``  rolling in-memory snapshot cadence (steps, 16).
- ``CUP3D_MAX_RETRIES`` rollback attempts before the give-up (4).
- ``CUP3D_DT_FLOOR``    lower bound of the retry dt halving (1e-9).
"""
