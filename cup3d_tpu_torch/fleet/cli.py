"""Headless fleet entry point: ``python -m cup3d_tpu_torch fleet
--scenarios spec.json`` (port of ``cup3d_tpu/fleet/cli.py``, the same
flags and output keys, plus ``--device``).

The spec file is a JSON list of scenario dicts or an object
``{"scenarios": [...], "lanes": N, "buckets": N}``; each scenario is a
fleet/server.py job spec (kind, nsteps, n, cfl, L/T/xpos, bpd/levelMax
for ``amr_tgv``, ...) plus an optional ``tenant``.  The process drains
the queue and prints the per-tenant summary JSON on stdout.

- ``fleet slo``: the SLO report instead (per-tenant p50/p95/p99 job
  latency from the bucketed histograms, breach counts against the target
  p99, burn rate over the 1% error budget); ``--slo-p99`` /
  ``--slo-window`` override ``CUP3D_FLEET_SLO_*``.
- ``fleet why [job-id]``: the latency-provenance report (per-phase
  p50/p99, per-tenant burn attribution), or one job's exact phase
  decomposition.
- ``--policy fifo|srb``, ``--queue-depth``, ``--tenant-quota``,
  ``--no-continuous`` (the generation drain), ``--mesh`` (the resolved
  fleet mesh state JSON on stderr before the drain).
- ``fleet recover --workdir DIR``: boot a server on a crashed server's
  workdir, replay its journal, drain, and print the recovery report
  (``recover_restart_s``, ``rows_blake2s`` over every job's QoI bytes).
- ``--device cpu`` runs the lanes on the CPU; the default is the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from typing import List, Optional

from cup3d_tpu_torch.fleet.server import FleetServer, summary_json
from cup3d_tpu_torch.obs import trace as OT


def _build_parser(mode: Optional[str]) -> argparse.ArgumentParser:
    slo = mode == "slo"
    why = mode == "why"
    prog = "python -m cup3d_tpu_torch fleet" + (f" {mode}" if mode else "")
    desc = ("drain a fleet scenario spec and print the "
            + ("latency-provenance report JSON (per-phase p50/p99, "
               "burn attribution; with a job id, that job's exact "
               "phase decomposition)" if why else
               "per-tenant SLO report JSON" if slo else
               "per-tenant summary JSON"))
    ap = argparse.ArgumentParser(prog=prog, description=desc)
    ap.add_argument("--scenarios", required=True,
                    help="JSON spec: a list of scenarios or "
                         '{"scenarios": [...], "lanes": N, "buckets": N}')
    ap.add_argument("--lanes", type=int, default=None,
                    help="max lanes per batch (CUP3D_FLEET_LANES)")
    ap.add_argument("--buckets", type=int, default=None,
                    help="executable cache cap (CUP3D_FLEET_BUCKETS)")
    ap.add_argument("--workdir", default=None,
                    help="serialization dir (default: fresh tempdir)")
    ap.add_argument("--policy", choices=("fifo", "srb"), default=None,
                    help="scheduler policy: fifo (default) or srb = "
                         "shortest-remaining-budget "
                         "(CUP3D_FLEET_POLICY)")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="admission backpressure threshold "
                         "(CUP3D_FLEET_QUEUE_DEPTH)")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="live jobs per tenant, 0 = unlimited "
                         "(CUP3D_FLEET_TENANT_QUOTA)")
    ap.add_argument("--no-continuous", action="store_true",
                    help="legacy generation-drain instead of "
                         "continuous batching "
                         "(CUP3D_FLEET_CONTINUOUS=0)")
    ap.add_argument("--mesh", action="store_true",
                    help="print the resolved 2-D device-mesh state "
                         "JSON on stderr before draining "
                         "(CUP3D_FLEET_MESH)")
    ap.add_argument("--device", default=None,
                    help="the lanes' device (default: the card; cpu to "
                         "run on the CPU)")
    if slo or why:
        ap.add_argument("--slo-p99", type=float, default=None,
                        help="target p99 end-to-end seconds "
                             "(CUP3D_FLEET_SLO_P99)")
        ap.add_argument("--slo-window", type=int, default=None,
                        help="rolling breach window in jobs "
                             "(CUP3D_FLEET_SLO_WINDOW)")
    if why:
        ap.add_argument("job_id", nargs="?", default=None,
                        help="report one job's exact phase "
                             "decomposition instead of the fleet view")
    return ap


def _why_report(server: FleetServer, job_id: Optional[str]) -> dict:
    """The ``fleet why`` payload: fleet-wide (or one job's) latency
    provenance.  Per tenant: the per-phase p50/p99 breakdown and the
    burn attribution (dominant phase of the current window + which
    phase's e2e share grew vs the rolling baseline)."""
    if job_id is not None:
        job = server._jobs[job_id]
        return {
            "job_id": job.job_id,
            "tenant": job.tenant,
            "status": job.status,
            "phases": {k: round(v, 6)
                       for k, v in job.phases().items()},
            "durations": {k: round(v, 6)
                          for k, v in job.durations().items()},
            "events": [[n, round(t, 6)] for n, t in job.events],
        }
    tenants = {}
    for tenant in sorted(server._phase_share_history):
        tenants[tenant] = server.phase_attribution(tenant)
    return {
        "phase_quantiles": server.phase_quantiles(),
        "tenants": tenants,
        "jobs": server.jobs_by_status(),
    }


def cmd_recover(argv: List[str], t0: float) -> int:
    """``fleet recover``: journal replay -> drain -> probe report."""
    from cup3d_tpu_torch.analysis.runtime import RecompileCounter

    ap = argparse.ArgumentParser(
        prog="python -m cup3d_tpu_torch fleet recover",
        description="replay a crashed server's write-ahead journal, "
                    "drain every surviving job, and print the "
                    "recovery report JSON")
    ap.add_argument("--workdir", required=True,
                    help="the crashed server's workdir (holds the "
                         "journal/ directory)")
    ap.add_argument("--lanes", type=int, default=None,
                    help="max lanes per batch (CUP3D_FLEET_LANES)")
    ap.add_argument("--buckets", type=int, default=None,
                    help="executable cache cap (CUP3D_FLEET_BUCKETS)")
    ap.add_argument("--device", default=None,
                    help="the lanes' device (default: the card; cpu to "
                         "run on the CPU)")
    args = ap.parse_args(argv)

    with RecompileCounter(("fleet.executable_builds",)) as rc:
        server = FleetServer(max_lanes=args.lanes, max_buckets=args.buckets,
                             workdir=args.workdir, device=args.device)
        recovery = server.recover()
        summary = server.drain()
    dispatched = [t for t in (
        j.event_time("dispatched") for j in server._jobs.values())
        if t is not None]
    digest = hashlib.blake2s()
    for jid in sorted(server._jobs):
        digest.update(jid.encode())
        digest.update(server._jobs[jid].qoi_bytes())
    # eager PyTorch compiles nothing: the count is the lane-batched
    # advances this process bound, with the compiled store or without (a
    # bind builds nothing the store could hold)
    builds = rc.total_compiles
    report = {
        "recovery": recovery,
        "recover_restart_s": (min(dispatched) - t0 if dispatched
                              else None),
        "total_s": OT.now() - t0,
        "advance_compiles": builds,
        "total_compiles": builds,
        "rows_blake2s": digest.hexdigest(),
        "jobs": {jid: server._jobs[jid].status
                 for jid in sorted(server._jobs)},
        "durability": server.health()["durability"],
    }
    print(json.dumps(report, indent=2, sort_keys=True))
    bad = sum(st.get("failed", 0) for st in
              (t["statuses"] for t in summary.values()))
    return 1 if bad else 0


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    # the recovery clock starts at CLI entry: recover_restart_s
    # includes every import + journal replay + driver re-init between
    # exec and the restarted server's first dispatch
    t0 = OT.now()
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "recover":
        return cmd_recover(argv[1:], t0)
    mode = argv[0] if argv and argv[0] in ("slo", "why") else None
    if mode is not None:
        argv = argv[1:]
    slo = mode == "slo"
    why = mode == "why"
    args = _build_parser(mode).parse_args(argv)

    with open(args.scenarios) as f:
        spec = json.load(f)
    if isinstance(spec, dict):
        scenarios = spec.get("scenarios", [])
        lanes = args.lanes if args.lanes is not None else spec.get("lanes")
        buckets = (args.buckets if args.buckets is not None
                   else spec.get("buckets"))
    else:
        scenarios, lanes, buckets = spec, args.lanes, args.buckets
    if not scenarios:
        raise SystemExit("no scenarios in spec")

    server = FleetServer(max_lanes=lanes, max_buckets=buckets,
                         workdir=args.workdir,
                         slo_p99_s=getattr(args, "slo_p99", None),
                         slo_window=getattr(args, "slo_window", None),
                         continuous=(False if args.no_continuous
                                     else None),
                         policy=args.policy,
                         max_queue_depth=args.queue_depth,
                         tenant_quota=args.tenant_quota,
                         device=args.device)
    if args.mesh:
        from cup3d_tpu_torch.parallel import topology as topo

        # stderr so the stdout summary/SLO JSON stays machine-parseable;
        # on one card the batch is unsharded (CUP3D_FLEET_MESH=1 raises,
        # ROADMAP A8b)
        print(json.dumps(topo.mesh_state(None), sort_keys=True),
              file=sys.stderr)
    for i, sc in enumerate(scenarios):
        server.submit(sc.get("tenant", f"tenant-{i}"), sc)
    summary = server.drain()
    if slo:
        report = {"slo": server.slo_status(),
                  "quantiles": server.latency_quantiles(),
                  "jobs": server.jobs_by_status()}
        print(json.dumps(report, indent=2, sort_keys=True))
    elif why:
        print(json.dumps(_why_report(server, args.job_id),
                         indent=2, sort_keys=True))
    else:
        print(summary_json(summary))
    bad = sum(
        st.get("failed", 0) for st in
        (t["statuses"] for t in summary.values()))
    return 1 if bad else 0
