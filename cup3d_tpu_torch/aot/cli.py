"""Operator entry point: ``python -m cup3d_tpu_torch aot <cmd>`` (port of
``cup3d_tpu/aot/cli.py``).

Four store-management subcommands and one measurement probe, each
printing machine-parseable JSON on stdout, each taking ``-device
cpu|cuda`` (default the card) for the servers it builds:

``list``
    every entry of the store (name, signature, bytes, mtime) and the
    store's state.
``gc [--max-bytes N]``
    evict oldest-first down to the byte bound; print what was evicted.
``verify``
    deep-check every record (magic, checksum, schema, fingerprint, the
    payload rebuilds); defects are rejected as a serving load would
    reject them.  Exit 1 when anything was rejected.
``warm --scenarios spec.json``
    prepare the spec's jobs (the fleet's validation and bucketing: their
    drivers init, so the forest ``tables`` records are written) and, on
    the card, load the kernel libraries (the ``kernels`` records): no job
    runs.  A later ``fleet`` run on the same store builds no table and
    runs no nvcc.  Each group's entry names its records, whether they
    were stored before and after, and the bytes of its batched carry
    (from meta-tensor shapes: no device memory).
``probe --scenarios spec.json``
    drain the spec as the fleet CLI does and report the cold-start
    figures: seconds from process entry to the first dispatch, the
    advance binds (``advance_compiles``: the port binds every advance,
    store or not; a bind builds nothing), the nvcc and table builds, the
    ``aot.*`` counters, and a blake2s digest over every job's QoI rows
    (the cold and warm runs' bitwise check).

``--store PATH`` overrides ``CUP3D_AOT_STORE``; ``list``/``gc``/
``verify``/``warm`` need a store, ``probe`` uses one when configured (a
store-less probe measures the plain cold start).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import List, Optional

from cup3d_tpu_torch.obs import trace as OT


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cup3d_tpu_torch aot",
        description="manage the compiled store")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--store", default=None,
                       help="store directory (default: CUP3D_AOT_STORE)")
        p.add_argument("-device", "--device", default=None,
                       choices=("cpu", "cuda"),
                       help="the servers' device (default: the card)")
        return p

    common(sub.add_parser("list", help="print store entries + state"))
    gc = common(sub.add_parser(
        "gc", help="evict oldest-first down to the byte bound"))
    gc.add_argument("--max-bytes", type=int, default=None,
                    help="byte bound (default: CUP3D_AOT_MAX_BYTES)")
    common(sub.add_parser(
        "verify", help="deep-check every record; exit 1 on defects"))

    for name, hlp in (
            ("warm", "build a scenario spec's tables and kernels into "
                     "the store without running any job"),
            ("probe", "drain a scenario spec and print cold-start "
                      "telemetry JSON")):
        p = common(sub.add_parser(name, help=hlp))
        p.add_argument("--scenarios", required=True,
                       help="JSON spec: a list of scenarios or "
                            '{"scenarios": [...], "lanes": N, '
                            '"buckets": N}')
        p.add_argument("--lanes", type=int, default=None,
                       help="max lanes per batch (CUP3D_FLEET_LANES)")
        p.add_argument("--buckets", type=int, default=None,
                       help="advance cache cap (CUP3D_FLEET_BUCKETS)")
        p.add_argument("--workdir", default=None,
                       help="serialization dir (default: fresh tempdir)")
    return ap


def _resolve_store(args, required: bool):
    """Honour ``--store`` (exported, so every later ``active_store()``
    read, the fleet's seams included, sees it), then return the active
    store or None."""
    from cup3d_tpu_torch.aot import store as aot_store

    if args.store:
        os.environ["CUP3D_AOT_STORE"] = args.store
    st = aot_store.active_store()
    if st is None and required:
        raise SystemExit(
            "no store: pass --store or set CUP3D_AOT_STORE")
    return st


def _load_spec(args):
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
    return scenarios, lanes, buckets


def _make_server(args):
    from cup3d_tpu_torch.fleet.server import FleetServer

    scenarios, lanes, buckets = _load_spec(args)
    server = FleetServer(max_lanes=lanes, max_buckets=buckets,
                         workdir=args.workdir, device=args.device)
    for i, sc in enumerate(scenarios):
        server.submit(sc.get("tenant", f"tenant-{i}"), sc)
    return server


def cmd_list(args) -> int:
    st = _resolve_store(args, required=True)
    print(json.dumps({"state": st.state(), "entries": st.entries()},
                     indent=2, sort_keys=True))
    return 0


def cmd_gc(args) -> int:
    st = _resolve_store(args, required=True)
    before = st.state()
    result = st.gc(max_bytes=args.max_bytes)
    after = st.state()
    print(json.dumps({
        "gc": result,
        "reclaimed_bytes": before["bytes"] - after["bytes"],
        "state": after}, indent=2, sort_keys=True))
    return 0


def cmd_verify(args) -> int:
    st = _resolve_store(args, required=True)
    report = st.verify()
    print(json.dumps({"report": report, "state": st.state()},
                     indent=2, sort_keys=True))
    return 1 if report["rejected"] else 0


def _group_records(kind: str, s, device) -> list:
    """The store keys of what a group of ``kind`` on the driver ``s``
    reads before it can serve: its forest's ``tables`` record
    (``amr_tgv``) and, on the card, every source's ``kernels`` record."""
    keys = []
    if kind == "amr_tgv":
        from cup3d_tpu_torch.sim.amr import tables_key

        keys.append(tables_key(s._aot_content_sig(s.grid.signature)))
    if device.type == "cuda":
        from cup3d_tpu_torch.ops import cuda_lib

        version = cuda_lib.nvcc_version()
        keys += [cuda_lib.kernel_sig(src, version)
                 for src in cuda_lib.SOURCES]
    return keys


def cmd_warm(args) -> int:
    """Build without running: prepare every queued job (an ``amr_tgv``
    driver's init writes its ``tables`` record), group by bucket as
    assembly would, and on the card load the kernel libraries (their
    ``kernels`` records); repeat runs find everything stored
    (``already_stored``)."""
    from collections import OrderedDict

    import torch

    from cup3d_tpu_torch.fleet import batch as FB
    from cup3d_tpu_torch.fleet.server import QUEUED, _lane_payload
    from cup3d_tpu_torch.sim.megaloop import DEFAULT_SCAN_K
    from cup3d_tpu_torch.sim.simulation import resolve_scan_k

    st = _resolve_store(args, required=True)
    server = _make_server(args)
    buckets: "OrderedDict[tuple, list]" = OrderedDict()
    stored_before = set(os.listdir(st.root))
    for job in list(server._jobs.values()):
        if job.status != QUEUED:
            continue
        prep = server._prepare(job)
        if prep is None:
            continue
        kind, drv, sig, key = prep
        buckets.setdefault(key, []).append((kind, job, drv))
    warmed = []
    for members in buckets.values():
        kind, job, drv = members[0]
        s = drv.sim
        dev = torch.device(s.device)
        keys = _group_records(kind, s, dev)
        if dev.type == "cuda":
            from cup3d_tpu_torch.ops import cuda_lib

            cuda_lib.load()
        cap = server.lane_capacity(len(members))
        K = resolve_scan_k(drv.cfg)
        if K <= 1:
            K = DEFAULT_SCAN_K
        carry, gait = _lane_payload(kind, drv, job.job_id)
        avals = FB.abstract_advance_args(carry, gait, cap, K, s.dtype)
        carry_bytes = sum(t.numel() * t.element_size()
                          for t in avals[0].values())
        warmed.append({
            "kind": kind, "jobs": len(members), "lanes": cap, "K": K,
            "records": ["tables" if k[0] == "forest" else f"kernels.{k[1]}"
                        for k in keys],
            "already_stored": all(os.path.basename(st.path_for(k))
                                  in stored_before for k in keys),
            "warmed": all(st.contains(k) for k in keys),
            "carry_bytes": int(carry_bytes)})
    print(json.dumps({"warmed": warmed, "state": st.state()},
                     indent=2, sort_keys=True))
    return 0 if all(e["warmed"] for e in warmed) else 1


def cmd_probe(args, t0: float) -> int:
    from cup3d_tpu_torch.obs import metrics as M

    _resolve_store(args, required=False)
    snap0 = M.snapshot()
    server = _make_server(args)
    summary = server.drain()
    dispatched = [t for t in (
        j.event_time("dispatched") for j in server._jobs.values())
        if t is not None]
    digest = hashlib.blake2s()
    for jid in sorted(server._jobs):
        digest.update(jid.encode())
        digest.update(server._jobs[jid].qoi_bytes())
    snap = M.snapshot()

    def delta(key):
        return int(snap.get(key, 0) - snap0.get(key, 0))

    counters = {k: v for k, v in sorted(snap.items())
                if k.startswith("aot.")}
    advance_compiles = delta("fleet.executable_builds")
    nvcc_builds = delta("kernels.nvcc_builds")
    table_builds = (delta("bucket.table_builds")
                    + delta("forest.table_builds"))
    # the drain's aggregate per-phase seconds (each job's decomposition
    # sums to its e2e) and the compile_wait fraction
    phase_totals: dict = {}
    for j in server._jobs.values():
        for ph, v in j.phases().items():
            phase_totals[ph] = phase_totals.get(ph, 0.0) + v
    phase_sum = sum(phase_totals.values())
    report = {
        "first_dispatch_s": (min(dispatched) - t0 if dispatched
                             else None),
        "total_s": OT.now() - t0,
        "advance_compiles": advance_compiles,
        "total_compiles": advance_compiles + nvcc_builds + table_builds,
        "nvcc_builds": nvcc_builds,
        "table_builds": table_builds,
        "aot_counters": counters,
        "rows_blake2s": digest.hexdigest(),
        "jobs": {jid: server._jobs[jid].status
                 for jid in sorted(server._jobs)},
        "phase_totals_s": {ph: round(v, 6)
                           for ph, v in sorted(phase_totals.items())},
        "compile_wait_frac": round(
            phase_totals.get("compile_wait", 0.0) / phase_sum, 6)
            if phase_sum > 0 else 0.0,
    }
    print(json.dumps(report, indent=2, sort_keys=True))
    bad = sum(st.get("failed", 0) for st in
              (t["statuses"] for t in summary.values()))
    return 1 if bad else 0


def main(argv: Optional[List[str]] = None) -> int:
    # the probe's clock starts at CLI entry: the cold start includes every
    # import, driver init and build between exec and the first dispatch
    t0 = OT.now()
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_parser().parse_args(argv)
    if args.cmd == "list":
        return cmd_list(args)
    if args.cmd == "gc":
        return cmd_gc(args)
    if args.cmd == "verify":
        return cmd_verify(args)
    if args.cmd == "warm":
        return cmd_warm(args)
    return cmd_probe(args, t0)


if __name__ == "__main__":
    raise SystemExit(main())
