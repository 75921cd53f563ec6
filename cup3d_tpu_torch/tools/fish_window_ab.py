"""A/B timing of the fish's two window operations on the non-pipelined
path, between checkouts of the port, on one CUDA card.

    python cup3d_tpu_torch/tools/fish_window_ab.py [TREE ...]

Each TREE is the root of a checkout of the repository (default: this
one).  The trees run in the order given, each in a process of its own
(every checkout's package has the same name), so ``A B B A`` gives each
two samples, in turns, on one card and one host.  Each process builds
BASELINE config #2 at 128^3 (one StefanFish, iterative Poisson,
non-pipelined, ``CUP3D_FUSED=1``), takes STEPS steps, and times:

- ``rasterize``: ``StefanFish.rasterize`` (the window snap, the midline
  rasterization and the placement of the window into the dense sdf and
  udef), as CreateObstacles calls it;
- ``probe``: ``ops.surface.force_integrals_probe_uniform`` (the window
  gather and the surface-force integrals), as ComputeForces calls it.

For each: the host wall a call with the card synchronised after every
call (median of SAMPLES calls), and the CUDA-event time a call (median
of SAMPLES samples of PER_SAMPLE calls).  One JSON line a tree; the
card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

STEPS = 3
SAMPLES, PER_SAMPLE = 21, 10
N = 128
ARGV = (f"-bpdx {N // 8} -bpdy {N // 8} -bpdz {N // 8} -levelMax 1 "
        "-levelStart 0 -extent 1 -CFL 0.4 -nu 1e-3 -rampup 100 "
        "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
        f"-tend 0 -nsteps {STEPS} -verbose 0 -freqDiagnostics 0")
FISH = ("StefanFish L=0.4 T=1.0 xpos=0.5 ypos=0.5 zpos=0.5 bFixFrameOfRef=1 "
        "heightProfile=danio widthProfile=stefan")


def _times(torch, fn) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall = []
    for _ in range(SAMPLES):
        # torch-lint: allow(JX008, an A/B timing harness run by hand over
        # checkouts, no driver metric) torch-lint: allow(JX020, the
        # harness's own interval clock; it imports the checkout under
        # test, not this tree's obs layer)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    ev = []
    for _ in range(SAMPLES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(PER_SAMPLE):
            fn()
        e1.record()
        e1.synchronize()
        ev.append(e0.elapsed_time(e1) / PER_SAMPLE)
    return {"wall_ms": statistics.median(wall),
            "event_ms": statistics.median(ev)}


def child(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    os.environ["CUP3D_FUSED"] = "1"
    import torch

    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.analysis.runtime import upload
    from cup3d_tpu_torch.ops.surface import force_integrals_probe_uniform

    out_dir = os.path.join(os.path.abspath(tree), "runs", "fish_window_ab")
    os.makedirs(out_dir, exist_ok=True)
    d = build_driver(ARGV.split() + ["-path4serialization", out_dir,
                                     "-factory-content", FISH])
    d.init()
    d.simulate()
    s = d.sim
    ob = s.obstacles[0]
    kin = upload([ob.centerOfMass, ob.transVel, ob.angVel], s.dtype,
                 s.device)

    def probe():
        return force_integrals_probe_uniform(
            s.grid, ob, s.state["vel"], s.state["p"], ob.chi, ob.sdf,
            ob.udef, s.nu, kin[0], kin[1], kin[2])

    return {"tree": tree, "step": s.step,
            "rasterize": _times(torch, lambda: ob.rasterize(s.time)),
            "probe": _times(torch, probe)}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("fish_window_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for tree in argv or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", tree], check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
