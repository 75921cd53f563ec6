"""A/B step times of the uniform driver's main paths between checkouts of
the port, on one CUDA card.

    python cup3d_tpu_torch/tools/step_ab.py [TREE ...]

Each TREE is the root of a checkout of the repository (default: this
one).  The trees run in the order given, each in a process of its own
(every checkout's package has the same name), so ``A B B A`` gives each
two samples, in turns, on one card and one host.  Each process builds,
through ``build_driver`` with ``CUP3D_FUSED=1``, no dumps:

- ``fish``: BASELINE config #2 at 128^3 (one StefanFish, iterative
  Poisson, non-pipelined), as chip_smoke.py phase 14 runs it;
- ``fish_pipe``: the same pipelined (``-pipelined 1``, per-step steps),
  as phase 16 runs it before its megaloops;
- ``tgv``: the 256^3 Taylor-Green vortex at dt 1e-3, as phase 5 runs it;

takes WARM steps, then times STEPS steps between two synchronisations
(ms/step of host wall).  One JSON line a tree; the card's ``nvidia-smi``
name and power limit first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

WARM, STEPS = 5, 20
FISH = (["-bpdx", "16", "-bpdy", "16", "-bpdz", "16", "-levelMax", "1",
         "-extent", "1", "-CFL", "0.4", "-nu", "1e-3", "-rampup", "100",
         "-poissonSolver", "iterative", "-poissonTol", "1e-6",
         "-poissonTolRel", "1e-4", "-tend", "0", "-nsteps", "1000000",
         "-verbose", "0", "-freqDiagnostics", "0", "-factory-content",
         "StefanFish L=0.4 T=1.0 xpos=0.5 ypos=0.5 zpos=0.5 "
         "bFixFrameOfRef=1 heightProfile=danio widthProfile=stefan"])
TGV = ("-bpdx 32 -bpdy 32 -bpdz 32 -levelMax 1 -extent 6.283185307179586 "
       "-initCond taylorGreen -poissonSolver iterative -poissonTol 1e-6 "
       "-poissonTolRel 1e-4 -nu 1e-3 -dt 1e-3 -tend 0 -nsteps 1000000 "
       "-verbose 0 -freqDiagnostics 0").split()


def _ms_per_step(torch, d) -> float:
    for _ in range(WARM):
        d.advance(d.calc_max_timestep())
    torch.cuda.synchronize()
    # torch-lint: allow(JX008, an A/B timing harness run by hand over
    # checkouts, no driver metric) torch-lint: allow(JX020, the
    # harness's own interval clock; it imports the checkout under
    # test, not this tree's obs layer)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        d.advance(d.calc_max_timestep())
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEPS * 1e3


def child(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    os.environ["CUP3D_FUSED"] = "1"
    import torch

    from cup3d_tpu_torch.__main__ import build_driver

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(os.path.abspath(tree), "runs", "step_ab")
    os.makedirs(out_dir, exist_ok=True)
    out = {"tree": tree}
    for name, argv in (("fish", FISH), ("fish_pipe", FISH + ["-pipelined",
                                                             "1"]),
                       ("tgv", TGV)):
        d = build_driver(argv + ["-path4serialization", out_dir])
        d.init()
        out[name] = _ms_per_step(torch, d)
        del d
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("step_ab: no CUDA device", file=sys.stderr)
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
