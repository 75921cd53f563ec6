"""CLI entry point: ``python -m cup3d_tpu_torch -bpdx ... [-device cpu]``
(port of ``cup3d_tpu/__main__.py``: ``levelMax == 1`` builds the
uniform-grid Simulation, ``levelMax > 1`` the AMRSimulation).

Same flag grammar as the JAX package (config.parse_args; ``-conf FILE``
pulls flags from a file at lower precedence).  One flag of the port's
own, ``-device cpu|cuda`` (default cuda), is spliced out before parsing,
so both packages parse the rest of the argv to equal configs.  The
parsed config is recorded to ``argumentparser.log``.  ``-pipelined 1``
streams the step packs (sim/simulation.py), ``-scan_k K`` with it runs
K-step megaloops (sim/megaloop.py), as in the JAX CLI.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional, Tuple

from cup3d_tpu_torch.config import parse_args, parse_config_file


def _expand_conf(argv: List[str]) -> List[str]:
    """Splice ``-conf FILE`` flags out, appending the file's tokens after
    the command line (CLI tokens keep precedence: first occurrence wins)."""
    out: List[str] = []
    tail: List[str] = []
    i = 0
    while i < len(argv):
        if argv[i] == "-conf":
            if i + 1 >= len(argv):
                raise ValueError("-conf needs a file path")
            with open(argv[i + 1]) as f:
                tail.extend(parse_config_file(f.read()))
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return out + tail


def _split_device(argv: List[str]) -> Tuple[List[str], Optional[str]]:
    """Splice ``-device cpu|cuda`` out of argv (None = not given)."""
    out: List[str] = []
    device = None
    i = 0
    while i < len(argv):
        if argv[i] == "-device":
            if i + 1 >= len(argv) or argv[i + 1] not in ("cpu", "cuda"):
                raise ValueError("-device needs cpu or cuda")
            device = argv[i + 1]
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return out, device


def build_driver(argv: List[str]):
    args, device = _split_device(argv)
    cfg = parse_args(_expand_conf(args))
    if cfg.levelMax > 1:
        from cup3d_tpu_torch.sim.amr import AMRSimulation

        return AMRSimulation(cfg, device=device)
    from cup3d_tpu_torch.sim.simulation import Simulation

    return Simulation(cfg, device=device)


def _log_config(driver) -> None:
    cfg = driver.cfg
    os.makedirs(cfg.path4serialization or ".", exist_ok=True)
    path = os.path.join(cfg.path4serialization, "argumentparser.log")
    with open(path, "w") as f:
        for field in dataclasses.fields(cfg):
            f.write(f"{field.name} {getattr(cfg, field.name)!r}\n")


def main(argv: Optional[List[str]] = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "fleet":
        from cup3d_tpu_torch.fleet.cli import main as fleet_main

        sys.exit(fleet_main(args[1:]))
    if args and args[0] == "aot":
        raise NotImplementedError(
            "`aot` mode (the compiled store of the fleet advance) is "
            "ROADMAP A8b")
    driver = build_driver(args)
    _log_config(driver)
    driver.init()
    driver.simulate()


if __name__ == "__main__":
    main()
