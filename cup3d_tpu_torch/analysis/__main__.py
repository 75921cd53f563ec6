"""CLI: ``python -m cup3d_tpu_torch.analysis [paths] [options]``.

Exit status 0 iff every finding is annotated inline (``# torch-lint:
allow(JX00n, reason)``, or inside a ``sanctioned_transfer`` block) or
covered by the baseline (``analysis/baseline.json`` by default)::

    python -m cup3d_tpu_torch.analysis cup3d_tpu_torch/ -q  # the port
    python -m cup3d_tpu_torch.analysis --list-rules        # the catalog
    python -m cup3d_tpu_torch.analysis --no-baseline ...   # everything
    python -m cup3d_tpu_torch.analysis --write-baseline ... # a burn-down

The JAX package's IR audit (``audit``, rules JP001-JP005) has no PyTorch
counterpart: ``--list-rules`` shows those rules as not applicable.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from cup3d_tpu_torch.analysis import lint as lint_mod
from cup3d_tpu_torch.analysis.rules import RULES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cup3d_tpu_torch.analysis",
        description="PyTorch-aware AST lint of the port (rules JX001-JX022)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: the package)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default: analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report everything")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings to the baseline "
                         "(reasons left as TODO for the author)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule IDs to check")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only failing findings")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    if args.list_rules:
        for rule in RULES.values():
            state = ("" if rule.applies
                     else f"  [not applicable: {rule.not_applicable}]")
            print(f"{rule.id}  {rule.title}{state}")
            if rule.rationale:
                print(f"       {rule.rationale}")
            print()
        return 0

    paths = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    baseline_path = None
    if not args.no_baseline:
        baseline_path = args.baseline or lint_mod.default_baseline_path()
    rules = ({r.strip().upper() for r in args.rules.split(",")}
             if args.rules else None)
    violations = lint_mod.lint_paths(paths, baseline_path=baseline_path,
                                     rules=rules)
    if args.write_baseline:
        out = args.baseline or lint_mod.default_baseline_path()
        lint_mod.write_baseline(violations, out)
        print(f"baseline written: {out} "
              f"({len(lint_mod.failing(violations))} entries to justify)")
        return 0

    failing = lint_mod.failing(violations)
    if args.format == "json":
        print(json.dumps({"violations": [v.__dict__ for v in violations],
                          "failing": len(failing)}, indent=2))
    else:
        for v in (failing if args.quiet else violations):
            print(v.format())
        n_sup = sum(1 for v in violations if v.suppressed)
        n_base = sum(1 for v in violations if v.baselined)
        print(f"torch-lint: {len(violations)} finding(s): {len(failing)} "
              f"failing, {n_sup} annotated, {n_base} baselined")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
