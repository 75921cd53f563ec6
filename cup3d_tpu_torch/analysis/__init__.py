"""The port's analysis layer (port of ``cup3d_tpu/analysis``).

Source: ``python -m cup3d_tpu_torch.analysis [paths]`` walks the port's
AST and flags PyTorch hazards (hidden host syncs, per-step uploads,
float64 in device code, unsynced timing, TF32, ...) under the JAX
package's rule IDs: ``analysis/rules.py`` is the catalog,
``analysis/lint.py`` the heuristics and the suppressions.

Runtime: ``analysis/runtime.py`` holds the sync guard on CUDA's sync
debug mode with its sanctioned sites, the build counter and the NaN
check.  Its names load on first use, so the lint's CLI never imports
torch.
"""

from cup3d_tpu_torch.analysis.rules import RULES, Rule, Violation  # noqa: F401

_RUNTIME = ("ALLOWLIST", "RecompileCounter", "TRANSFER_SITES", "debug_nans",
            "device_scalar", "no_implicit_transfers", "sanctioned_transfer",
            "upload")


def __getattr__(name):
    if name in _RUNTIME:
        from cup3d_tpu_torch.analysis import runtime

        return getattr(runtime, name)
    raise AttributeError(name)
