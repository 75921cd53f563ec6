"""The compiled store and the background compile service (port of
``cup3d_tpu/aot/``).

``aot/store.py`` keeps what a fresh process would otherwise rebuild
before it can serve (the nvcc-built kernel libraries and the forest's
host-built tables) on disk, keyed by content signature and environment
fingerprint.  ``aot/compiler.py`` moves a cold ``amr_tgv`` forest's
table build off the fleet's dispatch thread.  ``aot/cli.py`` is the
``python -m cup3d_tpu_torch aot`` operator surface (``warm`` / ``list``
/ ``gc`` / ``verify`` / ``probe``).

Everything is opt-in behind ``CUP3D_AOT_STORE``: with it unset every
seam (the fleet's table builds, the forest's table memo and
``cached_forest``, the kernel loader) behaves exactly as before.
"""

from cup3d_tpu_torch.aot.store import (  # noqa: F401
    ExecutableStore,
    active_store,
    fingerprint,
)
