"""cup3d_tpu_torch: the PyTorch/CUDA port of cup3d_tpu for NVIDIA Hopper.

The JAX package ``cup3d_tpu`` stays the reference; this package sits
beside it, keeps its module names, imports ``torch`` and numpy and never
JAX or ``cup3d_tpu``.  Plain tensor code is PyTorch; the TPU's Pallas
kernels on the ported path are CUDA C++ kernels for ``sm_90a``
(``csrc/``), each with a plain PyTorch version beside it that the CPU
runs and the card is checked against.

Entry points (``sim.simulation.Simulation``, ``python -m
cup3d_tpu_torch``) run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
