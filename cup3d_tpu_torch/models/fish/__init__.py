"""Fish subsystem (port of ``cup3d_tpu/models/fish``): the midline
kinematics stay on the host in numpy float64 (``interpolation``,
``schedulers``, ``frenet``, ``shapes``, ``midline``, ``curvature``, own
copies of the JAX package's modules); the per-cell work, the signed
distance of every cell of a dense window to the deforming body and its
deformation velocity, is plain PyTorch on the device (``rasterize``).
"""

from cup3d_tpu_torch.models.fish.stefanfish import StefanFish  # noqa: F401
