"""The whole timestep as one function (port of ``cup3d_tpu/sim/fused.py``):
advection-diffusion -> (penalization) -> projection, the device-side
pipeline of the reference's operator-by-operator sweep
(Simulation::advance, main.cpp:15306-15326).

The JAX package jits it so XLA fuses the elementwise chains; here it is
plain PyTorch calling the same operator functions (the Poisson solver's
fused stages are the CUDA kernels under ``CUP3D_FUSED=1``).
"""

from __future__ import annotations

from cup3d_tpu_torch.grid.uniform import UniformGrid
from cup3d_tpu_torch.ops.advection import rk3_step
from cup3d_tpu_torch.ops.penalization import penalize
from cup3d_tpu_torch.ops.projection import project


def make_step(grid: UniformGrid, nu: float, solver,
              with_bodies: bool = False, donate: bool = True):
    """Returns step(vel, dt, uinf[, chi, ubody, udef, lam]) -> (vel, p).

    ``with_bodies`` switches in the penalization and the pressure-RHS
    obstacle terms.  Every runtime scalar is an argument.  ``donate`` is
    accepted for the JAX package's signature and does nothing: the port
    never aliases its input, so the passed-in ``vel`` stays readable
    either way."""
    del donate

    if with_bodies:

        def step(vel, dt, uinf, chi, ubody, udef, lam):
            vel = rk3_step(grid, vel, dt, nu, uinf)
            vel = penalize(vel, chi, ubody, lam, dt)
            return project(grid, vel, dt, solver, chi, udef)

    else:

        def step(vel, dt, uinf):
            vel = rk3_step(grid, vel, dt, nu, uinf)
            return project(grid, vel, dt, solver)

    return step
