"""Simulation configurations, 3D and 2D (copy of
fluidsimulation_tpu/core/config.py).

Copied rather than imported: importing the JAX package pulls in jax. The
JAX config's ``overflow_cap`` is left out, because the port bins particles
into an unbounded index (ops/binning.py) and has no overflow tiers.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration of a 3D PIC/FLIP simulation.

      nx, ny, nz          : grid size in cells (FluidSimDemo.cpp:53-55)
      cells_per_meter     : grid resolution (FluidSimDemo.cpp:93)
      rho                 : fluid density, kg/m^3 (Simulation.h:72)
      gravity_y           : gravity on the V grid, m/s^2 (Simulation.h:75)
      nu                  : kinematic viscosity, m^2/s (Simulation.h:78)
      particle_radius     : level-set particle radius in *cells*
      sor_iterations      : checkerboard SOR iterations (Simulation.cpp:910)
      max_dt              : dt clamp, s (Simulation.cpp:515)
      seed                : LCG seed for the dam-break jitter
      particles_per_cell_axis : particles seeded per cell axis
      max_ls_ratio        : ghost-fluid ratio clamp
      zero_thresh         : P2G valid-weight threshold
    """

    nx: int = 64
    ny: int = 64
    nz: int = 64
    cells_per_meter: float = 64.0
    rho: float = 1000.0
    gravity_y: float = -9.81
    nu: float = 8.90e-4 / 1000.0
    particle_radius: float = 1.0
    sor_iterations: int = 100
    max_dt: float = 1.0 / 15.0
    seed: int = 0
    particles_per_cell_axis: int = 2
    max_ls_ratio: float = 1000.0
    zero_thresh: float = 0.01

    @property
    def omega(self) -> float:
        """SOR over-relaxation factor 2 - 3.16343/nx (Simulation.cpp:909)."""
        return 2.0 - 3.16343 / self.nx

    @property
    def dx(self) -> float:
        return 1.0 / self.cells_per_meter

    @property
    def num_particles(self) -> int:
        """Dam-break particle count (Simulation.cpp:47-74)."""
        ppc = self.particles_per_cell_axis ** 3
        return (self.nx - 1 - self.nx // 2) * (self.ny - 2) * (self.nz - 2) * ppc

    def grid_shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    def u_shape(self) -> tuple[int, int, int]:
        return (self.nx + 1, self.ny, self.nz)

    def v_shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny + 1, self.nz)

    def w_shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny, self.nz + 1)


@dataclasses.dataclass(frozen=True)
class SimConfig2D:
    """2D analogue (Simulation2D.h). Kept separate: the 2D solver differs in
    more than rank (4-sweep level set, 120 SOR iterations, curl-noise init).

      particle_radius     : 2/sqrt(2) cells (Simulation2D.h:203)
      sor_iterations      : 120 (Simulation2D.cpp:701)
    """

    nx: int = 64
    ny: int = 64
    cells_per_meter: float = 64.0
    rho: float = 1000.0
    gravity_y: float = -9.81
    nu: float = 8.90e-4 / 1000.0
    particle_radius: float = 2.0 / math.sqrt(2.0)
    sor_iterations: int = 120
    max_dt: float = 1.0 / 15.0
    seed: int = 0
    max_ls_ratio: float = 1000.0
    zero_thresh: float = 0.01

    @property
    def omega(self) -> float:
        """SOR over-relaxation factor 2 - 3.22133/nx (Simulation2D.cpp:699)."""
        return 2.0 - 3.22133 / self.nx

    @property
    def dx(self) -> float:
        return 1.0 / self.cells_per_meter

    @property
    def num_particles(self) -> int:
        """Dam-break particle count (Simulation2D.cpp:62-77): 4 per cell."""
        return (self.nx - 1 - self.nx // 2) * (self.ny - 2) * 4
