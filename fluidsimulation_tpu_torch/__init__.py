"""fluidsimulation_tpu_torch: the PyTorch and CUDA port of fluidsimulation_tpu.

The 3D and 2D PIC/FLIP steps and the 3D and 2D APIC steps on an NVIDIA
H100. The layout follows the JAX package, module for module and name for
name:

  core/    configs, minstd seeding, states (dataclasses of tensors), MAC interpolation,
           the combined-key table (core/cuda_pack.py wraps its kernel in csrc/)
  ops/     the op set; ops/cuda_*.py wrap the other hand-written kernels in csrc/
  solver/  step(), step_guarded(), simulate(); the APIC family's step_apic();
           the 2D family's step2d() and step_apic2d()
  render/  the raytraced frames; the 2D debug splats
  utils/   Meter, velocity_guard, check_state; npz checkpoints; profiling
  app/     the demo CLI (python -m fluidsimulation_tpu_torch)

The package imports torch and never jax. Kernels build on first use
(_build.py); a CPU tensor takes each kernel's plain PyTorch version.
"""

from .core.config import SimConfig, SimConfig2D
from .core.state import (
    ApicState,
    ApicState2D,
    SimState,
    SimState2D,
    apic_state2d_from_numpy,
    apic_state2d_to_numpy,
    apic_state_from_numpy,
    apic_state_to_numpy,
    init_apic_state2d,
    init_state,
    init_state2d,
    state2d_from_numpy,
    state2d_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from .solver.apic import init_apic_state, simulate_apic, step_apic
from .solver.apic2d import step_apic2d
from .solver.step2d import step2d
from .solver.step3d import simulate, step, step_guarded

__all__ = [
    "SimConfig", "SimState", "init_state", "state_from_numpy", "state_to_numpy",
    "step", "step_guarded", "simulate",
    "ApicState", "init_apic_state", "step_apic", "simulate_apic",
    "apic_state_from_numpy", "apic_state_to_numpy",
    "SimConfig2D", "SimState2D", "init_state2d", "step2d", "state2d_from_numpy",
    "state2d_to_numpy", "ApicState2D", "init_apic_state2d", "step_apic2d",
    "apic_state2d_from_numpy", "apic_state2d_to_numpy",
]
