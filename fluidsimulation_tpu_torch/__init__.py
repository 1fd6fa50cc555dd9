"""fluidsimulation_tpu_torch: the PyTorch and CUDA port of fluidsimulation_tpu.

The 3D PIC/FLIP step on an NVIDIA H100. The layout follows the JAX package,
module for module and name for name:

  core/    config, minstd seeding, state (a dataclass of tensors), MAC interpolation,
           the combined-key table (core/cuda_pack.py wraps its kernel in csrc/)
  ops/     the op set; ops/cuda_*.py wrap the other hand-written kernels in csrc/
  solver/  step(), step_guarded(), simulate()
  utils/   Meter, velocity_guard, check_state; npz checkpoints
  app/     the demo CLI (python -m fluidsimulation_tpu_torch)

The package imports torch and never jax. Kernels build on first use
(_build.py); a CPU tensor takes each kernel's plain PyTorch version.
"""

from .core.config import SimConfig
from .core.state import SimState, init_state, state_from_numpy, state_to_numpy
from .solver.step3d import simulate, step, step_guarded

__all__ = [
    "SimConfig", "SimState", "init_state", "state_from_numpy", "state_to_numpy",
    "step", "step_guarded", "simulate",
]
