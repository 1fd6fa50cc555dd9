"""PyTorch port vs the JAX package: the checkerboard SOR pressure solve.

On the CPU the port's ``sor_pressure`` runs its plain version
(ops/cuda_sor.py). Two sets of 16^3 inputs: those of
tests/test_pallas_sor.py (the dam break after one step, its level set,
diagonal and RHS), and the dam break's level set with a noise-grid RHS.
The port is held to JAX's XLA form within 1e-6 of the largest |p|, and to
the JAX Pallas kernel in interpret mode at test_pallas_sor.py's bound
(rtol 1e-5, atol 1e-6). A third set, the noise-RHS inputs at 13x9x17 (an
odd, non-cubic shape like those the card tests use to break the kernel's
lists and grid), is held to XLA only. The Pallas kernel writes the update as a lerp and
sums the neighbours in another order (pallas_sor.py:99-109), so it is held
by the looser bound."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.seeding import dam_break_particles, noise_grids
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.ops import levelset, pallas_sor
from fluidsimulation_tpu.ops import project as jax_project
from fluidsimulation_tpu.solver.step3d import step_jit

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import cuda_sor
from fluidsimulation_tpu_torch.ops.cuda_sor import sor_pressure_plain
from fluidsimulation_tpu_torch.ops.project import sor_pressure

N = 16
KW = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N))
CFG, JCFG = ft.SimConfig(**KW), JaxConfig(**KW)
ODD = dict(nx=13, ny=9, nz=17, cells_per_meter=13.0)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _step_inputs():
    """tests/test_pallas_sor.py's inputs: the state after one step is
    nearly divergence-free, so p is small (max |p| ~ 4e-5)."""
    state = step_jit(jax_init(JCFG), 0.01, JCFG)
    phi, _ = levelset.compute_level_set(JCFG, state.pos)
    b = jax_project.compute_rhs(JCFG, state.u, state.v, state.w, jnp.float32(0.01))
    return phi, b


def _noise_inputs(jcfg=JCFG):
    """The dam break's level set with the RHS of noise grids: p ~ 1e3."""
    pos, _ = dam_break_particles(jcfg)
    phi, _ = levelset.compute_level_set(jcfg, jnp.asarray(pos))
    u, v, w = noise_grids(jcfg, seed=7)
    b = jax_project.compute_rhs(jcfg, *map(jnp.asarray, (u, v, w)), jnp.float32(0.01))
    return phi, b


# case -> (port config, JAX config, inputs)
INPUTS = {
    "after_one_step": (CFG, JCFG, _step_inputs),
    "noise_rhs": (CFG, JCFG, _noise_inputs),
    "noise_rhs_13x9x17": (ft.SimConfig(**ODD), JaxConfig(**ODD),
                          lambda: _noise_inputs(JaxConfig(**ODD))),
}


@pytest.fixture(scope="module", params=sorted(INPUTS))
def solve_inputs(request):
    cfg, jcfg, make = INPUTS[request.param]
    phi, b = make()
    diag = jax_project.compute_diag(jcfg, phi)
    return request.param, cfg, jcfg, tuple(np.asarray(a) for a in (phi, diag, b))


def test_sor_matches_jax_pallas_and_xla(solve_inputs):
    """Against XLA: 1e-6 of the largest |p|. Against the Pallas kernel (at
    16^3 only): rtol 1e-5, atol 1e-6 where p is small (test_pallas_sor.py's
    inputs); where p ~ 1e3 that per-element bound is below the Pallas
    kernel's own distance from XLA, and it is held by 1e-6 of the largest
    |p| too."""
    case, cfg, jcfg, arrays = solve_inputs
    phi = arrays[0]
    assert (phi < 0).sum() > 100  # the solve has fluid to work on
    before = cuda_sor.KERNEL.launches
    p = sor_pressure(cfg, *map(torch.from_numpy, arrays)).numpy()
    assert cuda_sor.KERNEL.launches == before  # CPU: the plain version
    assert np.abs(p).max() > 0
    want_xla = np.asarray(jax_project.sor_pressure(
        jcfg, *map(jnp.asarray, arrays), use_pallas=False))
    scale = np.abs(want_xla).max()
    assert np.abs(p - want_xla).max() <= 1e-6 * scale
    if cfg is not CFG:
        return
    want_pallas = np.asarray(pallas_sor.sor_pressure_pallas(
        jcfg, *map(jnp.asarray, arrays), interpret=True))
    if case == "after_one_step":
        np.testing.assert_allclose(p, want_pallas, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(p - want_pallas).max() <= 1e-6 * scale


def test_sor_plain_is_the_cpu_path(solve_inputs):
    """On a CPU tensor the wrapper is the plain version, bit for bit; air
    cells keep p = 0."""
    _, cfg, _, arrays = solve_inputs
    args = [torch.from_numpy(a) for a in arrays]
    p = sor_pressure(cfg, *args)
    torch.testing.assert_close(p, sor_pressure_plain(cfg, *args), rtol=0, atol=0)
    assert bool((p[args[0] >= 0] == 0).all())


def test_relaxation_constants():
    omega, one_minus = cuda_sor.relaxation(CFG)
    assert omega.dtype == np.float32 and one_minus.dtype == np.float32
    assert omega == np.float32(2.0 - 3.16343 / N)
    assert float(one_minus) == 1.0 - float(omega)  # exact in float32
