"""PyTorch port vs the JAX package: seeding, state, interpolation, imports.

The same numpy inputs go through both packages on the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.interp import interp_mac3_vec as jax_interp
from fluidsimulation_tpu.core.seeding import noise_grids as jax_noise
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.solver.step3d import step_jit

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core.interp import interp_mac3_vec
from fluidsimulation_tpu_torch.core.seeding import noise_grids

ROOT = Path(__file__).resolve().parent.parent
N = 16


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def configs(ppc=2):
    kw = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N), particles_per_cell_axis=ppc)
    return ft.SimConfig(**kw), JaxConfig(**kw)


@pytest.mark.parametrize("ppc", [1, 2])
def test_init_state_bit_exact(ppc):
    cfg, jcfg = configs(ppc)
    s = ft.init_state(cfg, "cpu")
    j = jax_init(jcfg)
    assert s.pos.shape == (cfg.num_particles, 3)
    np.testing.assert_array_equal(s.pos.numpy(), j.pos)
    np.testing.assert_array_equal(s.vel.numpy(), j.vel)
    for name in ("u", "v", "w", "phi"):
        np.testing.assert_array_equal(getattr(s, name).numpy(), getattr(j, name))
    np.testing.assert_array_equal(s.k1.numpy(), np.zeros((cfg.num_particles, 3), np.float32))
    assert ft.init_state(cfg, "cpu", with_cache=False).k1 is None


def test_noise_grids_bit_exact():
    cfg, jcfg = configs()
    for a, b in zip(noise_grids(cfg, seed=4), jax_noise(jcfg, seed=4)):
        np.testing.assert_array_equal(a, b)


def test_interp_mac3_vec_matches_jax():
    """Random queries in [-0.2, 1.2]*n reach every clamp and top-edge
    decrement of _split_normal / _split_extended. Bound 1e-6 abs."""
    rng = np.random.default_rng(3)
    grids = [rng.normal(size=s).astype(np.float32)
             for s in ((N + 1, N, N), (N, N + 1, N), (N, N, N + 1))]
    q = (rng.uniform(-0.2, 1.2, size=(4000, 3)) * N).astype(np.float32)
    q[:8] = [[0, 0, 0], [N - 1, N - 1, N - 1], [N, N, N], [N - 0.5, N - 0.5, N - 0.5],
             [-0.5, -0.5, -0.5], [N - 1.5, 0.5, N - 0.5], [-1, N + 1, 3.5], [2, 2, 2]]
    got = interp_mac3_vec(*map(torch.from_numpy, grids), torch.from_numpy(q)).numpy()
    want = np.asarray(jax_interp(*map(jnp.asarray, grids), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_state_from_numpy_round_trip_bit_exact():
    """A stepped JAX state (with its AdvectCache) carried into the port and
    back is bit-identical; of the cache only k1 comes along."""
    _, jcfg = configs()
    j = step_jit(jax_init(jcfg), 0.01, jcfg, fast=False)
    s = ft.state_from_numpy(j, "cpu")
    out = ft.state_to_numpy(s)
    for name in ("pos", "vel", "u", "v", "w", "phi"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(out["k1"], np.asarray(j.cache.k1))
    moved = ft.state_to_numpy(s.to("cpu"))
    for name, arr in out.items():
        np.testing.assert_array_equal(moved[name], arr)


@pytest.mark.parametrize(
    "code",
    [
        "import sys, fluidsimulation_tpu_torch.solver.step3d; "
        "assert 'jax' not in sys.modules, 'port imported jax'",
        "import sys, fluidsimulation_tpu_torch.app.demo, fluidsimulation_tpu_torch.utils.checkpoint; "
        "assert 'jax' not in sys.modules, 'demo imported jax'",
        "import sys, fluidsimulation_tpu_torch.render.raytrace, "
        "fluidsimulation_tpu_torch.render.interior, fluidsimulation_tpu_torch.render.camera; "
        "assert 'jax' not in sys.modules, 'render imported jax'; "
        "assert not any(m.split('.')[0] == 'fluidsimulation_tpu' for m in sys.modules), "
        "'render imported the JAX package'",
        "import sys, fluidsimulation_tpu_torch.solver.apic, fluidsimulation_tpu_torch.ops.apic, "
        "fluidsimulation_tpu_torch.utils.profiling; "
        "assert 'jax' not in sys.modules, 'apic imported jax'; "
        "assert not any(m.split('.')[0] == 'fluidsimulation_tpu' for m in sys.modules), "
        "'apic imported the JAX package'",
        "import sys, fluidsimulation_tpu_torch.solver.step2d, "
        "fluidsimulation_tpu_torch.solver.apic2d, fluidsimulation_tpu_torch.render.debug; "
        "assert 'jax' not in sys.modules, '2d imported jax'; "
        "assert not any(m.split('.')[0] == 'fluidsimulation_tpu' for m in sys.modules), "
        "'2d imported the JAX package'",
        "import sys, fluidsimulation_tpu_torch.parallel.halo_step, "
        "fluidsimulation_tpu_torch.parallel.halo_apic, "
        "fluidsimulation_tpu_torch.parallel.comm, fluidsimulation_tpu_torch.render.sharded; "
        "assert 'jax' not in sys.modules, 'parallel imported jax'; "
        "assert not any(m.split('.')[0] == 'fluidsimulation_tpu' for m in sys.modules), "
        "'parallel imported the JAX package'",
    ],
    ids=["package", "demo", "render", "apic", "2d", "parallel"],
)
def test_port_imports_no_jax(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("ppc,particles", [(1, 8_193_532), (2, 65_548_256)])
def test_particle_counts_at_256(ppc, particles):
    """The 256^3 dam break (ppc 2: the benchmark's grid256 configuration,
    bench_torch/configs/grid256.json): 127 x 254 x 254 cells of ppc^3
    particles, as the JAX config counts them."""
    kw = dict(nx=256, ny=256, nz=256, cells_per_meter=256.0, particles_per_cell_axis=ppc)
    assert ft.SimConfig(**kw).num_particles == JaxConfig(**kw).num_particles == particles
