"""PyTorch port vs the JAX package: the level set (own-cell seed,
27-neighbourhood pass, 24 sweeps) and the CSR index.

On the CPU the port's passes run their plain versions (ops/cuda_seed.py,
ops/cuda_sweep.py); the JAX Pallas kernels run in interpret mode. The bound
2e-6 abs is the JAX package's own Pallas-vs-XLA bound for these passes
(tests/test_pallas_kernels.py). The sweeps are also held to JAX's XLA form
at 13x9x17, an odd, non-cubic shape like those the card tests use to break
the kernel's tiles."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.seeding import dam_break_particles
from fluidsimulation_tpu.ops import levelset as jls
from fluidsimulation_tpu.ops.pallas_seed import neighborhood_pass_pallas
from fluidsimulation_tpu.ops.pallas_sweep import sweep_closest_pallas

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import cuda_sweep
from fluidsimulation_tpu_torch.ops import levelset as tls
from fluidsimulation_tpu_torch.ops.binning import build_csr

N = 16
KW = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N))
CFG, JCFG = ft.SimConfig(**KW), JaxConfig(**KW)
TOL = 2e-6


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _positions(tie: bool):
    """Dam-break positions. With ``tie``, the last 200 particles become
    mirror images of particles 0-199 through their cell centres: another
    position at the same distance from the centre (exactly, for most of
    them), and on an exact tie the seed must keep the lower index."""
    pos, _ = dam_break_particles(JCFG)
    pos = pos.copy()
    if tie:
        pc = pos[:200] * N
        pos[-200:] = (2.0 * np.floor(pc + 0.5) - pc) / N
    return pos


def _own_cell(pos):
    t = torch.from_numpy(pos)
    pc = t * torch.tensor([N, N, N], dtype=torch.float32)
    csr = build_csr(CFG, t)
    return tls.seed_own_cell(CFG, csr, pc[csr.order])


def test_build_csr_is_stable_and_complete():
    pos = _positions(tie=True)
    csr = build_csr(CFG, torch.from_numpy(pos))
    n = pos.shape[0]
    assert sorted(csr.order.tolist()) == list(range(n))
    assert int(csr.start[0]) == 0 and int(csr.start[-1]) == n
    assert bool((csr.cell[1:] >= csr.cell[:-1]).all())
    same = csr.cell[1:] == csr.cell[:-1]
    assert bool((csr.order[1:][same] > csr.order[:-1][same]).all())
    c = np.floor(pos * N + 0.5).astype(np.int64)
    lin = (c[:, 0] * N + c[:, 1]) * N + c[:, 2]
    counts = np.bincount(lin, minlength=N**3)
    np.testing.assert_array_equal(np.diff(csr.start.numpy()), counts)


@pytest.mark.parametrize("tie", [False, True], ids=["dam_break", "exact_ties"])
def test_seed_and_neighborhood_pass_match_jax(tie):
    """Own-cell seed + 27-neighbourhood pass == JAX seed_closest; the pass
    alone == JAX neighborhood_pass_pallas on the same cpos0."""
    pos = _positions(tie)
    cpos0 = _own_cell(pos)
    phi, cpos = tls.neighborhood_pass(CFG, cpos0)
    j_phi, j_cpos = jls.seed_closest(JCFG, jnp.asarray(pos))
    np.testing.assert_allclose(phi.numpy(), np.asarray(j_phi), rtol=0, atol=TOL)
    np.testing.assert_allclose(cpos.numpy(), np.asarray(j_cpos), rtol=0, atol=TOL)

    p_phi, p_cpos = neighborhood_pass_pallas(JCFG, jnp.asarray(cpos0.numpy()))
    np.testing.assert_allclose(phi.numpy(), np.asarray(p_phi), rtol=0, atol=TOL)
    np.testing.assert_allclose(cpos.numpy(), np.asarray(p_cpos), rtol=0, atol=TOL)


ODD = dict(nx=13, ny=9, nz=17, cells_per_meter=13.0)


@pytest.mark.parametrize("shape", ["16", "13x9x17"])
def test_sweep_closest_matches_jax(shape):
    """At 16^3 on the port's own seed, against the Pallas kernel and XLA;
    at 13x9x17 on JAX's seed_closest of the dam break, against XLA."""
    if shape == "16":
        cfg, jcfg, fns = CFG, JCFG, (sweep_closest_pallas, jls.sweep_closest)
        phi0, cpos0 = tls.neighborhood_pass(CFG, _own_cell(_positions(tie=False)))
    else:
        cfg, jcfg, fns = ft.SimConfig(**ODD), JaxConfig(**ODD), (jls.sweep_closest,)
        pos, _ = dam_break_particles(jcfg)
        phi0, cpos0 = (torch.from_numpy(np.array(a))
                       for a in jls.seed_closest(jcfg, jnp.asarray(pos)))
    phi, cpos = tls.sweep_closest(cfg, phi0, cpos0)
    j_in = (jnp.asarray(phi0.numpy()), jnp.asarray(cpos0.numpy()))
    for fn in fns:
        j_phi, j_cpos = fn(jcfg, *j_in)
        np.testing.assert_allclose(phi.numpy(), np.asarray(j_phi), rtol=0, atol=TOL)
        np.testing.assert_allclose(cpos.numpy(), np.asarray(j_cpos), rtol=0, atol=TOL)
    # The inputs are left as they were.
    np.testing.assert_array_equal(phi0.numpy(), np.asarray(j_in[0]))


def test_sweeps_take_any_code_list():
    """``sweeps`` runs the listed sweeps in order (a sub-list is how the
    card times one axis) and refuses an empty list or a code outside 0-5
    before it looks at the device."""
    phi0, cpos0 = tls.neighborhood_pass(CFG, _own_cell(_positions(tie=False)))
    whole = cuda_sweep.sweeps(CFG, phi0, cpos0, cuda_sweep.SWEEP_ORDER)
    want = cuda_sweep.sweep_closest_plain(CFG, phi0, cpos0)
    assert all(torch.equal(a, b) for a, b in zip(whole, want))
    x_only = [c for c in cuda_sweep.SWEEP_ORDER if cuda_sweep.CODE[c][0] == 0]
    part = cuda_sweep.sweeps(CFG, phi0, cpos0, x_only)
    step = (phi0, cpos0)
    for code in x_only:
        step = cuda_sweep.sweeps_plain(CFG, *step, [code])
    assert all(torch.equal(a, b) for a, b in zip(part, step))
    for codes in ([], [0, 6], [-1]):
        with pytest.raises(ValueError, match="codes"):
            cuda_sweep.sweeps(CFG, phi0, cpos0, codes)

