"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA card. On a machine with one
(and nvcc), run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Inputs are made on the CPU at 32^3 and carried to the card. The seed and
sweep kernels and the SOR are compiled with -fmad=false and must match bit
for bit; the P2G kernel sums in another order than index_add_ (validity
equal, rtol = atol = 2e-4 on valid faces), at ppc 1 and at ppc 2; the G2P
kernel within 1e-5 abs.
"""

import numpy as np
import pytest
import torch

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core.seeding import noise_grids
from fluidsimulation_tpu_torch.ops import cuda_g2p, cuda_p2g, cuda_seed, cuda_sor, cuda_sweep
from fluidsimulation_tpu_torch.ops.binning import build_csr
from fluidsimulation_tpu_torch.ops.levelset import seed_own_cell
from fluidsimulation_tpu_torch.ops.project import compute_diag, compute_rhs

pytestmark = pytest.mark.cuda

N = 32
CFG = ft.SimConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N), particles_per_cell_axis=1)
CFG2 = ft.SimConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N), particles_per_cell_axis=2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _particles(dev, cfg=CFG):
    """Dam-break positions with velocities sampled from noise grids."""
    s = ft.init_state(cfg, "cpu")
    grids = [torch.from_numpy(g) for g in noise_grids(cfg, seed=5)]
    vel = cuda_g2p.g2p_flip_plain(cfg, s.pos, s.vel, *grids, *grids, 0.0)[1]
    return s.pos.to(dev), vel.to(dev)


def _counted(module, fn, *args):
    before = module.KERNEL.launches
    out = fn(*args)
    torch.cuda.synchronize()
    return out, module.KERNEL.launches - before


def test_seed_and_sweep_kernels_bit_exact(dev):
    pos, _ = _particles(dev)
    cpos0 = seed_own_cell(CFG, build_csr(CFG, pos), pos * N)
    (phi, cpos), n = _counted(cuda_seed, cuda_seed.neighborhood_pass, CFG, cpos0)
    assert n == 1
    want = cuda_seed.neighborhood_pass_plain(CFG, cpos0)
    assert torch.equal(phi, want[0]) and torch.equal(cpos, want[1])

    (sphi, scpos), n = _counted(cuda_sweep, cuda_sweep.sweep_closest, CFG, phi, cpos)
    assert n == len(cuda_sweep.SWEEP_ORDER)
    want = cuda_sweep.sweep_closest_plain(CFG, phi, cpos)
    assert torch.equal(sphi, want[0]) and torch.equal(scpos, want[1])


@pytest.mark.parametrize("cfg", [CFG, CFG2], ids=["ppc1", "ppc2"])
def test_p2g_kernel_matches_plain(dev, cfg):
    pos, vel = _particles(dev, cfg)
    csr = build_csr(cfg, pos)
    pcs, vels = (pos * N)[csr.order], vel[csr.order]
    got, n = _counted(cuda_p2g, cuda_p2g.p2g_accumulate, cfg, pcs, vels, csr.start)
    assert n == 1
    want = cuda_p2g.p2g_accumulate_plain(cfg, pcs, vels)
    for (acc_k, amt_k), (acc_p, amt_p) in zip(got, want):
        near = (amt_p - cfg.zero_thresh).abs() < 1e-6
        valid_k, valid_p = amt_k > cfg.zero_thresh, amt_p > cfg.zero_thresh
        assert not bool(((valid_k != valid_p) & ~near).any())
        both = valid_k & valid_p
        torch.testing.assert_close((acc_k / amt_k)[both], (acc_p / amt_p)[both],
                                   rtol=2e-4, atol=2e-4)


def test_sor_kernel_bit_exact(dev):
    """The SOR on the dam break's level set with a noise-grid RHS (p ~ 1e3
    after 100 iterations): one launch, bit for bit the plain version."""
    pos, _ = _particles(dev)
    phi = cuda_sweep.sweep_closest(
        CFG, *cuda_seed.neighborhood_pass(CFG, seed_own_cell(CFG, build_csr(CFG, pos), pos * N)))[0]
    grids = [torch.from_numpy(g).to(dev) for g in noise_grids(CFG, seed=7)]
    b = compute_rhs(CFG, *grids, 0.01)
    diag = compute_diag(CFG, phi)
    p, n = _counted(cuda_sor, cuda_sor.sor_pressure, CFG, phi, diag, b)
    assert n == 1
    want = cuda_sor.sor_pressure_plain(CFG, phi, diag, b)
    assert float(want.abs().max()) > 1.0
    assert torch.equal(p, want)


def test_g2p_kernel_matches_plain(dev):
    pos, vel = _particles(dev)
    rng = np.random.default_rng(2)
    grids = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
             for s in (CFG.u_shape(), CFG.v_shape(), CFG.w_shape()) * 2]
    # Queries past every edge reach the clamps and top-edge decrements.
    pos = torch.cat([pos, torch.tensor([[-0.1, 1.1, 0.5], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]],
                                       device=dev)])
    vel = torch.cat([vel, torch.ones(3, 3, device=dev)])
    (v, k1), n = _counted(cuda_g2p, cuda_g2p.g2p_flip, CFG, pos, vel, *grids, 0.97)
    assert n == 1
    wv, wk1 = cuda_g2p.g2p_flip_plain(CFG, pos, vel, *grids, 0.97)
    torch.testing.assert_close(v, wv, rtol=0, atol=1e-5)
    torch.testing.assert_close(k1, wk1, rtol=0, atol=1e-5)


def test_wrappers_reject_bad_arguments(dev):
    cpos0 = torch.zeros((N, N, N, 3), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        cuda_seed.neighborhood_pass(CFG, cpos0)
    with pytest.raises(ValueError, match="shape"):
        cuda_seed.neighborhood_pass(CFG, torch.zeros((N, N, 3), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_seed.neighborhood_pass(CFG, torch.zeros((3, N, N, N), device=dev).permute(1, 2, 3, 0))
    phi = torch.zeros((N, N, N), device=dev)
    with pytest.raises(ValueError, match="devices"):
        cuda_sweep.sweep_closest(CFG, phi, torch.zeros((N, N, N, 3)))
    with pytest.raises(ValueError, match="devices"):
        cuda_sor.sor_pressure(CFG, phi, phi, torch.zeros((N, N, N)))
    with pytest.raises(ValueError, match="shape"):
        cuda_sor.sor_pressure(CFG, phi, phi, torch.zeros((N, N, N + 1), device=dev))


def test_step_on_card_matches_cpu(dev):
    s = ft.init_state(CFG, "cpu")
    for _ in range(2):
        s = ft.step(s, 1.0 / 60.0, CFG)
    cpu = ft.step(s, 1.0 / 60.0, CFG)
    card = ft.step(s.to(dev), 1.0 / 60.0, CFG)
    for name in ("pos", "vel", "u", "v", "w", "phi", "k1"):
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(cpu, name),
                                   rtol=0, atol=1e-4)
