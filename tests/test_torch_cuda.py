"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA card. On a machine with one
(and nvcc), run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Inputs are made on the CPU at 32^3 and carried to the card. The seed and
sweep kernels and the SOR are compiled with -fmad=false and must match bit
for bit, also at shapes that break the sweep kernel's 32-line tiles and
32-plane chunks and the SOR's colour-split layout (13x9x17, 20x12x24,
8x8x200, whose z-lines are longer than six chunks, and 64^3); the P2G
kernel sums in another order than index_add_ (validity equal, rtol = atol
= 2e-4 on valid faces), at ppc 1 and at ppc 2, at those odd shapes (ragged
cell tiles) and with 3,000 particles in one cell (a halo walked in chunks);
two P2G launches are bit-equal; the G2P kernel within
1e-5 abs, and NaN where a coordinate is NaN. A state with one NaN position
steps twice on the card without a raise (the NaN rule). The combined-key pack (pure copies) must equal its
plain version bit for bit at small odd shapes and at 64^3.
"""

import numpy as np
import pytest
import torch

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core import cuda_pack
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
    assert n == 1  # one C call runs the 24 sweeps
    want = cuda_sweep.sweep_closest_plain(CFG, phi, cpos)
    assert torch.equal(sphi, want[0]) and torch.equal(scpos, want[1])


def _random_particles(dev, cfg, n, seed, cram=0):
    """n particles uniform over the advection clamp box, ``cram`` more in
    one cell, normal velocities: CSR-sorted (pcs, vels, start) on the card."""
    rng = np.random.default_rng(seed)
    m = np.array([cfg.nx, cfg.ny, cfg.nz], dtype=np.float32)
    pos = rng.uniform(-0.4 / m, 1.0 - 0.6 / m, size=(n, 3)).astype(np.float32)
    if cram:
        cell = np.floor(m / 2)
        pile = (cell + rng.uniform(-0.45, 0.45, size=(cram, 3))) / m
        pos = np.concatenate([pos, pile.astype(np.float32)])
    pos = torch.from_numpy(pos).to(dev)
    vel = torch.from_numpy(rng.standard_normal(tuple(pos.shape)).astype(np.float32)).to(dev)
    csr = build_csr(cfg, pos)
    scale = torch.tensor(m, device=dev)
    return (pos * scale)[csr.order], vel[csr.order], csr.start


def _p2g_close(cfg, got, want):
    """Validity equal except within 1e-6 of the threshold; rtol = atol =
    2e-4 on faces valid in both (the sums are taken in another order)."""
    for (acc_k, amt_k), (acc_p, amt_p) in zip(got, want):
        near = (amt_p - cfg.zero_thresh).abs() < 1e-6
        valid_k, valid_p = amt_k > cfg.zero_thresh, amt_p > cfg.zero_thresh
        assert not bool(((valid_k != valid_p) & ~near).any())
        both = valid_k & valid_p
        torch.testing.assert_close((acc_k / amt_k)[both], (acc_p / amt_p)[both],
                                   rtol=2e-4, atol=2e-4)


def _p2g_equal(a, b):
    return all(torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))


@pytest.mark.parametrize("cfg", [CFG, CFG2], ids=["ppc1", "ppc2"])
def test_p2g_kernel_matches_plain(dev, cfg):
    pos, vel = _particles(dev, cfg)
    csr = build_csr(cfg, pos)
    pcs, vels = (pos * N)[csr.order], vel[csr.order]
    got, n = _counted(cuda_p2g, cuda_p2g.p2g_accumulate, cfg, pcs, vels, csr.start)
    assert n == 1
    _p2g_close(cfg, got, cuda_p2g.p2g_accumulate_plain(cfg, pcs, vels))


@pytest.mark.parametrize("cfg", [CFG, CFG2], ids=["ppc1", "ppc2"])
def test_p2g_kernel_deterministic(dev, cfg):
    """Two launches on the same inputs bit-equal."""
    pos, vel = _particles(dev, cfg)
    csr = build_csr(cfg, pos)
    args = (cfg, (pos * N)[csr.order], vel[csr.order], csr.start)
    assert _p2g_equal(cuda_p2g.p2g_accumulate(*args), cuda_p2g.p2g_accumulate(*args))


@pytest.mark.parametrize("shape", [(13, 9, 17), (20, 12, 24), (8, 8, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_p2g_kernel_at_shapes(dev, shape):
    """Ragged tiles and z-columns of many tiles, against the plain
    version."""
    cfg = _shape_cfg(shape)
    pcs, vels, start = _random_particles(dev, cfg, 4 * shape[0] * shape[1] * shape[2], sum(shape))
    got = cuda_p2g.p2g_accumulate(cfg, pcs, vels, start)
    _p2g_close(cfg, got, cuda_p2g.p2g_accumulate_plain(cfg, pcs, vels))


def test_p2g_kernel_crammed(dev):
    """3,000 particles in one cell besides the rest: the halo of the tiles
    around it is walked in chunks (2,048 particles a buffer)."""
    cfg = _shape_cfg((20, 12, 24))
    pcs, vels, start = _random_particles(dev, cfg, 20 * 12 * 24, 3, cram=3000)
    assert int((start[1:] - start[:-1]).max()) >= 3000
    got, n = _counted(cuda_p2g, cuda_p2g.p2g_accumulate, cfg, pcs, vels, start)
    assert n == 1
    _p2g_close(cfg, got, cuda_p2g.p2g_accumulate_plain(cfg, pcs, vels))
    assert _p2g_equal(got, cuda_p2g.p2g_accumulate(cfg, pcs, vels, start))


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


SHAPES = [(13, 9, 17), (20, 12, 24), (8, 8, 200), (64, 64, 64)]


def _shape_cfg(shape):
    nx, ny, nz = shape
    return ft.SimConfig(nx=nx, ny=ny, nz=nz, cells_per_meter=float(nx))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sweep_kernel_bit_exact_at_shapes(dev, shape):
    """Candidates in 30% of the cells, scattered over and past the grid,
    FAR elsewhere; phi their distance minus r: the 24 sweeps in one launch,
    and each axis's 8 alone, bit for bit the plain version."""
    cfg = _shape_cfg(shape)
    rng = np.random.default_rng(sum(shape))
    cpos = rng.uniform(-2.0, max(shape) + 2.0, size=(*shape, 3)).astype(np.float32)
    cpos[rng.random(shape) > 0.3] = 1.0e9
    cpos = torch.from_numpy(cpos)
    axes = [torch.arange(n, dtype=torch.float32) for n in shape]
    centers = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    phi = cuda_seed.dist(*cpos.unbind(-1), *centers.unbind(-1)) - cfg.particle_radius
    phi, cpos = phi.to(dev), cpos.to(dev)
    (sphi, scpos), n = _counted(cuda_sweep, cuda_sweep.sweep_closest, cfg, phi, cpos)
    assert n == 1
    want = cuda_sweep.sweep_closest_plain(cfg, phi, cpos)
    assert torch.equal(sphi, want[0]) and torch.equal(scpos, want[1])
    for axis in range(3):
        codes = [c for c in cuda_sweep.SWEEP_ORDER if cuda_sweep.CODE[c][0] == axis]
        got = cuda_sweep.sweeps(cfg, phi, cpos, codes)
        want = cuda_sweep.sweeps_plain(cfg, phi, cpos, codes)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sor_kernel_bit_exact_at_shapes(dev, shape):
    """A noisy slab of fluid (about half the cells) with a noise RHS: one
    launch, bit for bit the plain version; the kernel's counters hold each
    colour's fluid cells and 2 x iterations - 1 grid barriers."""
    cfg = _shape_cfg(shape)
    rng = np.random.default_rng(sum(shape) + 1)
    x = np.arange(shape[0], dtype=np.float32)[:, None, None]
    phi = (x - shape[0] / 2 + rng.uniform(-2.0, 2.0, size=shape)).astype(np.float32)
    phi = torch.from_numpy(phi).to(dev)
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    diag = compute_diag(cfg, phi)
    p, n = _counted(cuda_sor, cuda_sor.sor_pressure, cfg, phi, diag, b)
    assert n == 1
    want = cuda_sor.sor_pressure_plain(cfg, phi, diag, b)
    assert float(want.abs().max()) > 0.0
    assert torch.equal(p, want)
    p2, counters = cuda_sor.sor_launch(cfg, phi, diag, b)
    assert torch.equal(p2, want)
    fluid = phi < 0
    parity = sum(torch.arange(k, device=dev).reshape([-1 if i == a else 1 for i in range(3)])
                 for a, k in enumerate(shape)) % 2
    assert counters.tolist() == [int((fluid & (parity == 0)).sum()),
                                 int((fluid & (parity == 1)).sum()),
                                 2 * cfg.sor_iterations - 1]


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


def test_g2p_kernel_nan_position(dev):
    """The NaN rule: a NaN coordinate gives NaN vel' and k1, as the plain
    version does; the other particles are untouched."""
    pos, vel = _particles(dev)
    rng = np.random.default_rng(4)
    grids = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
             for s in (CFG.u_shape(), CFG.v_shape(), CFG.w_shape()) * 2]
    bad = pos.clone()
    rows = torch.tensor([0, 5, 77], device=dev)
    bad[rows, torch.tensor([0, 1, 2], device=dev)] = float("nan")
    v, k1 = cuda_g2p.g2p_flip(CFG, bad, vel, *grids, 0.97)
    wv, wk1 = cuda_g2p.g2p_flip_plain(CFG, bad, vel, *grids, 0.97)
    clean_v, clean_k1 = cuda_g2p.g2p_flip(CFG, pos, vel, *grids, 0.97)
    hit = torch.zeros(pos.shape[0], dtype=torch.bool, device=dev)
    hit[rows] = True
    for got, want, clean in ((v, wv, clean_v), (k1, wk1, clean_k1)):
        assert bool(got[hit].isnan().all()) and bool(want[hit].isnan().all())
        assert torch.equal(got[~hit], clean[~hit])
        torch.testing.assert_close(got[~hit], want[~hit], rtol=0, atol=1e-5)


def test_nan_step_on_card(dev):
    """One NaN position, two guarded steps on the card: no raise and no
    device assert, the state unhealthy, only that particle non-finite,
    every grid finite."""
    s = ft.init_state(CFG, dev)
    s.pos[5, 0] = float("nan")
    for _ in range(2):
        s, healthy = ft.step_guarded(s, 1.0 / 60.0, CFG)
        torch.cuda.synchronize()
        assert not bool(healthy)
        for name in ("pos", "vel"):
            rows = (~getattr(s, name).isfinite().all(1)).nonzero().flatten().tolist()
            assert rows == [5], name
        for name in ("u", "v", "w", "phi"):
            assert bool(getattr(s, name).isfinite().all()), name


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
    cpos = torch.zeros((N, N, N, 3), device=dev)
    for codes in ([], [0, 6], [-1]):
        with pytest.raises(ValueError, match="codes"):
            cuda_sweep.sweeps(CFG, phi, cpos, codes)
    with pytest.raises(ValueError, match="devices"):
        cuda_sor.sor_pressure(CFG, phi, phi, torch.zeros((N, N, N)))
    with pytest.raises(ValueError, match="shape"):
        cuda_sor.sor_pressure(CFG, phi, phi, torch.zeros((N, N, N + 1), device=dev))
    pcs = torch.zeros((10, 3), device=dev)
    start = torch.zeros(N**3 + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shape"):
        cuda_p2g.p2g_accumulate(CFG, pcs, pcs, start[:-1])
    with pytest.raises(ValueError, match="int32"):
        cuda_p2g.p2g_accumulate(CFG, pcs, pcs, start.long())


def _mac_grids(dev, shape, seed=0):
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
            for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]


@pytest.mark.parametrize("shape", [(12, 8, 16), (13, 9, 17), (64, 64, 64)])
def test_pack_kernel_bit_exact(dev, shape):
    grids = _mac_grids(dev, shape, seed=sum(shape))
    tab, n = _counted(cuda_pack, cuda_pack.pack_mac3_combined, *grids)
    assert n == 1
    assert torch.equal(tab, cuda_pack.pack_mac3_combined_plain(*grids))


def test_pack_wrapper_rejects_bad_arguments(dev):
    u, v, w = _mac_grids(dev, (12, 8, 16))
    with pytest.raises(ValueError, match="float32"):
        cuda_pack.pack_mac3_combined(u.double(), v, w)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pack.pack_mac3_combined(u, v, w.permute(2, 1, 0).contiguous().permute(2, 1, 0))
    with pytest.raises(ValueError, match="devices"):
        cuda_pack.pack_mac3_combined(u, v.cpu(), w)


def test_step_on_card_matches_cpu(dev):
    s = ft.init_state(CFG, "cpu")
    for _ in range(2):
        s = ft.step(s, 1.0 / 60.0, CFG)
    cpu = ft.step(s, 1.0 / 60.0, CFG)
    card = ft.step(s.to(dev), 1.0 / 60.0, CFG)
    for name in ("pos", "vel", "u", "v", "w", "phi", "k1"):
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(cpu, name),
                                   rtol=0, atol=1e-4)
