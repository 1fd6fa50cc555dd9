"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA card. On a machine with one
(and nvcc), run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Inputs are made on the CPU at 32^3 and carried to the card. The
27-neighbourhood pass, the sweeps, the SOR and the FLIP gather are compiled
with -fmad=false and must match bit for bit, also at shapes that break
their tiles (13x9x17, 20x12x24, 8x8x200, whose z-lines are longer than six
of the sweeps' chunks, and 64^3): the pass with exact distance ties,
one-ulp near-ties, candidates at a cell's centre and all-FAR regions; the
FLIP gather with queries past every edge, 3,000 particles in one cell, NaN
particles in the CSR's tail slots and a last block partly empty. The P2G
kernel sums in another order than index_add_ (validity equal, rtol = atol
= 2e-4 on valid faces), at ppc 1 and at ppc 2, at those odd shapes (ragged
cell tiles) and with 3,000 particles in one cell (a halo walked in chunks).
P2G, the pass and the FLIP gather launched twice give equal bits. A state
with one NaN position steps twice on the card without a raise (the NaN
rule). The combined-key pack (pure copies) must equal its plain version
bit for bit (int32 views) at shapes past every ragged edge of its tiles, at
64^3 and at 128^3, also with NaN, +-inf and -0.0 next to its zero halo, and
two launches must give the same bits. The renderer (plain PyTorch, no hand
kernel) gives the CPU's 32^3 frame on the card. An APIC step (its P2G the
kernel of tests/test_torch_apic_kernel.py, summing in another order than
the CPU) stays within phase A's bound of the CPU's, and launches the pass,
the sweeps, the APIC P2G and the SOR once each, the RK3 gather twice
(tests/test_torch_interp_kernel.py) and no other kernel. The 2D
projection's SOR runs the same kernel on (nx, ny, 1) views
with the 2D omega and 120 iterations, bit for bit the plain version; a 2D
step (FLIP and APIC) on the card stays within the APIC bound of the CPU's
and launches the SOR once and no other kernel.
"""

import numpy as np
import pytest
import torch

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core import cuda_pack
from fluidsimulation_tpu_torch.core.interp import interp_mac3_vec
from fluidsimulation_tpu_torch.core.seeding import noise_grids
from fluidsimulation_tpu_torch.ops import (
    cuda_g2p,
    cuda_interp,
    cuda_p2g,
    cuda_p2g_apic,
    cuda_seed,
    cuda_sor,
    cuda_sweep,
)
from fluidsimulation_tpu_torch.ops.binning import build_csr, build_csr_cells, sort_particles
from fluidsimulation_tpu_torch.ops.flip import flip_update_carry
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
    vel = interp_mac3_vec(*grids, s.pos * N)
    return s.pos.to(dev), vel.to(dev)


def _same(a, b):
    """Equal values, NaN where the other has NaN (NaN bits may differ)."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def _counted(module, fn, *args):
    before = module.KERNEL.launches
    out = fn(*args)
    torch.cuda.synchronize()
    return out, module.KERNEL.launches - before


def _own_cell(cfg, pos):
    csr = build_csr(cfg, pos)
    return seed_own_cell(cfg, csr, (pos * N)[csr.order])


def test_seed_and_sweep_kernels_bit_exact(dev):
    pos, _ = _particles(dev)
    cpos0 = _own_cell(CFG, pos)
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
        CFG, *cuda_seed.neighborhood_pass(CFG, _own_cell(CFG, pos)))[0]
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


def _g2p_args(cfg, pos, vel, seed):
    """The FLIP gather's arguments for these particles: the CSR order, the
    sorted positions and velocities, normal new and old grids, beta. The
    order is that of the positions clamped into the grid (the CSR index
    takes positions inside it), so queries past its edges keep theirs."""
    rng = np.random.default_rng(seed)
    dev = pos.device
    grids = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
             for s in (cfg.u_shape(), cfg.v_shape(), cfg.w_shape()) * 2]
    m = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.float32, device=dev)
    order = build_csr(cfg, torch.minimum(pos.clamp(min=0.0), 1.0 - 0.6 / m)).order
    pcs = (pos * m)[order]
    return (cfg, order, pcs, vel[order], *grids, 0.97)


def _g2p_equal(args):
    """The kernel (one launch) against the plain version, bit for bit, and
    a second launch against the first."""
    got, n = _counted(cuda_g2p, cuda_g2p.g2p_flip, *args)
    assert n == 1
    want = cuda_g2p.g2p_flip_plain(*args)
    again = cuda_g2p.g2p_flip(*args)
    for g, w, a in zip(got, want, again):
        assert _same(g, w) and _same(g, a)
    return got


def test_g2p_kernel_matches_plain(dev):
    pos, vel = _particles(dev)
    # Queries past every edge reach the clamps and top-edge decrements.
    pos = torch.cat([pos, torch.tensor([[-0.1, 1.1, 0.5], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]],
                                       device=dev)])
    vel = torch.cat([vel, torch.ones(3, 3, device=dev)])
    _g2p_equal(_g2p_args(CFG, pos, vel, 2))


def test_g2p_kernel_nan_position(dev):
    """The NaN rule: a NaN coordinate gives NaN vel' and k1, as the plain
    version does; such particles sit in the slots past start[ncell]; the
    other particles' outputs are those of the same call without the NaN."""
    pos, vel = _particles(dev)
    bad = pos.clone()
    rows = torch.tensor([0, 5, 77], device=dev)
    bad[rows, torch.tensor([0, 1, 2], device=dev)] = float("nan")
    args = _g2p_args(CFG, bad, vel, 4)
    start = build_csr(CFG, bad).start
    assert int(start[-1]) == pos.shape[0] - 3
    v, k1 = _g2p_equal(args)
    clean_v, clean_k1 = cuda_g2p.g2p_flip(*_g2p_args(CFG, pos, vel, 4))
    hit = torch.zeros(pos.shape[0], dtype=torch.bool, device=dev)
    hit[rows] = True
    for got, clean in ((v, clean_v), (k1, clean_k1)):
        assert bool(got[hit].isnan().all())
        assert torch.equal(got[~hit], clean[~hit])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_g2p_kernel_at_shapes(dev, shape):
    """Particles over and past the clamp box, 3,000 crammed into one cell,
    two with a NaN coordinate (the tail slots), and a count that leaves the
    last block of 256 partly empty: bit for bit the plain version."""
    cfg = _shape_cfg(shape)
    rng = np.random.default_rng(sum(shape) + 2)
    m = np.array(shape, dtype=np.float32)
    n = 2 * int(np.prod(shape)) + 101
    pos = rng.uniform(-1.0 / m, 1.0 + 1.0 / m, size=(n, 3)).astype(np.float32)
    pile = ((np.floor(m / 2) + rng.uniform(-0.45, 0.45, size=(3000, 3))) / m).astype(np.float32)
    pos = np.concatenate([pos, pile])
    pos[[7, n + 11], [1, 2]] = np.nan
    assert pos.shape[0] % 256 != 0
    pos = torch.from_numpy(pos).to(dev)
    vel = torch.from_numpy(rng.standard_normal(tuple(pos.shape)).astype(np.float32)).to(dev)
    args = _g2p_args(cfg, pos, vel, sum(shape))
    v, k1 = _g2p_equal(args)
    assert int((v.isnan().any(1) & k1.isnan().any(1)).sum()) == 2


def test_flip_update_carry_forms_no_diff_grids(dev):
    """With the step's sorted particles, the FLIP update is one kernel
    launch and allocates one (N, 6) array, vel' and k1, and nothing else: no
    du, dv, dw grids; without them it builds the CSR index itself, to the
    same bits."""
    pos, vel = _particles(dev)
    rng = np.random.default_rng(6)
    grids = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
             for s in (CFG.u_shape(), CFG.v_shape(), CFG.w_shape()) * 2]
    walk = sort_particles(CFG, build_csr(CFG, pos), pos, vel)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    got, n = _counted(cuda_g2p, flip_update_carry, CFG, pos, vel, *grids, 0.03, walk)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1
    assert n == 1
    again = flip_update_carry(CFG, pos, vel, *grids, 0.03)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _seed_candidates(shape, seed, lattice=False):
    """Candidates in half the cells, FAR elsewhere and in the whole first
    third along x. With ``lattice``, each candidate lies at its cell centre
    plus -0.25, 0 or 0.25 on each axis, so many cells see exact distance
    ties, some see a candidate at their centre, and a fifth of the
    candidates are moved by one float step (near-ties); without, anywhere
    in its cell."""
    rng = np.random.default_rng(seed)
    centres = np.stack(np.meshgrid(*(np.arange(k, dtype=np.float32) for k in shape),
                                   indexing="ij"), axis=-1)
    if lattice:
        off = rng.choice(np.array([-0.25, 0.0, 0.25], dtype=np.float32), size=(*shape, 3))
    else:
        off = rng.uniform(-0.5, 0.5, size=(*shape, 3)).astype(np.float32)
    cpos = (centres + off).astype(np.float32)
    if lattice:
        # One coordinate of a fifth of them a float step up: distances that
        # differ from a tie in the last bits (near-ties).
        step = rng.random(shape) < 0.2
        cpos[..., 0] = np.where(step, np.nextafter(cpos[..., 0], np.float32(np.inf)),
                                cpos[..., 0])
    cpos[rng.random(shape) > 0.5] = cuda_seed.FAR
    cpos[: max(1, shape[0] // 3)] = cuda_seed.FAR
    return torch.from_numpy(cpos.astype(np.float32))


def _exact_ties(cfg, cpos0):
    """Cells whose best distance is reached by two different real
    candidates among their 27 neighbours."""
    pad = torch.nn.functional.pad(cpos0, (0, 0, 1, 1, 1, 1, 1, 1), value=cuda_seed.FAR)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    axes = [torch.arange(k, dtype=torch.float32) for k in (nx, ny, nz)]
    c = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    cands = torch.stack([pad[1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny, 1 + dz:1 + dz + nz]
                         for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)])
    d = cuda_seed.dist(*cands.unbind(-1), *c.unbind(-1)) - cfg.particle_radius
    at_best = (d == d.min(0).values) & (cands[..., 0] < 1.0e8)
    hi = torch.where(at_best[..., None], cands, -torch.inf).amax(0)
    lo = torch.where(at_best[..., None], cands, torch.inf).amin(0)
    return int(((hi != lo).any(-1) & at_best.any(0)).sum())


@pytest.mark.parametrize("lattice", [False, True], ids=["uniform", "exact_ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_seed_kernel_bit_exact_at_shapes(dev, shape, lattice):
    """Ragged tiles, a third of the grid all FAR, and (lattice) exact
    distance ties between different candidates: one launch, bit for bit
    the plain version, and a second launch equal to the first."""
    cfg = _shape_cfg(shape)
    cpos0 = _seed_candidates(shape, sum(shape), lattice)
    if lattice:
        assert _exact_ties(cfg, cpos0) > 10
    cpos0 = cpos0.to(dev)
    (phi, cpos), n = _counted(cuda_seed, cuda_seed.neighborhood_pass, cfg, cpos0)
    assert n == 1
    want = cuda_seed.neighborhood_pass_plain(cfg, cpos0)
    again = cuda_seed.neighborhood_pass(cfg, cpos0)
    assert torch.equal(phi, want[0]) and torch.equal(cpos, want[1])
    assert torch.equal(phi, again[0]) and torch.equal(cpos, again[1])


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
    order = torch.arange(10, device=dev)
    grids = [torch.zeros(s, device=dev) for s in (CFG.u_shape(), CFG.v_shape(), CFG.w_shape())]
    with pytest.raises(ValueError, match="int64"):
        cuda_g2p.g2p_flip(CFG, order.int(), pcs, pcs, *grids, *grids, 0.97)
    with pytest.raises(ValueError, match="shape"):
        cuda_g2p.g2p_flip(CFG, order[:-1], pcs, pcs, *grids, *grids, 0.97)
    with pytest.raises(ValueError, match="shape"):
        cuda_g2p.g2p_flip(CFG, order, pcs, pcs, *grids, grids[1], *grids[1:], 0.97)
    with pytest.raises(ValueError, match="devices"):
        cuda_g2p.g2p_flip(CFG, order, pcs, pcs.cpu(), *grids, *grids, 0.97)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_g2p.g2p_flip(CFG, order, torch.zeros((3, 10), device=dev).t(), pcs, *grids, *grids,
                          0.97)


# Bits that a copy must keep: quiet NaN, a negative NaN with a payload,
# +inf, -inf and -0.0.
SPECIAL_BITS = np.array([0x7FC00000, 0xFFC12345, 0x7F800000, 0xFF800000, 0x80000000],
                        dtype=np.uint32)


def _mac_grids(dev, shape, seed=0, special=False):
    """Unit-normal MAC grids; with ``special``, the first and last layer
    along every axis (the faces next to the pack's zero halo, and the z
    ends) hold NaN, +-inf and -0.0."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    grids = [rng.standard_normal(s).astype(np.float32)
             for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    for g in grids if special else ():
        for axis in range(3):
            for end in (0, -1):
                face = [slice(None)] * 3
                face[axis] = end
                pick = rng.integers(0, len(SPECIAL_BITS), size=g[tuple(face)].shape)
                g[tuple(face)] = SPECIAL_BITS[pick].view(np.float32)
    return [torch.from_numpy(g).to(dev) for g in grids]


def _bits(t):
    return t.view(torch.int32)


# Shapes past every ragged edge of the kernel's tiles (8 rows along y, up to
# 128 along z): one row; nz = 2; odd ny and nz; nz past one z chunk; the
# demo's and the main path's grids.
PACK_SHAPES = [(12, 8, 16), (1, 1, 2), (3, 5, 2), (13, 9, 17), (7, 13, 300), (64, 64, 64),
               (128, 128, 128)]


@pytest.mark.parametrize("special", [False, True], ids=["normal", "nan_inf_negzero"])
@pytest.mark.parametrize("shape", PACK_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_pack_kernel_bit_exact(dev, shape, special):
    """One launch; the plain pack's bits (int32 views, so NaN payloads and
    -0.0 count); a second launch gives the same bits."""
    grids = _mac_grids(dev, shape, seed=sum(shape), special=special)
    tab, n = _counted(cuda_pack, cuda_pack.pack_mac3_combined, *grids)
    assert n == 1
    assert torch.equal(_bits(tab), _bits(cuda_pack.pack_mac3_combined_plain(*grids)))
    assert torch.equal(_bits(tab), _bits(cuda_pack.pack_mac3_combined(*grids)))


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


@pytest.mark.parametrize("kw", [dict(), dict(band_rows=25, band_cols=33, return_t=True),
                                dict(bounces=1, overstep=1.5, sphere_trace=False)],
                         ids=["default", "tiles_return_t", "bounces1_overstep"])
def test_render_on_card_matches_cpu(dev, kw):
    """The renderer (plain PyTorch) on the card against the CPU on a 32^3
    state stepped three times on the CPU, at 80x60: within 1e-6 outside the
    quirk pixels (sqrt and the transcendentals go through float64 on both),
    the march ts too."""
    from fluidsimulation_tpu_torch.render import raytrace
    from fluidsimulation_tpu_torch.render.camera import OrbitCamera

    s = ft.init_state(CFG, "cpu")
    for _ in range(3):
        s = ft.step(s, 1.0 / 60.0, CFG)
    cam = OrbitCamera().frame(80, 60)
    cpu = raytrace.render_frame(s.phi, *cam, width=80, height=60, **kw)
    card = raytrace.render_frame(s.phi.to(dev), *cam, width=80, height=60, **kw)
    if kw.get("return_t"):
        (cpu, t_cpu), (card, t_card) = cpu, card
        torch.testing.assert_close(t_card.cpu(), t_cpu, rtol=0, atol=1e-6)
    assert card.device.type == "cuda"
    keep = ~raytrace.quirk_pixels(*cam, 80, 60)
    torch.testing.assert_close(card.cpu()[keep], cpu[keep], rtol=0, atol=1e-6)


def _apic_close(card, cpu, cfg):
    """The APIC card-vs-CPU bound (tests/test_torch_parallel.py holds the
    card's multi-rank APIC step to it too): 1e-4 abs, and for C that bound
    carried through G2P's lever (2 m x 1e-4): P2G sums each face in another
    order on the card than on the CPU."""
    for name in ("pos", "vel", "C", "u", "v", "w", "phi"):
        atol = 2 * cfg.nx * 1e-4 if name == "C" else 1e-4
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(cpu, name), rtol=0,
                                   atol=atol, msg=name)


def test_apic_step_on_card_matches_cpu(dev):
    """A 32^3 APIC step on the card against the same step on the CPU, from
    a state stepped twice on the CPU."""
    s = ft.init_apic_state(CFG, "cpu")
    for _ in range(2):
        s = ft.step_apic(s, 1.0 / 60.0, CFG)
    cpu = ft.step_apic(s, 1.0 / 60.0, CFG)
    card = ft.step_apic(s.to(dev), 1.0 / 60.0, CFG)
    _apic_close(card, cpu, CFG)


def test_apic_step_launches(dev):
    """One APIC step launches the 27-neighbourhood pass, the sweeps, the
    APIC P2G and the SOR once each, the RK3 gather twice (stages 2 and 3),
    and never the FLIP P2G, the FLIP gather or the pack (its G2P is plain
    PyTorch)."""
    s = ft.init_apic_state(CFG, dev)
    s = ft.step_apic(s, 1.0 / 60.0, CFG)
    modules = (cuda_seed, cuda_sweep, cuda_p2g_apic, cuda_sor, cuda_interp, cuda_p2g, cuda_g2p,
               cuda_pack)
    before = [m.KERNEL.launches for m in modules]
    ft.step_apic(s, 1.0 / 60.0, CFG)
    torch.cuda.synchronize()
    assert [m.KERNEL.launches - b for m, b in zip(modules, before)] == [1, 1, 1, 1, 2, 0, 0, 0]


@pytest.mark.parametrize("shape", [(13, 9), (64, 64), (512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sor_kernel_bit_exact_2d(dev, shape):
    """The SOR at (nx, ny, 1) with SimConfig2D's omega and 120 iterations on
    a noisy slab of fluid and a noise RHS: one launch, bit for bit the
    plain version; the counters hold each colour's fluid cells and 239
    grid barriers."""
    from fluidsimulation_tpu_torch.solver.step2d import compute_diag2d, project

    cfg = ft.SimConfig2D(nx=shape[0], ny=shape[1], cells_per_meter=float(shape[0]))
    rng = np.random.default_rng(sum(shape) + 2)
    x = np.arange(shape[0], dtype=np.float32)[:, None, None]
    phi = (x - shape[0] / 2 + rng.uniform(-2.0, 2.0, size=(*shape, 1))).astype(np.float32)
    phi = torch.from_numpy(phi).to(dev)
    b = torch.from_numpy(rng.standard_normal((*shape, 1)).astype(np.float32)).to(dev)
    diag = compute_diag2d(cfg, phi[..., 0])[..., None]
    p, n = _counted(cuda_sor, cuda_sor.sor_pressure, cfg, phi, diag, b)
    assert n == 1
    want = cuda_sor.sor_pressure_plain(cfg, phi, diag, b)
    assert float(want.abs().max()) > 0.0
    assert torch.equal(p, want)
    again, counters = cuda_sor.sor_launch(cfg, phi, diag, b)
    assert torch.equal(again, want)
    fluid = (phi < 0)[..., 0]
    parity = (torch.arange(shape[0], device=dev)[:, None]
              + torch.arange(shape[1], device=dev)[None, :]) % 2
    assert counters.tolist() == [int((fluid & (parity == 0)).sum()),
                                 int((fluid & (parity == 1)).sum()), 2 * 120 - 1]
    # The projection's own call: one launch, at its (nx, ny, 1) views.
    u = torch.zeros((shape[0] + 1, shape[1]), device=dev)
    v = torch.zeros((shape[0], shape[1] + 1), device=dev)
    _, n = _counted(cuda_sor, project, cfg, u, v, phi[..., 0], 0.01)
    assert n == 1


@pytest.mark.parametrize("apic", [False, True], ids=["flip", "apic"])
def test_2d_step_on_card_matches_cpu(dev, apic):
    """A 32^2 state stepped twice on the CPU, then one step on the card and
    on the CPU: within 1e-4 abs, C within 2 m x 1e-4 (P2G's index_add_ sums
    by atomics on the card); the card step launches the SOR once and no
    other kernel."""
    cfg = ft.SimConfig2D(nx=N, ny=N, cells_per_meter=float(N))
    init, step = (ft.init_apic_state2d, ft.step_apic2d) if apic else (ft.init_state2d, ft.step2d)
    s = init(cfg, "cpu")
    for _ in range(2):
        s = step(s, 1.0 / 120.0, cfg)
    cpu = step(s, 1.0 / 120.0, cfg)
    modules = (cuda_seed, cuda_sweep, cuda_sor, cuda_p2g, cuda_g2p, cuda_pack, cuda_interp)
    before = [m.KERNEL.launches for m in modules]
    card = step(s.to(dev), 1.0 / 120.0, cfg)
    torch.cuda.synchronize()
    assert [m.KERNEL.launches - b for m, b in zip(modules, before)] == [0, 0, 1, 0, 0, 0, 0]
    for name in ("pos", "vel", "C", "u", "v", "phi") if apic else ("pos", "vel", "u", "v", "phi"):
        atol = 2 * cfg.nx * 1e-4 if name == "C" else 1e-4
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(cpu, name), rtol=0,
                                   atol=atol, msg=name)


# -- the slab entries of the multi-rank family (parallel/) -------------------

def _slabs(shape):
    """x-slab count: 4 where it divides nx, else one plane a slab."""
    return 4 if shape[0] % 4 == 0 else shape[0]


def _sweep_inputs(shape, seed):
    cfg = _shape_cfg(shape)
    rng = np.random.default_rng(seed)
    cpos = rng.uniform(-2.0, max(shape) + 2.0, size=(*shape, 3)).astype(np.float32)
    cpos[rng.random(shape) > 0.3] = 1.0e9
    cpos = torch.from_numpy(cpos)
    axes = [torch.arange(n, dtype=torch.float32) for n in shape]
    centers = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    phi = cuda_seed.dist(*cpos.unbind(-1), *centers.unbind(-1)) - cfg.particle_radius
    return cfg, phi, cpos


@pytest.mark.parametrize("carry", [False, True], ids=["edge", "carried"])
@pytest.mark.parametrize("reverse", [False, True], ids=["Xm", "Xp"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sweep_x_carry_kernel_bit_exact(dev, shape, reverse, carry):
    """fst_sweep_x_carry on a slab at x origin 5, with and without an
    incoming plane (random candidates, FAR in part): phi, cpos and the
    outgoing plane bit for bit the plain version, one launch."""
    cfg, phi, cpos = _sweep_inputs(shape, sum(shape) + 7)
    rng = np.random.default_rng(3)
    plane = None
    if carry:
        plane = rng.uniform(-2.0, max(shape) + 2.0, size=(*shape[1:], 3)).astype(np.float32)
        plane[rng.random(shape[1:]) > 0.5] = 1.0e9
        plane = torch.from_numpy(plane).to(dev)
    phi, cpos = phi.to(dev), cpos.to(dev)
    before = cuda_sweep.CARRY_KERNEL.launches
    got = cuda_sweep.sweep_x_carry(cfg, phi, cpos, reverse, plane, 5)
    torch.cuda.synchronize()
    assert cuda_sweep.CARRY_KERNEL.launches - before == 1
    want = cuda_sweep.sweep_x_carry_plain(cfg, phi, cpos, reverse, plane, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sweep_x_relay_equals_fst_sweeps(dev, shape):
    """The x-sweeps of SWEEP_ORDER relayed over x-slabs (each slab's sweep,
    at its x origin, continuing its neighbour's carry plane) give the whole
    grid's fst_sweeps bit for bit; and the y/z sweeps of each slab at its
    origin are the whole grid's."""
    cfg, phi, cpos = _sweep_inputs(shape, sum(shape) + 11)
    phi, cpos = phi.to(dev), cpos.to(dev)
    d = _slabs(shape)
    sx = shape[0] // d
    xs = [c for c in cuda_sweep.SWEEP_ORDER if cuda_sweep.CODE[c][0] == 0]
    want = cuda_sweep.sweeps(cfg, phi, cpos, xs)
    slab_phi = [phi[k * sx:(k + 1) * sx].contiguous() for k in range(d)]
    slab_cpos = [cpos[k * sx:(k + 1) * sx].contiguous() for k in range(d)]
    for code in xs:
        reverse = cuda_sweep.CODE[code][1]
        carry = None
        for k in (range(d - 1, -1, -1) if reverse else range(d)):
            slab_phi[k], slab_cpos[k], carry = cuda_sweep.sweep_x_carry(
                cfg, slab_phi[k], slab_cpos[k], reverse, carry, k * sx)
    assert torch.equal(torch.cat(slab_phi), want[0])
    assert torch.equal(torch.cat(slab_cpos), want[1])
    yz = [c for c in cuda_sweep.SWEEP_ORDER if cuda_sweep.CODE[c][0] != 0]
    want = cuda_sweep.sweeps(cfg, phi, cpos, yz)
    local = ft.SimConfig(nx=sx, ny=shape[1], nz=shape[2], cells_per_meter=float(shape[0]))
    got = [cuda_sweep.sweeps(local, phi[k * sx:(k + 1) * sx].contiguous(),
                             cpos[k * sx:(k + 1) * sx].contiguous(), yz, k * sx)
           for k in range(d)]
    assert torch.equal(torch.cat([g[0] for g in got]), want[0])
    assert torch.equal(torch.cat([g[1] for g in got]), want[1])


@pytest.mark.parametrize("cfg", [CFG, CFG2], ids=["ppc1", "ppc2"])
def test_p2g_kernel_on_slabs_is_the_whole_grid(dev, cfg):
    """P2G on x-slabs grown by a cell each side (the multi-rank step's
    extended slabs, positions in the domain's frame, the kernel given the
    slab's origin): each slab's own faces are the whole grid's bit for bit
    (the same particles reach them in the same order)."""
    pos, vel = _particles(dev, cfg)
    m = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.float32, device=dev)
    csr = build_csr(cfg, pos)
    walk = sort_particles(cfg, csr, pos, vel)
    whole = cuda_p2g.p2g_accumulate(cfg, walk.pcs, walk.vels, csr.start)
    d, sx = 4, cfg.nx // 4
    pc = pos * m
    cell = torch.floor(pc[:, 0] + 0.5)
    for k in range(d):
        lo, hi = min(1, k * sx), min(1, cfg.nx - (k + 1) * sx)
        x0 = k * sx - lo
        ext = ft.SimConfig(nx=lo + sx + hi, ny=cfg.ny, nz=cfg.nz, cells_per_meter=float(cfg.nx))
        sel = torch.nonzero((cell >= x0) & (cell < x0 + ext.nx)).squeeze(1)
        scsr = build_csr_cells(ext, pc[sel], x0)
        before = cuda_p2g.KERNEL.launches
        got = cuda_p2g.p2g_accumulate(ext, pc[sel][scsr.order], vel[sel][scsr.order],
                                      scsr.start, x0)
        torch.cuda.synchronize()
        assert cuda_p2g.KERNEL.launches - before == 1
        for a, ((acc, amt), (wacc, wamt)) in enumerate(zip(got, whole)):
            own = slice(lo + (a == 0), lo + sx + (a == 0))  # u: faces x0+1 .. x0+sx
            at = slice(k * sx + (a == 0), (k + 1) * sx + (a == 0))
            assert torch.equal(acc[own], wacc[at]) and torch.equal(amt[own], wamt[at])


def _sor_slab_inputs(shape, dev):
    cfg = _shape_cfg(shape)
    rng = np.random.default_rng(sum(shape) + 1)
    x = np.arange(shape[0], dtype=np.float32)[:, None, None]
    phi = (x - shape[0] / 2 + rng.uniform(-2.0, 2.0, size=shape)).astype(np.float32)
    phi = torch.from_numpy(phi).to(dev)
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    return cfg, phi, compute_diag(cfg, phi), b


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sor_half_kernel_bit_exact(dev, shape, color):
    """fst_sor_half on the second x-slab of a grid, random p and halo planes
    (phi's halos in part fluid): one launch, in place, bit for bit the
    plain version."""
    cfg, phi, diag, b = _sor_slab_inputs(shape, dev)
    d = _slabs(shape)
    sx = shape[0] // d
    k = min(1, d - 1)
    sl = slice(k * sx, (k + 1) * sx)
    rng = np.random.default_rng(color)
    p = torch.from_numpy(rng.standard_normal((sx, *shape[1:])).astype(np.float32)).to(dev)
    planes = [torch.from_numpy(rng.standard_normal(shape[1:]).astype(np.float32)).to(dev)
              for _ in range(4)]
    args = (phi[sl].contiguous(), planes[2], planes[3], diag[sl].contiguous(),
            b[sl].contiguous(), k * sx, color)
    want = cuda_sor.sor_half_plain(cfg, p.clone(), planes[0], planes[1], *args)
    got = p.clone()
    before = cuda_sor.HALF_KERNEL.launches
    out = cuda_sor.sor_half(cfg, got, planes[0], planes[1], *args)
    torch.cuda.synchronize()
    assert cuda_sor.HALF_KERNEL.launches - before == 1
    assert out is got and not torch.equal(got, p)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sor_halves_with_exchange_match_fst_sor(dev, shape):
    """The solve as the ranks run it: x-slabs, 2 x 100 launches of
    fst_sor_half with the boundary planes of p swapped between slabs before
    each, against fst_sor on the whole grid: within 1e-5 (it is bit for bit
    the same arithmetic, so equal)."""
    cfg, phi, diag, b = _sor_slab_inputs(shape, dev)
    d = _slabs(shape)
    sx = shape[0] // d
    want = cuda_sor.sor_pressure(cfg, phi, diag, b)
    cut = [slice(k * sx, (k + 1) * sx) for k in range(d)]
    zero = torch.zeros(shape[1:], device=dev)
    phis = [phi[c].contiguous() for c in cut]
    lo = [zero] + [phis[k - 1][-1] for k in range(1, d)]
    hi = [phis[k + 1][0] for k in range(d - 1)] + [zero]
    ps = [torch.zeros_like(t) for t in phis]
    before = cuda_sor.HALF_KERNEL.launches
    for _ in range(cfg.sor_iterations):
        for color in (0, 1):
            p_lo = [zero] + [ps[k - 1][-1].clone() for k in range(1, d)]
            p_hi = [ps[k + 1][0].clone() for k in range(d - 1)] + [zero]
            for k in range(d):
                cuda_sor.sor_half(cfg, ps[k], p_lo[k], p_hi[k], phis[k], lo[k], hi[k],
                                  diag[cut[k]].contiguous(), b[cut[k]].contiguous(), k * sx,
                                  color)
    torch.cuda.synchronize()
    assert cuda_sor.HALF_KERNEL.launches - before == 2 * cfg.sor_iterations * d
    got = torch.cat(ps)
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got, want)
