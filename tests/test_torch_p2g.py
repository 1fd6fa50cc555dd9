"""PyTorch port vs the JAX package: P2G over the CSR index.

On the CPU ``p2g_from_csr`` runs the plain version of the P2G kernel
(ops/cuda_p2g.py). It is held to the JAX Pallas supercell kernel (interpret
mode) and to the JAX scatter form on the inputs of
tests/test_pallas_p2g_super.py, plain and with a crammed cell that
overflows the JAX slot table. Bound: validity equal, except where the
weight sum lies within 1e-6 of zero_thresh (summation order may flip it);
rtol = atol = 2e-4 on valid faces, the JAX file's own bound."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.seeding import dam_break_particles, noise_grids
from fluidsimulation_tpu.ops import p2g as jax_p2g
from fluidsimulation_tpu.ops import pallas_p2g_super as pps
from fluidsimulation_tpu.ops import supertable as st
from fluidsimulation_tpu.reference import solver3d

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import cuda_p2g
from fluidsimulation_tpu_torch.ops.binning import build_csr, sort_particles
from fluidsimulation_tpu_torch.ops.p2g import p2g_from_csr, transfer_to_grid

N = 16
KW = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N), particles_per_cell_axis=1)
CFG, JCFG = ft.SimConfig(**KW), JaxConfig(**KW)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _seeded(seed, cram):
    """As tests/test_pallas_p2g_super.py::_seeded: dam-break positions,
    optionally ``cram`` of them packed into one cell, with velocities
    sampled from noise grids."""
    pos, _ = dam_break_particles(JCFG)
    u, v, w = noise_grids(JCFG, seed=seed)
    p = np.asarray(pos).copy()
    if cram:
        rng = np.random.default_rng(5)
        p[:cram] = (8.0 + rng.uniform(-0.45, 0.45, size=(cram, 3))) / 16.0
    vel = np.stack(
        solver3d.interp_mac(u, v, w, N * p[:, 0], N * p[:, 1], N * p[:, 2]), axis=-1
    ).astype(np.float32)
    return p, vel


def _check(got, amts, want):
    """got: the port's (u, v, w, masks); amts: its weight sums."""
    for i in range(3):
        g_valid = got[3 + i].numpy()
        w_valid = np.asarray(want[3 + i])
        near = np.abs(amts[i].numpy() - CFG.zero_thresh) < 1e-6
        flips = g_valid != w_valid
        assert not (flips & ~near).any(), f"component {i}: validity differs"
        both = g_valid & w_valid
        np.testing.assert_allclose(
            got[i].numpy()[both], np.asarray(want[i])[both], rtol=2e-4, atol=2e-4
        )


@pytest.mark.parametrize("seed,cram", [(7, 0), (9, 3 * 8)], ids=["plain", "crammed_overflow"])
def test_p2g_from_csr_matches_jax(seed, cram):
    pos, vel = _seeded(seed, cram)
    tp, tv = torch.from_numpy(pos), torch.from_numpy(vel)
    csr = build_csr(CFG, tp)
    walk = sort_particles(CFG, csr, tp, tv)
    got = p2g_from_csr(CFG, csr, walk.pcs, walk.vels)
    amts = [amt for _, amt in cuda_p2g.p2g_accumulate_plain(CFG, tp * N, tv)]

    jp, jv = jnp.asarray(pos), jnp.asarray(vel)
    table = st.build_super_table(JCFG, jp, jv)
    if cram:
        assert int(table.n_overflow) > 0
    _check(got, amts, pps.p2g_from_super_pallas(JCFG, table, jp, jv))
    _check(got, amts, jax_p2g.transfer_to_grid(JCFG, jp, jv))
    _check(transfer_to_grid(CFG, tp, tv), amts, jax_p2g.transfer_to_grid(JCFG, jp, jv))


def test_p2g_gather_window_covers_every_face():
    """The gather kernel visits, for a face f, the cells {f-1, f} on the
    component's axis and {f-1, f, f+1} on the others. Every particle the
    scatter form deposits to a face lies in that window."""
    pos, vel = _seeded(7, 0)
    pc = torch.from_numpy(pos) * N
    accs = cuda_p2g.p2g_accumulate_plain(CFG, pc, torch.from_numpy(vel))
    cell = torch.floor(pc + 0.5).long()
    for a, (_, amt) in enumerate(accs):
        # Both faces a particle deposits to, per axis, hold its cell in
        # their window.
        for f_axis in range(3):
            c = pc[:, f_axis] + (0.5 if f_axis == a else 0.0)
            base = torch.floor(c).long()
            for face in (base, base + 1):
                lo = face - 1
                hi = face if f_axis == a else face + 1
                assert bool(((cell[:, f_axis] >= lo) & (cell[:, f_axis] <= hi)).all())
        # No deposit falls off the grid: each particle's weights sum to 1.
        assert float(amt.sum()) == pytest.approx(pos.shape[0], rel=1e-5)




def test_p2g_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper gives the plain version, bit for bit,
    and launches nothing."""
    pos, vel = _seeded(7, 0)
    tp, tv = torch.from_numpy(pos) * N, torch.from_numpy(vel)
    csr = build_csr(CFG, torch.from_numpy(pos))
    before = cuda_p2g.KERNEL.launches
    want = cuda_p2g.p2g_accumulate_plain(CFG, tp[csr.order], tv[csr.order])
    got = cuda_p2g.p2g_accumulate(CFG, tp[csr.order], tv[csr.order], csr.start)
    for (a, m), (aw, mw) in zip(got, want):
        assert torch.equal(a, aw) and torch.equal(m, mw)
    assert cuda_p2g.KERNEL.launches == before


def test_walk_stats_counts_the_walk():
    """utils/kernel_times.py::walk_stats against a direct count on a small
    grid with one heavy cell: the most particles in a cell, the 27-cell walks
    and the share of warp steps that are work."""
    from fluidsimulation_tpu_torch.utils.kernel_times import walk_stats

    nx, ny, nz = 3, 4, 40
    cfg = ft.SimConfig(nx=nx, ny=ny, nz=nz, cells_per_meter=float(nx))
    counts = np.random.default_rng(1).integers(0, 3, size=(nx, ny, nz))
    counts[1, 2, 5] = 50
    start = torch.zeros(nx * ny * nz + 1, dtype=torch.int32)
    start[1:] = torch.from_numpy(np.cumsum(counts.ravel()))
    pad = np.pad(counts, 1)
    walk = np.zeros((nx, ny, nz))
    useful = steps = 0
    for dx in range(3):
        for dy in range(3):
            run = sum(pad[dx:dx + nx, dy:dy + ny, dz:dz + nz] for dz in range(3))
            walk += run
            useful += run.sum()
            for z0 in range(0, nz, 32):
                steps += run[:, :, z0:z0 + 32].max(axis=2).sum()
    got = walk_stats(cfg, start)
    assert got["cell_max_particles"] == 50
    assert got["walk_max_particles"] == walk.max()
    assert got["walk_mean_particles"] == pytest.approx(walk[walk > 0].mean())
    assert got["warp_step_efficiency"] == pytest.approx(useful / (32 * steps))
