"""The multi-rank 3D step: x-slab grids, explicit halo exchanges, a
particle slab exchange by all-gather, and a relay for the x-sweeps.

Port of fluidsimulation_tpu/parallel/halo_step.py (``make_halo_step``,
``shard_state_x``), where one shard_map runs the step on every device of a
mesh. Here each rank is a process (parallel/comm.py) and runs the step on
its own slab, calling the exchanges where JAX has its collectives:

  * 3 all-gathers of the MAC grids before advection, 2 of the particle
    blocks (positions after advection, velocities: the "slab exchange"),
    3 of the FLIP diff grids before the particle update; 1 pmax of the
    particles lost to the slab capacity;
  * one-plane halo exchanges for the stencil stages: extrapolation (6),
    the RHS's u plane (1), the level set's halo for the diagonal, the
    pressure update and the blur (1), p for the pressure update (1), and
    in the SOR 1 for the fluid mask and 1 a half-update (parallel/halo.py);
  * the 8 x-sweeps relay a carry plane of candidates from slab to slab:
    a rank receives the plane its neighbour's sweep ended with, sweeps,
    and sends its own last plane on (csrc/sweep.cu::fst_sweep_x_carry).
    JAX's SPMD program runs D lock-step rounds for this; with a process a
    rank, receive -> sweep -> send gives the same planes. The 16 y- and
    z-sweeps are local.

Layout (``shard_state_x``): particles are blocks of N / D rows in their
original order; the grids are x-slabs of slabx = nx / D planes. u is held
CELL-INDEXED, entry c of a slab holding face x0 + c + 1: face 0 is the wall
and always 0 (P2G zeroes it and nothing writes it), so the (nx + 1) axis
splits evenly. v and w are the slabs of the whole (nx, ny + 1, nz) and
(nx, ny, nz + 1) grids; inside the step they too drop their wall face 0.

Each rank advects its block through the gathered whole grids (the port's
interpolation; the JAX package's packed tables are a TPU layout and stay
behind, as ``_pack_mac3_sharded`` does), then takes from the gathered
positions the particles of its slab and a one-cell x halo, in original
index order, up to a capacity C = min(N, ceil128(4N / D)) (JAX's rule: the
highest indices are dropped, and the step can report how many, the most
over the ranks). The CSR index, the own-cell seed, the 27-neighbourhood
pass and P2G run on the extended slab (nx = slabx + 2), which holds every
particle that reaches a face or a cell of the slab; the results are cropped
to the slab. Positions and level-set candidates stay in the domain's frame
and the kernels take the slab's x origin, so no value is moved between
frames and rounded (the JAX package moves them, and rounds). The particle
update walks the rank's block through the gathered diff grids. The step
runs advection uncached, as the JAX package does: a state's k1 is not
carried.

On the card a rank's stages are the port's hand kernels: the 27-
neighbourhood pass (csrc/seed.cu) and P2G (csrc/p2g.cu) on the extended
slab, the y/z sweeps (csrc/sweep.cu::fst_sweeps, 8 calls a step), the
x-sweeps with their carry (fst_sweep_x_carry, 8), the SOR's half-updates
(csrc/sor.cu::fst_sor_half, 2 x iterations) and the FLIP gather
(csrc/g2p.cu) for the block. On the CPU each takes its plain version. The
results are the one-device step's bit for bit, on the CPU and on the card:
the same operations on the same particles in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import SimConfig
from ..core.state import SimState
from ..ops.advect import advect_rk3
from ..ops.binning import build_csr, build_csr_cells, sort_particles
from ..ops.blur import blur_phi
from ..ops.common import cell_scale
from ..ops.cuda_g2p import g2p_flip
from ..ops.cuda_sweep import CODE, SWEEP_ORDER, sweep_x_carry, sweeps
from ..ops.extrapolate import extrapolate_one_ring
from ..ops.levelset import FAR, neighborhood_pass, seed_own_cell
from ..ops.p2g import p2g_from_csr
from ..ops.project import compute_diag, compute_rhs, face_update
from ..solver.step3d import pic_flip_alpha
from . import comm
from .halo import sor_local


def check_split(cfg: SimConfig, world: comm.World) -> None:
    """JAX's preconditions (halo_step.py:331-335), so that both packages
    take the same configurations."""
    d = world.size
    if cfg.nx % d or cfg.ny % d or cfg.num_particles % d:
        raise ValueError(f"nx {cfg.nx}, ny {cfg.ny} and the particle count "
                         f"{cfg.num_particles} must each divide over {d} ranks")


def default_capacity(n: int, d: int, num: int = 4, den: int = 1) -> int:
    """min(N, ceil128(num * N / (den * D))): the slab capacity, 4x the
    average share (num/den scales it for a wider halo)."""
    return min(n, (num * n // (d * den) + 127) // 128 * 128)


# -- the x-slab layout --------------------------------------------------------

def shard_state_x(state, world: comm.World):
    """This rank's part of a whole SimState (or ApicState) in the layout
    make_halo_step (make_halo_apic_step) takes: particle rows
    [rank*N/D, (rank+1)*N/D), grid x planes [x0, x0 + slabx), u
    cell-indexed (faces x0+1 .. x0+slabx). A SimState's k1 is dropped."""
    nx = state.phi.shape[0]
    if nx % world.size or state.pos.shape[0] % world.size:
        raise ValueError(f"nx {nx} and the particle count {state.pos.shape[0]} must divide "
                         f"over {world.size} ranks")
    sx, rows = nx // world.size, state.pos.shape[0] // world.size
    x0, r0 = world.rank * sx, world.rank * rows
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    out = {}
    for name, t in fields.items():
        if name == "k1" or t is None:
            continue
        if name in ("pos", "vel", "C"):
            out[name] = t[r0:r0 + rows].clone()
        elif name == "u":
            out[name] = t[x0 + 1:x0 + sx + 1].clone()
        else:
            out[name] = t[x0:x0 + sx].clone()
    return type(state)(**out)


def unshard_state_x(local, world: comm.World):
    """The whole state on every rank, from the ranks' x-slab parts (one
    all-gather a field)."""
    out = {}
    for f in dataclasses.fields(local):
        t = getattr(local, f.name)
        if t is None:
            continue
        g = comm.all_gather(world, t)
        if f.name == "u":
            g = torch.cat([torch.zeros_like(g[:1]), g], 0)
        out[f.name] = g
    return type(local)(**out)


def full_grids(world: comm.World, u_ci, v_ci, w_ci):
    """The whole MAC grids from the ranks' cell-indexed slabs, the wall
    face 0 put back on each axis (halo_step.py:303-312)."""
    u = comm.all_gather(world, u_ci)
    v = comm.all_gather(world, v_ci)
    w = comm.all_gather(world, w_ci)
    return (torch.cat([torch.zeros_like(u[:1]), u], 0),
            torch.cat([torch.zeros_like(v[:, :1]), v], 1),
            torch.cat([torch.zeros_like(w[:, :, :1]), w], 2))


def cell_indexed(state):
    """(u, v, w) of a slab state with v's and w's wall face 0 dropped."""
    return state.u, state.v[:, 1:].contiguous(), state.w[:, :, 1:].contiguous()


def staggered(u, v, w):
    """The state's (u, v, w) from cell-indexed slabs: v and w get their
    wall face 0 back."""
    return (u, torch.cat([torch.zeros_like(v[:, :1]), v], 1),
            torch.cat([torch.zeros_like(w[:, :, :1]), w], 2))


# -- the particle slab exchange -----------------------------------------------

@dataclasses.dataclass
class Slab:
    """The particles of a rank's extended slab, in original index order.
    The extended slab is the slab with ``lo`` cells before it and ``hi``
    after it: the halo, cut where the domain ends. Its plane 0 is the
    domain's plane ``x0``."""

    cfg: SimConfig       # the extended slab's grid: nx = lo + slabx + hi
    x0: int
    lo: int
    hi: int
    pcs: torch.Tensor    # (n, 3) positions in the domain's cell units
    vel: torch.Tensor    # (n, 3)
    extra: torch.Tensor | None  # (n, ...) rows gathered with them (APIC's C)
    n_dropped: int       # most particles any rank lost to its capacity


def gather_slab(cfg: SimConfig, world: comm.World, pos, vel, capacity: int, halo: int,
                extra=None) -> Slab:
    """All-gather the particle blocks, and keep those whose cell,
    floor(p + 0.5), is in [x0 - halo, x0 + slabx + halo - 1] (within the
    domain), up to ``capacity`` (the lowest indices). The positions stay
    in the domain's cell units: the kernels take the slab's x origin, so
    every weight and distance is the one-device step's bit for bit. (The
    JAX package moves them into the slab's frame, which rounds where a
    position plus 0.5 crosses a power of two.)"""
    slabx = cfg.nx // world.size
    x0 = world.rank * slabx
    lo, hi = min(halo, x0), min(halo, cfg.nx - x0 - slabx)
    pos_all = comm.all_gather(world, pos)
    vel_all = comm.all_gather(world, vel)
    extra_all = None if extra is None else comm.all_gather(world, extra)
    pc = pos_all * cell_scale(cfg, pos.device)
    cellx = torch.floor(pc[:, 0] + 0.5)
    mine = (cellx >= x0 - lo) & (cellx <= x0 + slabx + hi - 1)  # NaN: no slab's
    idx = torch.nonzero(mine).squeeze(1)
    n_dropped = comm.pmax(world, max(idx.numel() - capacity, 0))
    idx = idx[:capacity]
    return Slab(
        cfg=dataclasses.replace(cfg, nx=lo + slabx + hi), x0=x0 - lo, lo=lo, hi=hi, pcs=pc[idx],
        vel=vel_all[idx], extra=None if extra_all is None else extra_all[idx],
        n_dropped=n_dropped,
    )


# -- the level set ------------------------------------------------------------

def _sweep_x_relay(cfg: SimConfig, world: comm.World, phi, cpos, reverse: bool):
    """One x-sweep across the slabs: receive the carry plane from the rank
    the sweep comes from, sweep, send the last plane on. The rank where the
    sweep starts copies its first plane, as the one-device sweep does. The
    candidates are in the domain's frame, so the plane crosses as it is."""
    r, d = world.rank, world.size
    src, dst = (r + 1, r - 1) if reverse else (r - 1, r + 1)
    carry = comm.recv(world, cpos[0], src) if 0 <= src < d else None
    phi, cpos, out = sweep_x_carry(cfg, phi, cpos, reverse, carry, r * phi.shape[0])
    if 0 <= dst < d:
        comm.send(world, out, dst)
    return phi, cpos


def relay_sweeps(cfg: SimConfig, world: comm.World, phi, cpos):
    """The 24 sweeps of SWEEP_ORDER over the slabs: each x-sweep relayed,
    the y- and z-sweeps between two x-sweeps in one local call."""
    local = dataclasses.replace(cfg, nx=phi.shape[0])
    x0 = world.rank * phi.shape[0]
    pending: list[int] = []
    for code in SWEEP_ORDER:
        axis, reverse = CODE[code]
        if axis:
            pending.append(code)
            continue
        if pending:
            phi, cpos = sweeps(local, phi, cpos, pending, x0)
            pending = []
        phi, cpos = _sweep_x_relay(cfg, world, phi, cpos, reverse)
    if pending:
        phi, cpos = sweeps(local, phi, cpos, pending, x0)
    return phi, cpos


def _moved(cpos, dx: int):
    """Candidates with dx added to x, FAR left FAR."""
    if dx == 0:
        return cpos
    x = cpos[..., 0]
    return torch.cat([torch.where(x == FAR, x, x + dx)[..., None], cpos[..., 1:]], -1)


def slab_level_set(cfg: SimConfig, world: comm.World, slab: Slab, csr, pcs):
    """Own-cell seed and 27-neighbourhood pass on the extended slab, cropped
    to the slab, then the relayed sweeps; candidates in the domain's frame.
    Returns (phi, cpos) of the slab. The pass measures distances to its
    grid's own cell centres, so its candidates go into the extended slab's
    frame and back: exact both ways (each lies within the slab's cells, and
    its distance is the same difference of reals)."""
    lo, sx = slab.lo, slab.cfg.nx - slab.lo - slab.hi
    cpos0 = _moved(seed_own_cell(slab.cfg, csr, pcs), -slab.x0)
    phie, cpose = neighborhood_pass(slab.cfg, cpos0)
    phi = phie[lo:lo + sx]
    cpos = _moved(cpose[lo:lo + sx], slab.x0)
    return relay_sweeps(cfg, world, phi, cpos)


def crop_faces(slab: Slab, ue, ve, we, uve, vve, wve):
    """The slab's cell-indexed faces from the extended slab's grids: u's
    faces x0+1 .. x0+slabx (extended faces lo+1 .. lo+slabx), v's and w's
    without the halo planes and the wall face 0. The domain's last u face
    is the extended slab's last on the last rank: a wall, 0 and valid."""
    lo, sx = slab.lo, slab.cfg.nx - slab.lo - slab.hi
    x = slice(lo, lo + sx)
    return (ue[lo + 1:lo + 1 + sx], ve[x, 1:], we[x, :, 1:],
            uve[lo + 1:lo + 1 + sx], vve[x, 1:], wve[x, :, 1:])


# -- grid stages --------------------------------------------------------------

def extrapolate_local(world: comm.World, g, valid):
    """One-ring extrapolation with the neighbours' x-planes; past the
    domain's edges the neighbours are valid zeros, as out of bounds in the
    one-device form."""
    ge = comm.halo_x(world, g, 0.0, 0.0)
    ve = comm.halo_x(world, valid, True, True)
    return extrapolate_one_ring(ge, ve)[1:-1]


def add_gravity_local(cfg: SimConfig, v, dt):
    """Gravity on the interior V faces: cell-indexed entries 0 .. ny-2."""
    out = v.clone()
    out[:, : cfg.ny - 1] += np.float32(cfg.gravity_y) * np.float32(dt)
    return out


def project_local(cfg: SimConfig, world: comm.World, u, v, w, phi, dt):
    """RHS, diagonal, halo SOR and pressure update on the slab (cell-
    indexed faces). Returns (u, v, w, phi_e), phi_e the level set with
    its x halo planes."""
    x0 = world.rank * phi.shape[0]
    u_lo = comm.from_lo(world, u[-1], 0.0)  # face x0; the wall (0) on rank 0
    zero_v, zero_w = torch.zeros_like(v[:, :1]), torch.zeros_like(w[:, :, :1])
    b = compute_rhs(cfg, torch.cat([u_lo[None], u], 0), torch.cat([zero_v, v], 1),
                    torch.cat([zero_w, w], 2), dt)
    phi_e = comm.halo_x(world, phi, 0.0, 0.0)
    diag = compute_diag(cfg, phi, (phi_e[0], phi_e[-1]), x0)
    p = sor_local(cfg, world, phi, diag, b, cfg.sor_iterations)
    p_e = comm.halo_x(world, p, 0.0, 0.0)
    # Entry c of u is the face between cells c and c+1 of the slab (its
    # extended planes c+1, c+2); the domain's last face stays as it is.
    val = face_update(cfg, u, phi_e[1:-1], phi_e[2:], p_e[1:-1], p_e[2:], dt)
    if world.rank == world.size - 1:
        val[-1] = u[-1]
    ny, nz = cfg.ny, cfg.nz
    vv = face_update(cfg, v[:, : ny - 1], phi[:, : ny - 1], phi[:, 1:], p[:, : ny - 1],
                     p[:, 1:], dt)
    ww = face_update(cfg, w[:, :, : nz - 1], phi[:, :, : nz - 1], phi[:, :, 1:],
                     p[:, :, : nz - 1], p[:, :, 1:], dt)
    return (val, torch.cat([vv, v[:, ny - 1:]], 1), torch.cat([ww, w[:, :, nz - 1:]], 2),
            phi_e)


# -- the step -----------------------------------------------------------------

def make_halo_step(cfg: SimConfig, world: comm.World, capacity: int | None = None,
                   with_diagnostics: bool = False):
    """The multi-rank step(state, dt) of this rank: ``state`` is its part
    in shard_state_x's layout, and so is the result. ``capacity``: the
    particles a slab (with its one-cell halo) may hold, by default 4x the
    average share; past it the highest indices are dropped.
    ``with_diagnostics``: step returns (state, n_dropped), the most
    particles any rank dropped this step (0 in a healthy run)."""
    check_split(cfg, world)
    cap = default_capacity(cfg.num_particles, world.size) if capacity is None else capacity
    if cap < 1:
        raise ValueError(f"capacity must be positive, got {cap}")

    def step_fn(state: SimState, dt):
        u, v, w = cell_indexed(state)
        uf, vf, wf = full_grids(world, u, v, w)
        pos = advect_rk3(cfg, uf, vf, wf, state.pos, dt)

        slab = gather_slab(cfg, world, pos, state.vel, cap, 1)
        csr = build_csr_cells(slab.cfg, slab.pcs, slab.x0)
        pcs, vels = slab.pcs[csr.order], slab.vel[csr.order]
        phi, _ = slab_level_set(cfg, world, slab, csr, pcs)
        u, v, w, uv, vv, wv = crop_faces(slab, *p2g_from_csr(slab.cfg, csr, pcs, vels, slab.x0))

        u = extrapolate_local(world, u, uv)
        v = extrapolate_local(world, v, vv)
        w = extrapolate_local(world, w, wv)
        old_u, old_v, old_w = u, v, w
        v = add_gravity_local(cfg, v, dt)
        u, v, w, phi_e = project_local(cfg, world, u, v, w, phi, dt)

        # The FLIP update of the block through the whole diff grids
        # g - beta * g_old (formed here, elementwise as the gather forms
        # them at each corner), the old grids then zero.
        beta = 1.0 - np.float32(pic_flip_alpha(cfg, dt))
        diff = full_grids(world, u - beta * old_u, v - beta * old_v, w - beta * old_w)
        walk = sort_particles(cfg, build_csr(cfg, pos), pos, state.vel)
        zeros = [torch.zeros_like(g) for g in diff]
        vel, _ = g2p_flip(cfg, walk.csr.order, walk.pcs, walk.vels, *diff, *zeros, beta)

        phi = blur_phi(phi_e)[1:-1]
        out = SimState(pos, vel.contiguous(), *staggered(u, v, w), phi)
        return (out, slab.n_dropped) if with_diagnostics else out

    return step_fn
