"""The multi-rank APIC step: parallel/halo_step.py's skeleton applied to the
APIC family (solver/apic.py::step_apic).

Port of fluidsimulation_tpu/parallel/halo_apic.py (``make_halo_apic_step``,
``shard_apic_state_x``). The collectives, the x-slab layout, the relayed
x-sweeps and the halo projection are the FLIP halo step's; what differs:

  * the slab exchange also gathers the affine rows C (a third all-gather
    of particle blocks, (N, 9));
  * the quadratic-spline windows reach 2 cells, so a rank takes the
    particles of cells [x0 - 2, x0 + slabx + 1] and works on an extended
    slab of slabx + 4 cells; the default capacity is FLIP's 4x share scaled
    by (slabx + 4) / (slabx + 2) (halo_apic.py:87-98: without it, 3,584
    particles were dropped silently at 32^3 over 8 devices);
  * P2G (ops/apic.py::p2g_apic_cells) takes the positions in the domain's
    frame and the slab's x origin, so its spline weights and affine lever
    arms are the one-device step's (JAX takes the weights in the shifted
    frame and the lever arms in the domain's meters, halo_apic.py:166-169);
  * advection is RK3 with stage 1 the particle's own velocity;
  * the particle update is the APIC G2P of the rank's block over the
    gathered projected grids.

The APIC transfers are plain PyTorch, as in the one-device step (the JAX
package has no Pallas kernel for them); on the card the level set's pass
and sweeps and the SOR's half-updates are the hand kernels. A particle
whose position is not finite lies in no slab, so unlike the one-device
P2G it adds nothing to any face.
"""

from __future__ import annotations

from ..core.config import SimConfig
from ..core.state import ApicState
from ..ops.advect import advect_rk3_pic
from ..ops.apic import g2p_apic, p2g_apic_cells
from ..ops.binning import build_csr_cells
from ..ops.blur import blur_phi
from ..ops.common import cell_scale
from . import comm
from .halo_step import (
    add_gravity_local,
    cell_indexed,
    check_split,
    crop_faces,
    default_capacity,
    extrapolate_local,
    full_grids,
    gather_slab,
    project_local,
    shard_state_x,
    slab_level_set,
    staggered,
)

HALO = 2  # x cells each side of an APIC slab


def default_apic_capacity(cfg: SimConfig, d: int) -> int:
    slabx = cfg.nx // d
    return default_capacity(cfg.num_particles, d, 4 * (slabx + 4), slabx + 2)


def shard_apic_state_x(state: ApicState, world: comm.World) -> ApicState:
    """This rank's part of a whole ApicState in make_halo_apic_step's
    layout (halo_step.py::shard_state_x's, C split like pos)."""
    return shard_state_x(state, world)


def make_halo_apic_step(cfg: SimConfig, world: comm.World, capacity: int | None = None,
                        with_diagnostics: bool = False):
    """The multi-rank APIC step(state, dt) of this rank, on its part in
    shard_apic_state_x's layout. ``capacity``: the particles a slab with
    its 2-cell halo may hold (default above); ``with_diagnostics``: step
    returns (state, n_dropped) as make_halo_step's does."""
    check_split(cfg, world)
    cap = default_apic_capacity(cfg, world.size) if capacity is None else capacity
    if cap < 1:
        raise ValueError(f"capacity must be positive, got {cap}")

    def step_fn(state: ApicState, dt):
        n = state.pos.shape[0]
        u, v, w = cell_indexed(state)
        uf, vf, wf = full_grids(world, u, v, w)
        pos = advect_rk3_pic(cfg, uf, vf, wf, state.pos, state.vel, dt)

        slab = gather_slab(cfg, world, pos, state.vel, cap, HALO, state.C.reshape(n, 9))
        csr = build_csr_cells(slab.cfg, slab.pcs, slab.x0)
        phi, _ = slab_level_set(cfg, world, slab, csr, slab.pcs[csr.order])
        # P2G in the particles' original order, as the one-device step.
        c_rows = slab.extra.reshape(-1, 3, 3)
        u, v, w, uv, vv, wv = crop_faces(
            slab, *p2g_apic_cells(slab.cfg, slab.pcs, slab.vel, c_rows, cell_scale(cfg, pos.device),
                                  slab.x0))

        u = extrapolate_local(world, u, uv)
        v = extrapolate_local(world, v, vv)
        w = extrapolate_local(world, w, wv)
        v = add_gravity_local(cfg, v, dt)
        u, v, w, phi_e = project_local(cfg, world, u, v, w, phi, dt)

        vel, C = g2p_apic(cfg, pos, *full_grids(world, u, v, w))
        u, v, w = staggered(u, v, w)
        out = ApicState(pos=pos, vel=vel, C=C, u=u, v=v, w=w, phi=blur_phi(phi_e)[1:-1])
        return (out, slab.n_dropped) if with_diagnostics else out

    return step_fn
