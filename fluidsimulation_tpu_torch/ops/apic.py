"""APIC (affine particle-in-cell) transfers, port of the oracle pair of
fluidsimulation_tpu/ops/apic.py (p2g_apic, g2p_apic) and its
extrapolate_rings.

Quadratic B-spline weights on the MAC faces: with them the inertia matrix
of every particle is (dx^2/4) I, so C = 4 B m^2 needs no solve. C has shape
(N, 3, 3), 1/s; C[p, k, :] is the affine row of component k. Positions in
cell units put cell centres at integers and the U faces at x = i - 0.5, as
in ops/p2g.py.

P2G's plain form (p2g_apic_cells) adds each of the 27 spline nodes'
weighted values and weights into the faces with one ``index_add_`` a node
and an accumulator, in JAX's node order (ox, oy, oz outer to inner): on the
CPU each face then sums its terms in the order of JAX's scatter of the
concatenated nodes, bit for bit. On the card p2g_apic runs the hand kernel
of ops/cuda_p2g_apic.py (csrc/p2g_apic.cu), a gather over a CSR index of
the particles with no atomics: each term is formed as here, and each face
sums them in the order column (cx, then cy), then the CSR run along z, then
slot (a dense cell's runs in pieces, whose sums are added in that order),
the same bits on every run. The JAX package has no Pallas kernel for
these transfers, so the kernel replaces none. G2P gathers with clamp
addressing, in plain PyTorch. The JAX package's packed and table forms
(pack_mac9, g2p_apic_packed, ApicTable, ops/apic_super.py) are TPU layouts,
not ported.

A NaN coordinate gets base node 0, as JAX's float-to-int conversion of
floor(NaN) gives: the particle's nodes 0-2 stay in range with weight 0 and
a NaN lever, so its P2G adds 0 * NaN to those faces, as JAX's does.
"""

from __future__ import annotations

import itertools
import math

import torch

from ..core.config import SimConfig
from .common import cell_scale, index_of, shift
from .cuda_p2g_apic import p2g_apic_gather

# Validity threshold for face weights: quadratic B-spline weights are
# smaller than hats (at most 0.75 per axis); faces a particle meaningfully
# touches still accumulate far more than 1e-4.
APIC_WEIGHT_THRESH = 1e-4


def _quad_spline(d):
    """Quadratic B-spline value at signed distance d (support |d| < 1.5).
    JAX's (1.5 - |d|) ** 2 is a product here: the same bits."""
    ad = d.abs()
    inner = 0.75 - ad * ad
    o = 1.5 - ad
    outer = 0.5 * (o * o)
    return torch.where(ad < 0.5, inner, torch.where(ad < 1.5, outer, 0.0))


def _axis_nodes(t, hi: int, m_ax, x0: int = 0):
    """The nodes base + 0, 1, 2 along one axis of coordinates t (node
    frame): (index, in range, spline weight, lever node - particle in m);
    the index less x0, the grid's first node on the axis."""
    base = index_of(torch.floor(t - 0.5))
    out = []
    for off in range(3):
        idx = base + off
        d = t - idx.float()
        idx = idx - x0
        out.append((idx, (idx >= 0) & (idx < hi), _quad_spline(d), -d / m_ax))
    return out


def _component_nodes(cfg: SimConfig, pc, comp_axis: int, m=None, x0: int = 0):
    """Yield (idx3, ok, w, dxm) for the 27 spline nodes of one component,
    in JAX's order.

    pc: (N, 3) positions in cell units of cfg's grid. idx3: 3 (N,) int64
    node indices; ok: (N,) in-range mask; w: (N,) spline weight; dxm: 3
    (N,) lever arms x_i - x_p in meters, a cell being 1 / m[axis] meters
    (m: cfg's cell_scale unless given). x0: cfg's grid is the x-slab from
    the domain's plane x0 on, pc in the domain's cell units. Each axis's
    three nodes are formed once; a node's weight is their product in JAX's
    order, (w_x * w_y) * w_z.
    """
    dims = (cfg.nx, cfg.ny, cfg.nz)
    if m is None:
        m = cell_scale(cfg, pc.device)
    axes = [
        _axis_nodes(pc[:, ax] + (0.5 if ax == comp_axis else 0.0),
                    dims[ax] + (1 if ax == comp_axis else 0), m[ax], x0 if ax == 0 else 0)
        for ax in range(3)
    ]
    for ox, oy, oz in itertools.product(range(3), repeat=3):
        (ix, okx, wx, lx), (iy, oky, wy, ly), (iz, okz, wz, lz) = (
            axes[0][ox], axes[1][oy], axes[2][oz])
        yield [ix, iy, iz], okx & oky & okz, wx * wy * wz, [lx, ly, lz]


def _shapes(cfg: SimConfig):
    return ((0, cfg.u_shape()), (1, cfg.v_shape()), (2, cfg.w_shape()))


def p2g_apic(cfg: SimConfig, pos, vel, C):
    """APIC P2G for the three MAC components.

    pos: (N, 3) meters; vel: (N, 3) m/s; C: (N, 3, 3) 1/s; any order and
    subset of the particles. Returns (u, v, w, uv, vv, wv) as
    ops/p2g.py::transfer_to_grid does: the face values and their validity
    (weight above APIC_WEIGHT_THRESH); boundary faces are 0 and valid. A CPU
    tensor takes the plain form; a CUDA tensor the kernel, over a CSR index
    of these particles.
    """
    m = cell_scale(cfg, pos.device)
    pc = pos * m
    if pc.device.type == "cpu":
        return p2g_apic_cells(cfg, pc, vel, C, m)
    return p2g_apic_gather(cfg, pc, vel, C, APIC_WEIGHT_THRESH)


def p2g_apic_cells(cfg: SimConfig, pc, vel, C, m, x0: int = 0):
    """p2g_apic on positions pc in the domain's cell units, m the domain's
    (3,) cell_scale, onto cfg's grid, which is the x-slab from the
    domain's plane x0 on: a rank's extended slab in
    parallel/halo_apic.py. The weights and lever arms are the whole
    grid's, bit for bit (the JAX package takes the weights in a shifted
    frame, halo_apic.py:166-169)."""
    out = []
    for comp_axis, shape in _shapes(cfg):
        pv = vel[:, comp_axis]
        crow = C[:, comp_axis, :]
        _, sy, sz = shape
        acc = torch.zeros(math.prod(shape), dtype=torch.float32, device=pc.device)
        amt = torch.zeros_like(acc)
        for idx, ok, w, dxm in _component_nodes(cfg, pc, comp_axis, m, x0):
            val = pv + crow[:, 0] * dxm[0] + crow[:, 1] * dxm[1] + crow[:, 2] * dxm[2]
            # A node outside the grid is masked before its index is used.
            lin = torch.where(ok, (idx[0] * sy + idx[1]) * sz + idx[2], 0)
            w = torch.where(ok, w, 0.0)
            acc.index_add_(0, lin, w * val)
            amt.index_add_(0, lin, w)
        g = (acc / amt.clamp(min=1e-30)).reshape(shape)
        valid = (amt > APIC_WEIGHT_THRESH).reshape(shape)
        for end in (0, -1):
            g.select(comp_axis, end).zero_()
            valid.select(comp_axis, end).fill_(True)
        out.append((g, valid))
    (u, uv), (v, vv), (w, wv) = out
    return u, v, w, uv, vv, wv


def g2p_apic(cfg: SimConfig, pos, u, v, w):
    """APIC G2P: the pure-PIC velocities and the affine rows from the same
    weights. Returns vel (N, 3) and C (N, 3, 3), with
    C[:, k, ax] = 4 m[ax]^2 sum_i w_ip v_i (x_i - x_p)[ax]."""
    m = cell_scale(cfg, pos.device)
    pc = pos * m
    n = pos.shape[0]
    scale = 4.0 * m * m
    vels, crows = [], []
    for (comp_axis, shape), grid in zip(_shapes(cfg), (u, v, w)):
        gflat = grid.reshape(-1)
        _, sy, sz = shape
        vk = torch.zeros(n, dtype=torch.float32, device=pos.device)
        brow = [torch.zeros_like(vk) for _ in range(3)]
        for idx, _ok, wgt, dxm in _component_nodes(cfg, pc, comp_axis):
            # Clamp addressing: weights keep their nominal nodes, fetches
            # outside the grid reuse the edge value.
            ic = [idx[ax].clamp(0, shape[ax] - 1) for ax in range(3)]
            wg = wgt * gflat[(ic[0] * sy + ic[1]) * sz + ic[2]]
            vk = vk + wg
            brow = [b + wg * lever for b, lever in zip(brow, dxm)]
        vels.append(vk)
        crows.append(torch.stack([brow[ax] * scale[ax] for ax in range(3)], -1))
    return torch.stack(vels, -1), torch.stack(crows, 1)


def extrapolate_rings(g, valid, rings: int = 2):
    """Multi-ring velocity extrapolation, kept as the JAX package keeps it:
    a measured negative for the APIC step, which runs one ring
    (ops/extrapolate.py). Every face G2P reads with a nonzero weight was
    weighted by P2G and is valid, so more rings changed nothing there.
    Out-of-bounds neighbours are invalid; faces never reached are 0."""
    g = torch.where(valid, g, 0.0)
    for _ in range(rings):
        num = torch.zeros_like(g)
        tot = torch.zeros_like(g)
        for axis in range(3):
            for s in (-1, 1):
                nb_ok = shift(valid, axis, s, False)
                num = num + nb_ok
                tot = tot + torch.where(nb_ok, shift(g, axis, s, 0.0), 0.0)
        fill = num > 0
        g = torch.where(valid, g, torch.where(fill, tot / num.clamp(min=1.0), 0.0))
        valid = valid | fill
    return g
