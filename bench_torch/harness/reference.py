"""The plain reference step: the 3D dam-break solver's FLIP and APIC steps
in plain PyTorch, kept with the benchmark so that the program under test
cannot change what it is held against. A run finds a transfer's reference
by name in references/<name>.py (harness/catalog.py); references/flip.py
and references/apic.py step these on the configuration's scene.

It follows GPFluidSim::Simulate (Simulation.cpp:513-566) stage by stage:

  advect (RK3) -> level set (own-cell seed, 27-neighbourhood pass, 24
  sweeps) -> P2G -> one-ring extrapolation -> [FLIP: snapshot] -> gravity
  -> projection (RHS, ghost-fluid diagonal, red-black SOR, pressure
  update) -> FLIP blend and the next RK3 stage 1 | APIC G2P -> blur phi

with no kernel, no particle index and no sorting: P2G scatters with
``index_add_``, the level-set seed takes the lowest particle index among a
cell's closest particles with two ``scatter_reduce_`` passes, and every
gather reads the grids at the particles in their own order. Each stage is
the textbook form of the reference's shader, written out here; operation
order and float32 scalars follow the reference's CPU solver, so that a
sound float32 program agrees with it to rounding.

``dtype`` sets the precision every tensor of the step is held and computed
in. float32 is the configuration's precision; bfloat16 is the control that
the benchmark's comparison has to reject (harness/compare.py).

Imports torch and numpy only.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

# Candidate coordinate of a cell with no particle (any real candidate beats it).
FAR = 1.0e9
# Sweep directions (Simulation.cpp:744-753): 0=Xm 1=Xp 2=Ym 3=Yp 4=Zm 5=Zp.
SWEEP_ORDER = (0, 2, 4, 1, 2, 4, 0, 3, 4, 1, 3, 4, 0, 2, 5, 1, 2, 5, 0, 3, 5, 1, 3, 5)
SWEEP_AXIS = {0: (0, False), 1: (0, True), 2: (1, False), 3: (1, True), 4: (2, False), 5: (2, True)}
APIC_WEIGHT_THRESH = 1e-4  # quadratic B-spline face weights (APIC P2G validity)
FLIP_FIELDS = ("pos", "vel", "u", "v", "w", "phi", "k1")
APIC_FIELDS = ("pos", "vel", "C", "u", "v", "w", "phi")


@dataclasses.dataclass(frozen=True)
class Scene:
    """The scene's numbers, as a configuration file of the benchmark states
    them (bench_torch/configs/*.json, key ``scene``)."""

    nx: int
    ny: int
    nz: int
    cells_per_meter: float
    rho: float
    gravity_y: float
    nu: float
    particle_radius: float
    sor_iterations: int
    max_dt: float
    particles_per_cell_axis: int
    max_ls_ratio: float
    zero_thresh: float

    @property
    def omega(self) -> float:
        """SOR over-relaxation 2 - 3.16343/nx (Simulation.cpp:909)."""
        return 2.0 - 3.16343 / self.nx

    @property
    def dx(self) -> float:
        return 1.0 / self.cells_per_meter

    def face_shapes(self):
        nx, ny, nz = self.nx, self.ny, self.nz
        return ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))


def scene_of(numbers: dict) -> Scene:
    return Scene(**{f.name: numbers[f.name] for f in dataclasses.fields(Scene)})


def _f(x) -> float:
    """A float32 scalar as a Python float of the same value."""
    return float(np.float32(x))


def _shift(a, axis: int, s: int, fill):
    """out[i] = a[i + s] along axis; entries past the edge are ``fill``."""
    out = torch.full_like(a, fill)
    n = a.shape[axis]
    if s > 0:
        out.narrow(axis, 0, n - s).copy_(a.narrow(axis, s, n - s))
    else:
        out.narrow(axis, -s, n + s).copy_(a.narrow(axis, 0, n + s))
    return out


def _scale(sc: Scene, like):
    return torch.tensor([sc.nx, sc.ny, sc.nz], dtype=like.dtype, device=like.device)


# ---- MAC interpolation (Simulation3D.h:55-123) ----

def _split(coord, m: int, extended: bool):
    """(index, fraction) along one axis. fmin maps NaN to the bound, so a
    non-finite position reads in range and its fraction keeps the NaN."""
    if extended:  # faces along the axis: clamp c + 0.5 to [0, m], floor at most m - 1
        e, top = (coord + 0.5).clamp(0.0, float(m)), m - 1.0
    else:  # clamp c to [0, m - 1], floor at most m - 2
        e, top = coord.clamp(0.0, m - 1.0), m - 2.0
    i = torch.fmin(torch.floor(e), torch.tensor(top, dtype=e.dtype, device=e.device))
    return i.long(), e - i


def _lerp(a, b, t):
    return a + (b - a) * t


def _trilerp(g, i, j, k, fi, fj, fk):
    _, sy, sz = g.shape
    flat = g.reshape(-1)
    base = (i * sy + j) * sz + k
    dx, dy = sy * sz, sz

    def at(off):
        return flat[base + off]

    x00 = _lerp(at(0), at(dx), fi)
    x10 = _lerp(at(dy), at(dx + dy), fi)
    x01 = _lerp(at(1), at(dx + 1), fi)
    x11 = _lerp(at(dy + 1), at(dx + dy + 1), fi)
    return _lerp(_lerp(x00, x10, fj), _lerp(x01, x11, fj), fk)


def interp(u, v, w, pc):
    """The MAC grids' velocity at cell-unit positions pc (N, 3) -> (N, 3)."""
    n = (u.shape[0] - 1, v.shape[1] - 1, w.shape[2] - 1)
    normal = [_split(pc[:, a], n[a], False) for a in range(3)]
    ext = [_split(pc[:, a], n[a], True) for a in range(3)]
    out = []
    for a, g in enumerate((u, v, w)):
        idx = [ext[b] if b == a else normal[b] for b in range(3)]
        out.append(_trilerp(g, idx[0][0], idx[1][0], idx[2][0], idx[0][1], idx[1][1], idx[2][1]))
    return torch.stack(out, dim=-1)


# ---- advection (Simulation3D.cpp:211-221, gpAdvect.hlsl:65-67) ----

def advect(sc: Scene, u, v, w, pos, k1, dt):
    """Ralston RK3; stage 1 is k1 when given (FLIP's carried grid velocity,
    APIC's particle velocity), else sampled here."""
    m = _scale(sc, pos)
    dt = _f(dt)

    def vel_at(p):
        return interp(u, v, w, p * m)

    if k1 is None:
        k1 = vel_at(pos)
    k2 = vel_at(pos + _f(0.5 * np.float32(dt)) * k1)
    k3 = vel_at(pos + _f(0.75 * np.float32(dt)) * k2)
    new = pos + dt * ((2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3)
    return torch.clamp(new, -0.4 / m, 1.0 - 0.6 / m)


# ---- level set (gpComputeClosestParticleNeighbors.hlsl, Simulation.cpp:718-798) ----

def _dist(ax, ay, az, bx, by, bz):
    ex, ey, ez = ax - bx, ay - by, az - bz
    return torch.sqrt(ex * ex + ey * ey + ez * ez)


def _cell_ids(sc: Scene, pc):
    """Linear cell (cx*ny + cy)*nz + cz of floor(p + 0.5); ncell for a
    particle whose position is not finite."""
    ncell = sc.nx * sc.ny * sc.nz
    c = torch.floor(pc + 0.5)
    finite = torch.isfinite(c).all(dim=1)
    # Advection keeps a float32 position's cell inside the grid; the clamp
    # holds a lower precision's rounding there too.
    top = torch.tensor([sc.nx - 1, sc.ny - 1, sc.nz - 1], device=pc.device)
    c = torch.minimum(torch.where(finite[:, None], c, 0.0).long().clamp(min=0), top)
    lin = (c[:, 0] * sc.ny + c[:, 1]) * sc.nz + c[:, 2]
    return torch.where(finite, lin, ncell), c


def seed_own_cell(sc: Scene, pc):
    """Each cell's closest own particle, the lowest index among ties; FAR
    where a cell holds none."""
    nx, ny, nz = sc.nx, sc.ny, sc.nz
    ncell = nx * ny * nz
    lin, c = _cell_ids(sc, pc)
    cf = c.to(pc.dtype)
    d = _dist(pc[:, 0], pc[:, 1], pc[:, 2], cf[:, 0], cf[:, 1], cf[:, 2]) - sc.particle_radius
    best = torch.full((ncell + 1,), float("inf"), dtype=pc.dtype, device=pc.device)
    best.scatter_reduce_(0, lin, d, "amin")
    n = pc.shape[0]
    idx = torch.arange(n, device=pc.device)
    win = torch.full((ncell + 1,), n, dtype=torch.int64, device=pc.device)
    win.scatter_reduce_(0, lin, torch.where(d == best[lin], idx, n), "amin")
    win = win[:ncell]
    seeded = win < n
    cpos = torch.where(seeded[:, None], pc[torch.where(seeded, win, 0)], FAR)
    return cpos.reshape(nx, ny, nz, 3)


def neighbourhood_pass(sc: Scene, cpos0):
    """Each cell takes the closest of its 27 neighbour cells' candidates,
    the first in (dx, dy, dz) order winning a tie."""
    nx, ny, nz = sc.nx, sc.ny, sc.nz
    dt, dev = cpos0.dtype, cpos0.device
    pad = torch.full((nx + 2, ny + 2, nz + 2, 3), FAR, dtype=dt, device=dev)
    pad[1:-1, 1:-1, 1:-1] = cpos0
    xg = torch.arange(nx, dtype=dt, device=dev)[:, None, None]
    yg = torch.arange(ny, dtype=dt, device=dev)[None, :, None]
    zg = torch.arange(nz, dtype=dt, device=dev)[None, None, :]
    phi = torch.full((nx, ny, nz), float("inf"), dtype=dt, device=dev)
    cpos = torch.full((nx, ny, nz, 3), FAR, dtype=dt, device=dev)
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        cand = pad[1 + ox : 1 + ox + nx, 1 + oy : 1 + oy + ny, 1 + oz : 1 + oz + nz]
        d = _dist(cand[..., 0], cand[..., 1], cand[..., 2], xg, yg, zg) - sc.particle_radius
        better = d < phi
        phi = torch.where(better, d, phi)
        cpos = torch.where(better[..., None], cand, cpos)
    return phi, cpos


def sweeps(sc: Scene, phi, cpos):
    """The 24 directional sweeps: along each, a cell takes the previous
    plane's resulting candidate where it is closer."""
    phi, cpos = phi.clone(), cpos.clone()
    axes = [torch.arange(n, dtype=phi.dtype, device=phi.device) for n in phi.shape]
    centres = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    r = sc.particle_radius
    for code in SWEEP_ORDER:
        axis, reverse = SWEEP_AXIS[code]
        n = phi.shape[axis]
        planes = range(n - 1, -1, -1) if reverse else range(n)
        carry = cpos.select(axis, planes[0]).clone()
        for s in planes[1:]:
            ph, cp, c = phi.select(axis, s), cpos.select(axis, s), centres.select(axis, s)
            d = _dist(carry[..., 0], carry[..., 1], carry[..., 2], c[..., 0], c[..., 1], c[..., 2]) - r
            better = d < ph
            carry = torch.where(better[..., None], carry, cp)
            ph.copy_(torch.where(better, d, ph))
            cp.copy_(carry)
    return phi


def level_set(sc: Scene, pc):
    phi, cpos = neighbourhood_pass(sc, seed_own_cell(sc, pc))
    return sweeps(sc, phi, cpos)


# ---- P2G (Simulation3D.cpp:440-537, gpTransferParticleVelocities*.hlsl) ----

def _edges(sc: Scene, a: int, g, valid):
    """Wall-normal faces are 0 and valid."""
    n = (sc.nx, sc.ny, sc.nz)[a]
    for edge in (0, n):
        g.select(a, edge).zero_()
        valid.select(a, edge).fill_(True)


def p2g_flip(sc: Scene, pc, vel):
    """Trilinear hat weights: each face's weighted mean of the particles'
    velocity component; valid where the weight sum exceeds zero_thresh."""
    n, dims = pc.shape[0], (sc.nx, sc.ny, sc.nz)
    out = []
    for a, shape in enumerate(sc.face_shapes()):
        base, frac = [], []
        for ax in range(3):
            c = pc[:, ax] + (0.5 if ax == a else 0.0)
            b = torch.floor(c)
            base.append(b.long())
            frac.append(c - b)
        acc = torch.zeros(math.prod(shape), dtype=pc.dtype, device=pc.device)
        amt = torch.zeros_like(acc)
        for offs in itertools.product((0, 1), repeat=3):
            idx = [base[ax] + offs[ax] for ax in range(3)]
            ok = torch.ones(n, dtype=torch.bool, device=pc.device)
            w = torch.ones(n, dtype=pc.dtype, device=pc.device)
            for ax in range(3):
                ok = ok & (idx[ax] >= 0) & (idx[ax] < dims[ax] + (1 if ax == a else 0))
                w = w * (frac[ax] if offs[ax] else 1.0 - frac[ax])
            lin = torch.where(ok, (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2], 0)
            w = torch.where(ok, w, 0.0)
            acc.index_add_(0, lin, w * vel[:, a])
            amt.index_add_(0, lin, w)
        g = (acc / amt.clamp(min=1e-30)).reshape(shape)
        valid = (amt > sc.zero_thresh).reshape(shape)
        _edges(sc, a, g, valid)
        out.append((g, valid))
    return out


def extrapolate(g, valid):
    """One ring (gpExtrapolateParticleVelocities.hlsl): an invalid face takes
    the mean of its valid 6-neighbours; out-of-bounds neighbours count as
    valid zeros."""
    num = torch.zeros_like(g)
    tot = torch.zeros_like(g)
    for axis in range(3):
        for s in (-1, 1):
            ok = _shift(valid, axis, s, True)
            num = num + ok
            tot = tot + torch.where(ok, _shift(g, axis, s, 0.0), 0.0)
    mean = torch.where(num > 0, tot / torch.clamp(num, min=1.0), 0.0)
    return torch.where(valid, g, mean)


def add_gravity(sc: Scene, v, dt):
    out = v.clone()
    out[:, 1 : sc.ny] += _f(np.float32(sc.gravity_y) * np.float32(dt))
    return out


# ---- projection (Simulation.cpp:860-943) ----

def _interior(n: int, axis: int, like):
    """1 where an index along ``axis`` is off the grid's edge, else 0."""
    i = torch.arange(n, device=like.device)
    shape = [1, 1, 1]
    shape[axis] = n
    return ((i > 0) & (i < n - 1)).to(like.dtype).reshape(shape)


def project(sc: Scene, u, v, w, phi, dt):
    dev = phi.device
    rhs = _f(np.float32(-sc.dx * sc.rho) / np.float32(dt)) * (
        u[1:] - u[:-1] + v[:, 1:] - v[:, :-1] + w[:, :, 1:] - w[:, :, :-1])
    fluid = phi < 0.0
    # Ghost-fluid diagonal; air cells 1.
    num = (3.0 + _interior(sc.nx, 0, phi) + _interior(sc.ny, 1, phi)
           + _interior(sc.nz, 2, phi)).expand(phi.shape)
    recip = 1.0 / torch.where(fluid, phi, -1.0)
    ghost = torch.zeros_like(phi)
    for axis in range(3):
        for s in (-1, 1):
            ghost = ghost + torch.clamp(-_shift(phi, axis, s, 0.0) * recip, 0.0, sc.max_ls_ratio)
    diag = torch.where(fluid, num + ghost, 1.0)
    # Red-black SOR from p = 0: colour 0 then colour 1, cfg.sor_iterations times.
    omega = _f(sc.omega)
    keep = _f(1.0 - np.float32(sc.omega))
    ix = [torch.arange(n, device=dev) for n in phi.shape]
    parity = (ix[0][:, None, None] + ix[1][None, :, None] + ix[2][None, None, :]) % 2
    colour = [fluid & (parity == c) for c in (0, 1)]
    nb_fluid = [_shift(fluid, axis, s, False) for axis in range(3) for s in (-1, 1)]
    p = torch.zeros_like(rhs)
    for _ in range(sc.sor_iterations):
        for c in (0, 1):
            nms = torch.zeros_like(p)
            k = 0
            for axis in range(3):
                for s in (-1, 1):
                    nms = nms - torch.where(nb_fluid[k], _shift(p, axis, s, 0.0), 0.0)
                    k += 1
            p = torch.where(colour[c], keep * p + omega * (rhs - nms) / diag, p)
    # Pressure gradient with the 4-case ghost-fluid rule; wall faces kept.
    scale = _f(np.float32(dt) / np.float32(sc.rho * sc.dx))
    maxr = sc.max_ls_ratio
    out = []
    for axis, g in enumerate((u, v, w)):
        n = phi.shape[axis]
        pl, pr = phi.narrow(axis, 0, n - 1), phi.narrow(axis, 1, n - 1)
        ql, qr = p.narrow(axis, 0, n - 1), p.narrow(axis, 1, n - 1)
        cur = g.narrow(axis, 1, n - 1)
        safe_l = torch.where(pl != 0.0, pl, -1e-30)
        safe_r = torch.where(pr != 0.0, pr, -1e-30)
        both = cur - scale * (qr - ql)
        lonly = cur + scale * ql * (1.0 + torch.clamp(-pr / safe_l, 0.0, maxr))
        ronly = cur - scale * qr * (1.0 + torch.clamp(-pl / safe_r, 0.0, maxr))
        val = torch.where(pl < 0.0, torch.where(pr < 0.0, both, lonly),
                          torch.where(pr < 0.0, ronly, 0.0))
        g = g.clone()
        g.narrow(axis, 1, n - 1).copy_(val)
        out.append(g)
    return out


def blur(phi):
    """(self + 6 neighbours) / 7, out-of-bounds reads 0 (gpBlur.hlsl)."""
    acc = phi
    for axis in range(3):
        for s in (-1, 1):
            acc = acc + _shift(phi, axis, s, 0.0)
    return acc / 7.0


# ---- APIC transfers (quadratic B-splines; C = 4 B m^2) ----

def _spline(d):
    ad = d.abs()
    o = 1.5 - ad
    return torch.where(ad < 0.5, 0.75 - ad * ad, torch.where(ad < 1.5, 0.5 * (o * o), 0.0))


def _apic_nodes(sc: Scene, pc, a: int, m):
    """(index per axis, in range, weight, lever arm in m) of the 27 spline
    nodes of component a, outer to inner over x, y, z."""
    dims = (sc.nx, sc.ny, sc.nz)
    axes = []
    for ax in range(3):
        t = pc[:, ax] + (0.5 if ax == a else 0.0)
        base = torch.nan_to_num(torch.floor(t - 0.5), nan=0.0, posinf=2.0**30,
                                neginf=-2.0**30).long()
        hi = dims[ax] + (1 if ax == a else 0)
        nodes = []
        for off in range(3):
            idx = base + off
            d = t - idx.to(t.dtype)
            nodes.append((idx, (idx >= 0) & (idx < hi), _spline(d), -d / m[ax]))
        axes.append(nodes)
    for ox, oy, oz in itertools.product(range(3), repeat=3):
        (ix, kx, wx, lx), (iy, ky, wy, ly), (iz, kz, wz, lz) = axes[0][ox], axes[1][oy], axes[2][oz]
        yield (ix, iy, iz), kx & ky & kz, wx * wy * wz, (lx, ly, lz)


def p2g_apic(sc: Scene, pc, vel, C, m):
    out = []
    for a, shape in enumerate(sc.face_shapes()):
        _, sy, sz = shape
        acc = torch.zeros(math.prod(shape), dtype=pc.dtype, device=pc.device)
        amt = torch.zeros_like(acc)
        row = C[:, a, :]
        for idx, ok, w, lever in _apic_nodes(sc, pc, a, m):
            val = vel[:, a] + row[:, 0] * lever[0] + row[:, 1] * lever[1] + row[:, 2] * lever[2]
            lin = torch.where(ok, (idx[0] * sy + idx[1]) * sz + idx[2], 0)
            w = torch.where(ok, w, 0.0)
            acc.index_add_(0, lin, w * val)
            amt.index_add_(0, lin, w)
        g = (acc / amt.clamp(min=1e-30)).reshape(shape)
        valid = (amt > APIC_WEIGHT_THRESH).reshape(shape)
        for end in (0, -1):
            g.select(a, end).zero_()
            valid.select(a, end).fill_(True)
        out.append((g, valid))
    return out


def g2p_apic(sc: Scene, pc, grids, m):
    """Pure-PIC velocities and affine rows; fetches outside the grid reuse
    the edge value."""
    n = pc.shape[0]
    scale = 4.0 * m * m
    vels, rows = [], []
    for a, (shape, g) in enumerate(zip(sc.face_shapes(), grids)):
        flat = g.reshape(-1)
        _, sy, sz = shape
        vk = torch.zeros(n, dtype=pc.dtype, device=pc.device)
        b = [torch.zeros_like(vk) for _ in range(3)]
        for idx, _ok, w, lever in _apic_nodes(sc, pc, a, m):
            ic = [idx[ax].clamp(0, shape[ax] - 1) for ax in range(3)]
            wg = w * flat[(ic[0] * sy + ic[1]) * sz + ic[2]]
            vk = vk + wg
            b = [bb + wg * lv for bb, lv in zip(b, lever)]
        vels.append(vk)
        rows.append(torch.stack([b[ax] * scale[ax] for ax in range(3)], -1))
    return torch.stack(vels, -1), torch.stack(rows, 1)


# ---- the steps ----

def _cast(state: dict, fields, dtype):
    return {k: state[k].to(dtype) for k in fields}


def flip_step(sc: Scene, state: dict, dt, dtype=torch.float32) -> dict:
    """One PIC/FLIP step from ``state`` (pos, vel, u, v, w, phi, k1); returns
    the new state's fields in float32."""
    s = _cast(state, FLIP_FIELDS, dtype)
    pos = advect(sc, s["u"], s["v"], s["w"], s["pos"], s["k1"], dt)
    m = _scale(sc, pos)
    pc = pos * m
    phi = level_set(sc, pc)
    (u, uv), (v, vv), (w, wv) = p2g_flip(sc, pc, s["vel"])
    u, v, w = extrapolate(u, uv), extrapolate(v, vv), extrapolate(w, wv)
    old = (u, v, w)
    v = add_gravity(sc, v, dt)
    u, v, w = project(sc, u, v, w, phi, dt)
    alpha = np.clip(6.0 * np.float32(dt) * np.float32(sc.nu * sc.cells_per_meter**2), 0.0, 1.0)
    beta = _f(1.0 - np.float32(alpha))
    diff = interp(u - beta * old[0], v - beta * old[1], w - beta * old[2], pc)
    vel = beta * s["vel"] + diff
    k1 = interp(u, v, w, pc)
    out = dict(pos=pos, vel=vel, u=u, v=v, w=w, phi=blur(phi), k1=k1)
    return {k: t.to(torch.float32) for k, t in out.items()}


def apic_step(sc: Scene, state: dict, dt, dtype=torch.float32) -> dict:
    """One APIC step from ``state`` (pos, vel, C, u, v, w, phi); returns the
    new state's fields in float32."""
    s = _cast(state, APIC_FIELDS, dtype)
    pos = advect(sc, s["u"], s["v"], s["w"], s["pos"], s["vel"], dt)
    m = _scale(sc, pos)
    pc = pos * m
    phi = level_set(sc, pc)
    (u, uv), (v, vv), (w, wv) = p2g_apic(sc, pc, s["vel"], s["C"], m)
    u, v, w = extrapolate(u, uv), extrapolate(v, vv), extrapolate(w, wv)
    v = add_gravity(sc, v, dt)
    u, v, w = project(sc, u, v, w, phi, dt)
    vel, C = g2p_apic(sc, pc, (u, v, w), m)
    out = dict(pos=pos, vel=vel, C=C, u=u, v=v, w=w, phi=blur(phi))
    return {k: t.to(torch.float32) for k, t in out.items()}
