"""Raytraced water renderer in PyTorch: the port of
fluidsimulation_tpu/render/raytrace.py (the pixel shader of FX/Render.fx
as a function over batches of rays).

Every function runs on the device of the tensors it is given, as plain
PyTorch: the renderer has no hand kernel (the JAX one has no Pallas
kernel either). The fixed worst-case trip counts of the reference stay:
a 64-step outside sphere trace, a 128-probe inside march and its backward
refine, 8 glass iterations, 2 water bounces (traceWater2 -> traceWater1 ->
traceWater0). Lanes that have converged are frozen by their own flags, so
a loop may run past the point where every lane is done without changing
the result; the marches read "is any lane still marching" back to the
host once every CHECK_EVERY iterations (the inside forward march once a
block of SPEC probes) through ``_any``, their only host read.

The reference quirks the JAX module replicates stay (its docstring,
raytrace.py:11-21): the top-level reflection sum of traceGlass is
discarded, traceGlass's inner branch always uses the water IOR, the
backward march reuses the forward counter (48 - i_exit iterations), the
matte floor is disabled.

Arithmetic follows the JAX package's operation for operation, so that the
two agree to the last bit where XLA does not contract or reorder:
  * the level set is sampled with the arithmetic of JAX's packed texture
    (map_dist_packed): the z lerp as hat weights max(0, 1 - |qz - z|), the
    four (x, y) corners mixed with their weights summed left to right; the
    texture itself (PackedPhi and its row layouts) is not ported;
  * 3-term sums are written x + y + z, integer powers as the products
    lax.integer_pow forms (x**5 = x * ((x*x) * (x*x)));
  * a tensor is never divided by a Python number: on the card PyTorch
    multiplies by the number's reciprocal instead, which rounds twice.
Only sin, cos, arcsin and the powers of the sky and the final colour may
differ by ulps between devices; they touch colours, not march decisions.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from .interior import deepen_phi

LARGE = 1.0e5  # Render.fx:61 largeNum
WALL = 0.02  # glass wall thickness, Render.fx:60
SPEC = 8  # probes a block of the inside forward march (divides 128)
SPOT = (-0.7, 0.05, 0.5)  # sun direction (normalized below), Render.fx:28
SPHERE_MARGIN = 4.0  # sphere-trace skip of the inside march, in cells
SPHERE_SCALE = 1.0
SEED_BACK = 6.0  # temporal seed backoff, in cells
CHECK_EVERY = 8  # march iterations between two host reads of "any lane left"


def _f32(x) -> float:
    """A Python float holding float32(x): a scalar operand that rounds as
    JAX's float32 constants do."""
    return float(np.float32(x))


def _div(x, c: float):
    """x / c, divided on x's device by a float32 tensor (see module
    docstring)."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def _in_f64(fn, x, *args):
    """fn(x, *args) in float64, rounded to float32. PyTorch's CPU float32
    transcendentals differ by an ulp between the vector body of a loop and
    its tail, so a value would depend on where its lane falls in the batch
    (a tile and the whole frame would differ); the float64 results round to
    the same float32 but for a rare tie, on the card as on the CPU."""
    return fn(x.double(), *args).float()


def _sqrt(x):
    """The correctly rounded float32 square root on every device (the
    float64 root rounded to float32 is); PyTorch's CPU float32 sqrt
    (MKL's) is not correctly rounded."""
    return _in_f64(torch.sqrt, x)


def _any(mask) -> bool:
    """Whether any lane of ``mask`` is set: the marches' one host read."""
    return bool(mask.any())


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> SimpleNamespace:
    """The vector constants, formed in float32 as JAX forms them, on one
    device (copied there once)."""
    f = np.float32
    spot = np.array(SPOT, f)
    spot = spot / np.sqrt(spot[0] * spot[0] + spot[1] * spot[1] + spot[2] * spot[2])
    e = f(0.005)
    host = dict(
        box_lo=np.full(3, -0.5 - WALL, f),
        box_hi=np.array([0.5 + WALL, 0.5, 0.5 + WALL], f),
        inn_lo=np.full(3, -0.5, f),
        inn_hi=np.full(3, 0.5, f),
        half=np.full(3, 0.5, f),
        up=np.array([0.0, 1.0, 0.0], f),
        taps=np.array([[0, 0, 0], [e, 0, 0], [0, e, 0], [0, 0, e]], f),
        spot=spot,
        kx=np.array([1.0, 2.0 / 3.0, 1.0 / 3.0], f),
        r1=np.array([195.0, 43.0, 6.0], f) / f(255.0),
        r2=np.array([228.0, 132.0, 28.0], f) / f(255.0),
        bg1=np.array([168.0, 139.0, 83.0], f) / f(255.0),
        bl2=np.array([96.0, 130.0, 158.0], f) / f(255.0),
        bl3=np.array([96.0, 130.0, 218.0], f) / f(255.0),
        sun_c=np.array([255.0, 213.0, 73.0], f) / f(255.0),
        xz=np.array([True, False, True]),
        zz=np.array([0.0, 1.0], f),
    )
    out = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    sin_t = np.sin(f(-1.95))  # f_time of Render.fx's sky
    return SimpleNamespace(**out, sin_t=float(sin_t),
                           light=float(f(1.0) + f(0.25) * sin_t),
                           mix=float(f(0.25) + f(0.25) * sin_t))


@functools.lru_cache(maxsize=None)
def _grid(device: torch.device, dims: tuple) -> SimpleNamespace:
    """Per-grid constants of the texture sample on one device."""
    nx, ny, nz = dims
    m = np.array(dims, np.float32)
    corner = [dx * ny * nz + dy * nz for dx in (0, 1) for dy in (0, 1)]
    host = dict(
        m=m, inv_m=np.float32(1.0) / m, hi=m - np.float32(1.0), top=m - np.float32(2.0),
        strides=np.array([ny * nz, nz, 1], np.int64),
        offs=np.array([[c, c + 1] for c in corner], np.int64),
    )
    return SimpleNamespace(**{k: torch.from_numpy(v).to(device) for k, v in host.items()})


def _sum3(v):
    return v[..., 0] + v[..., 1] + v[..., 2]


def _norm(v, eps: float = 0.0):
    s = _sum3(v * v)
    if eps:
        s = s + eps
    return v / _sqrt(s)[..., None]


def _dot(a, b):
    return _sum3(a * b)


def _pow5(x):
    """lax.integer_pow(x, 5)'s products."""
    x2 = x * x
    return x * (x2 * x2)


# -- level-set sampling ------------------------------------------------------

def _split(g, p):
    """Texel coordinates with half-texel centres and clamp addressing: the
    floor i (at most n - 2) and fraction f, and the clamped q. fmin takes
    NaN to the bound, so an index is always in range (the fraction keeps
    the NaN)."""
    q = torch.minimum((p * g.m - 0.5).clamp_min(0.0), g.hi)
    i = torch.fmin(torch.floor(q), g.top)
    return q, i, q - i


def sample_phi(phi, p):
    """Texture-style trilinear sample: p in [0,1]^3 normalized coordinates,
    texel centres at (i+0.5)/n, clamp addressing."""
    _, i, f = _split(_grid(phi.device, tuple(phi.shape)), p)
    ix, iy, iz = i.long().unbind(-1)
    fx, fy, fz = f.unbind(-1)

    def g(dx, dy, dz):
        return phi[ix + dx, iy + dy, iz + dz]

    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _warp(g, p):
    """iq's quintic smoothstep warp on the x/z fractions (Render.fx:81-113),
    returning warped [0,1]^3 sample coordinates."""
    mp = p * g.m + 0.5
    i = torch.floor(mp)
    f = mp - i
    q = f * f * f * (f * (f * 6.0 - 15.0) + 10.0)
    f = torch.where(_consts(p.device).xz, q, f)
    return g.inv_m * (i + f - 0.5)


def map_dist(phi, p):
    """Distance to the fluid at p in [0,1]^3 (Render.fx:77-116): the warp,
    then the sample in the arithmetic of JAX's map_dist_packed, over n.

    Per (x, y) corner the two z texels are weighted by their hats and
    added; the four corners are weighted and summed left to right."""
    g = _grid(phi.device, tuple(phi.shape))
    q, i, f = _split(g, _warp(g, p))
    base = (i.long() * g.strides).sum(-1)
    vals = phi.reshape(-1).take(base[..., None, None] + g.offs)  # (..., 4, 2)
    hat = (1.0 - (q[..., 2:3] - (i[..., 2:3] + _consts(p.device).zz)).abs()).clamp_min(0.0)
    z4 = vals[..., 0] * hat[..., None, 0] + vals[..., 1] * hat[..., None, 1]
    wx = torch.stack([1.0 - f[..., 0], f[..., 0]], -1)
    wy = torch.stack([1.0 - f[..., 1], f[..., 1]], -1)
    zw = z4 * (wx[..., :, None] * wy[..., None, :]).flatten(-2)
    return _div(zw[..., 0] + zw[..., 1] + zw[..., 2] + zw[..., 3], float(phi.shape[0]))


def compute_gradient(md, p):
    """Forward-difference normal (Render.fx:426-438): four taps, one call
    of md on the stacked points."""
    c = _consts(p.device)
    taps = md(p[None] + c.taps.view(4, *([1] * (p.dim() - 1)), 3))
    g = torch.movedim(taps[1:] - taps[0], 0, -1)
    return torch.where((p[..., 1] > 0.999)[..., None], c.up, g)


def trace_floor(co, ci):
    """Distance to the matte floor plane y = -0.5 - w (Render.fx:64-74).
    Present for component parity; the reference disables the floor in its
    pixel shader (`|| true`, Render.fx:567) and so does this port."""
    t = (-0.5 - WALL - co[..., 1]) / ci[..., 1]
    return torch.where(t < 0.0, LARGE, t)


# -- geometry ---------------------------------------------------------------

def intersect_aabb(co, ci, bmin, bmax):
    """Slab test (Render.fx:120-147). Returns (tm, tM, norm1, norm2);
    (LARGE, LARGE, ...) on miss."""
    ci_safe = torch.where(ci.abs() < 1e-12, 1e-12, ci)
    inv = torch.reciprocal(ci_safe)
    t1 = (bmin - co) * inv
    t2 = (bmax - co) * inv
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    tm = tmin.amax(-1)
    tM = tmax.amin(-1)
    hit = tM >= tm
    n1 = (torch.sign(tmin - tm[..., None]) + 1.0) * torch.sign(t1 - t2)
    n2 = (torch.sign(tM[..., None] - tmax) + 1.0) * torch.sign(t2 - t1)
    return torch.where(hit, tm, LARGE), torch.where(hit, tM, LARGE), n1, n2


def fresnel_tr(ci, n, n1, n2):
    """Schlick fresnel + reflection + Snell transmission (Render.fx:154-180).
    n1, n2: float32 values (Python floats) or tensors of the batch's shape.
    Returns (fresnel_weight, refl_dir, trans_dir); TIR -> weight 1, trans 0."""
    if isinstance(n1, torch.Tensor):
        r = (n2 - n1) / (n2 + n1)
        rf0, eta = r * r, n1 / n2
        eta2, eta_b = eta * eta, eta[..., None]
    else:
        a, b = np.float32(n1), np.float32(n2)
        r = (b - a) / (b + a)
        rf0, eta = float(r * r), a / b
        eta2, eta = float(eta * eta), float(eta)
        eta_b = eta
    cos_i = _dot(n, -ci)
    fresnel = rf0 + (1.0 - rf0) * _pow5(1.0 - cos_i)
    refl = 2.0 * cos_i[..., None] * n + ci
    k = 1.0 - eta2 * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    ksqrt = _sqrt(k.clamp_min(0.0))
    trans = eta_b * ci + (eta * cos_i - ksqrt)[..., None] * n
    trans = torch.where(tir[..., None], 0.0, trans)
    return torch.where(tir, 1.0, fresnel), refl, trans


# -- sky --------------------------------------------------------------------

def _hsv2rgb(c):
    """Render.fx:184-189. jnp.mod's sign rule: fmod, then + 1 where the
    remainder is negative."""
    r = torch.fmod(c[..., 0:1] + _consts(c.device).kx, 1.0)
    r = torch.where(r < 0.0, r + 1.0, r)
    p = (r * 6.0 - 3.0).abs()
    return c[..., 2:3] * (1.0 + c[..., 1:2] * ((p - 1.0).clamp(0.0, 1.0) - 1.0))


def _sky_grad(h):
    """Render.fx:191-212, at the reference's f_time = -1.95."""
    c = _consts(h.device)
    h = h - h * 0.25 * c.sin_t
    h_ = h[..., None]
    col = torch.where(
        h_ < 0.25,
        c.r1 + (c.r2 - c.r1) * 4.0 * h_,
        torch.where(h_ < 0.5, c.r2 + (c.bg1 - c.r2) * 4.0 * (h_ - 0.25),
                    c.bg1 + (c.bl2 - c.bg1) * 2.0 * (h_ - 0.5)),
    )
    return (col + (c.bl3 - col) * c.mix) * c.light


def sample_environment(d):
    """Procedural sky + sun (Render.fx:214-248)."""
    c = _consts(d.device)
    dspot = _dot(d, c.spot)
    d1 = d[..., 1]
    pos_angle = _in_f64(torch.asin, d1.clamp(-1.0, 1.0))
    trav = 0.35 * _in_f64(torch.cos, _sqrt((12.3 * pos_angle).clamp(0.0, 100.0)) - 0.8) + 0.65
    day_v = 0.25 + 0.666 * (0.3 + trav) * (dspot + 1.0) / 2.0
    day_s = 0.9 - _div(trav, 1.60)
    day_h = 0.61 + (0.65 - 0.61) * d1
    day = _hsv2rgb(torch.stack([day_h, day_s, day_v], -1))
    grad_s = _sky_grad(0.75 - 0.75 * dspot * (1.0 - 3.0 * d1).clamp(0.0, 1.0) * trav)
    grad_f = (grad_s + day) / 2.0

    diff = c.spot - d
    dist = _sqrt(_sum3(diff * diff)) * 10.0
    inten = torch.full_like(dist, 0.015) / dist.abs() + _in_f64(torch.exp2, -(dist * 2.0).abs()) * 0.4
    grad_f = grad_f + c.sun_c * (inten * 8.0)[..., None]

    # Redistribute excess red.
    over = (grad_f[..., 0] - 1.0).clamp_min(0.0)
    add = torch.stack([torch.zeros_like(over), _div(over, 1.5), _div(over, 0.75)], -1)
    grad_f = torch.where((grad_f[..., 0] > 1.0)[..., None], grad_f + add, grad_f)
    return _in_f64(torch.pow, grad_f.abs(), 0.4545)


# -- glass ------------------------------------------------------------------

def trace_glass(co, ci):
    """Render.fx:255-352. Returns (h_main, prim_co, prim_ci, prim_alpha,
    refl_sum)."""
    c = _consts(co.device)
    inside = (co.abs() < 0.51).all(-1)
    tm_o, tM_o, n1_o, n2_o = intersect_aabb(co, ci, c.box_lo, c.box_hi)
    h_main = torch.where(inside, tM_o, tm_o)
    norm1 = torch.where(inside[..., None], -n2_o, n1_o)
    miss = h_main >= LARGE
    p_outer = co + ci * h_main[..., None]

    # Open-top special case (Render.fx:287-293).
    top = ((p_outer[..., 1] > 0.49) & (p_outer[..., 0].abs() <= 0.503)
           & (p_outer[..., 2].abs() <= 0.503) & ~miss)

    fres, refl1, trans1 = fresnel_tr(ci, norm1, 1.0, 1.5)
    refl_sum = fres[..., None] * sample_environment(refl1)
    inn_weight = 1.0 - fres
    prim_co = torch.full_like(co, LARGE)
    prim_ci = torch.full_like(co, LARGE)
    prim_alpha = torch.zeros_like(fres)
    prim_set = torch.zeros_like(miss)
    p, d = p_outer, trans1
    for _ in range(8):
        tm_i, _, n1_i, _ = intersect_aabb(p, d, c.inn_lo, c.inn_hi)
        use_outer = (tm_i <= 0.01) | (tm_i >= LARGE)
        _, tM2, _, n2_2 = intersect_aabb(p, d, c.box_lo, c.box_hi)
        h = torch.where(use_outer, tM2, tm_i)
        n = torch.where(use_outer[..., None], -n2_2, n1_i)
        p = p + d * h[..., None]

        # outer branch: exit to air
        f_air, refl_air, trans_air = fresnel_tr(d, n, 1.5, 1.0)
        refl_sum_air = refl_sum + (inn_weight * (1.0 - f_air))[..., None] * sample_environment(trans_air)
        w_air = inn_weight * f_air

        # inner branch: always water IOR (Render.fx:330 `|| true`)
        f_wat, refl_wat, trans_wat = fresnel_tr(d, n, 1.5, 1.333)
        alpha_wat = prim_alpha + inn_weight * (1.0 - f_wat)
        w_wat = inn_weight * f_wat
        set_now = ~prim_set & (alpha_wat > 0.0) & ~use_outer
        prim_co = torch.where(set_now[..., None], p, prim_co)
        prim_ci = torch.where(set_now[..., None], trans_wat, prim_ci)
        prim_set = prim_set | set_now

        d = torch.where(use_outer[..., None], refl_air, refl_wat)
        inn_weight = torch.where(use_outer, w_air, w_wat)
        refl_sum = torch.where(use_outer[..., None], refl_sum_air, refl_sum)
        prim_alpha = torch.where(use_outer, prim_alpha, alpha_wat)

    # Apply the special-case and miss overrides.
    prim_co = torch.where(top[..., None], p_outer, prim_co)
    prim_ci = torch.where(top[..., None], ci, prim_ci)
    prim_alpha = torch.where(top, 1.0, prim_alpha)
    refl_sum = torch.where(top[..., None], 0.0, refl_sum)

    prim_co = torch.where(miss[..., None], LARGE, prim_co)
    prim_ci = torch.where(miss[..., None], LARGE, prim_ci)
    prim_alpha = torch.where(miss, 0.0, prim_alpha)
    refl_sum = torch.where(miss[..., None], LARGE, refl_sum)
    h_main = torch.where(miss, LARGE, h_main)
    return h_main, prim_co, prim_ci, prim_alpha, refl_sum


# -- water intersection ------------------------------------------------------

def _march_outside(md, p0, ci, max_t, t, done):
    """The 64-step outside sphere trace (Render.fx:369-381) from t."""
    p = p0 + t[..., None] * ci
    i = 0
    while i < 64 and _any(~done):
        for _ in range(min(CHECK_EVERY, 64 - i)):
            dt = md(p)
            t2 = t + dt
            done2 = done | (dt < 0.001) | (t2 >= max_t)
            p2 = p0 + t2[..., None] * ci
            t = torch.where(done, t, t2)
            p = torch.where(done[..., None], p, p2)
            done = done2
            i += 1
    return t


def _march_outside_overstep(md, p0, ci, max_t, t, done, omega: float):
    """Enhanced sphere tracing of the outside march (Keinert et al. 2014):
    step omega*dt, certified when the two probe spheres overlap, else back
    to the plain march's point; hits and box exits only at certified
    points (JAX intersect_water's ``overstep``)."""
    back = _f32(np.float32(omega) - np.float32(1.0))
    dlast = torch.zeros_like(t)
    ostep = torch.zeros_like(done)
    i = 0
    while i < 64 and _any(~done):
        for _ in range(min(CHECK_EVERY, 64 - i)):
            dt = md(p0 + t[..., None] * ci)
            fail = ostep & (dt + dlast < omega * dlast)
            t2 = t + dt
            done2 = done | (~fail & ((dt < 0.001) | (t2 >= max_t)))
            t_next = torch.where(fail, t - back * dlast, t + omega * dt)
            t = torch.where(done, t, torch.where(done2, t2, t_next))
            dlast = torch.where(done | fail, dlast, dt)
            ostep = torch.where(done, ostep, ~fail)
            done = done2
            i += 1
    return t


def _skip(sphere, step: float, d8, i, t, max_t, cont):
    """Lattice steps the sphere-trace skip jumps at a block boundary:
    floor((-d8/step - margin) * scale), at most 127 - i and 2 short of the
    box exit, at least 0, 0 for lanes no longer marching. Clamped in float
    before the conversion to int (a float past int32's range converts to
    an undefined value)."""
    margin, scale, _ = sphere
    k = torch.floor((_div(-d8, step) - margin) * scale)
    k = torch.minimum(k, (127 - i).float())
    k = torch.minimum(k, torch.floor(_div(max_t - t, step)) - 2.0)
    return torch.where(cont & (k > 0.0), k, 0.0).to(torch.int32)


def intersect_water(md, inv_m0: float, co, ci, max_t, dead=None, sphere=None,
                    overstep=None, t_seed=None, seed_back=None):
    """Render.fx:358-424. Returns (p_shifted, t).

    ``md``: the distance sampler; ``inv_m0``: the march step, 1/nx as a
    float32 value. ``dead`` marks rays whose colour is discarded upstream
    (zero-weight bounce children); they never march. ``sphere``:
    (margin_cells, scale, spec), the sphere-trace skip of the inside
    forward march, which jumps by the distance sample it already read
    (scale 0 is the exact march). ``overstep``: omega > 1, enhanced sphere
    tracing of the outside march. ``t_seed``/``seed_back``: temporal
    coherence; both marches start at max(t_seed - seed_back, 0), the inside
    one on the lattice (a seed_back past the grid is the cold march)."""
    p0 = co + 0.5
    outside = (md(p0) > 0.0) | (p0[..., 1] > 0.9999)
    t0_seed = None if t_seed is None else (t_seed - seed_back).clamp_min(0.0)
    # Box-miss lanes are glass-miss pixels or dead children: converged at once.
    junk = max_t >= LARGE
    if dead is not None:
        junk = junk | dead

    t_out0 = (torch.zeros_like(max_t) if t0_seed is None
              else torch.where(outside, t0_seed, 0.0))
    if overstep is None:
        t_o = _march_outside(md, p0, ci, max_t, t_out0, ~outside | junk)
    else:
        t_o = _march_outside_overstep(md, p0, ci, max_t, t_out0, ~outside | junk, overstep)
    t_o = torch.minimum(t_o, max_t)
    p_o = p0 + t_o[..., None] * ci

    if _any(~outside & ~junk):
        p_i, t_i = _march_inside(md, inv_m0, p0, ci, max_t, outside, junk, sphere, t0_seed)
    else:
        p_i, t_i = p0, torch.zeros_like(max_t)
    return torch.where(outside[..., None], p_o, p_i), torch.where(outside, t_o, t_i)


def _march_inside(md, step: float, p0, ci, max_t, outside, junk, sphere, t0_seed):
    """The inside march (Render.fx:391-423): 128 fixed probes forward, in
    blocks of ``spec`` probes sampled in one md call, then the backward
    sphere trace, which reuses the forward counter (48 - i_exit steps)."""
    spec = SPEC if sphere is None else sphere[2]
    if t0_seed is None:
        k_init = torch.zeros(max_t.shape, dtype=torch.int32, device=max_t.device)
    else:
        # Lattice-aligned seeded start, below the box exit so boxed lanes
        # re-box on their first probe.
        k_box = (torch.floor(_div(max_t, step)) - 1.0).clamp_min(0.0)
        k = torch.floor(_div(t0_seed, step)).clamp(0.0, 126.0)
        k = torch.minimum(k, k_box)
        k_init = torch.where(k > 0.0, k, 0.0).to(torch.int32)
    i = k_init
    t = k_init.float() * step
    p = p0 + t[..., None] * ci
    i_exit = torch.full_like(i, 128)
    exited = outside | junk  # outside and junk lanes are inert here
    boxed = torch.zeros_like(exited)
    d8 = torch.zeros_like(t)  # no skip before the first probe
    while _any(~(exited | boxed) & (i < 128)):
        if sphere is not None:
            k = _skip(sphere, step, d8, i, t, max_t, ~(exited | boxed) & (i < 128))
            skipped = k > 0
            i = i + k
            t = torch.where(skipped, t + k.float() * step, t)
            p = torch.where(skipped[..., None], p0 + t[..., None] * ci, p)
        ts, ps = [t], [p]
        for _ in range(spec):
            ts.append(ts[-1] + step)
            ps.append(p0 + ts[-1][..., None] * ci)
        dts = md(torch.stack(ps[:-1]))
        for j in range(spec):
            active = ~(exited | boxed) & (i < 128 - j)
            dt = dts[j]
            exit_now = active & (dt >= 0.0)
            box_now = active & ~exit_now & (ts[j + 1] >= max_t)
            i_exit = torch.where(exit_now, i + j, i_exit)
            # On exit t advances but p does not (the reference's break order).
            t = torch.where(active, ts[j + 1], t)
            p = torch.where((active & ~exit_now)[..., None], ps[j + 1], p)
            if sphere is not None:
                d8 = torch.where(active & ~exit_now & ~box_now, dt, d8)
            exited = exited | exit_now
            boxed = boxed | box_now
        i = i + spec

    live = ~boxed & ~outside & ~junk
    done = torch.zeros_like(live)
    k = 0
    while k < 48 and _any((i_exit < 48 - k) & ~done & live):
        for _ in range(min(CHECK_EVERY, 48 - k)):
            active = (i_exit < 48 - k) & ~done & live
            dt = -md(p)
            near = dt > -0.001
            t2 = t + dt
            done = done | (active & near)
            p = torch.where((active & ~near)[..., None], p0 + t2[..., None] * ci, p)
            t = torch.where(active, t2, t)
            k += 1
    # Box exit: the point exactly at the box edge.
    p = torch.where(boxed[..., None], p0 + max_t[..., None] * ci, p)
    return p, torch.where(boxed, max_t, t)


# -- water bounce recursion (unrolled: 2 -> 1 -> 0) -------------------------

def trace_water0(co, ci):
    """Render.fx:442-447."""
    _, _, prim_ci, prim_alpha, refl_sum = trace_glass(co, ci)
    return prim_alpha[..., None] * sample_environment(prim_ci) + refl_sum


def _expand_bounce(md, grad_md, inv_m0, co, ci, w=None, sphere=None, overstep=None,
                   t_seed=None, seed_back=None, return_t=False):
    """One water-bounce level (Render.fx:451-515) as ray splitting: the hit
    point and two weighted child rays. A miss forwards the ray unchanged
    with weight 1; on a hit the children are the fresnel-weighted
    reflection and transmission. Zero-weight children (TIR) do not march.
    A ray whose box lies behind it (max_t <= 0) or whose box test missed
    forwards as a miss, as in JAX."""
    co = co + 0.001 * ci
    half = _consts(co.device).half
    _, max_t, _, _ = intersect_aabb(co, ci, -half, half)
    dead = None if w is None else w <= 0.0
    p_hit, t_hit = intersect_water(md, inv_m0, co, ci, max_t, dead=dead, sphere=sphere,
                                   overstep=overstep, t_seed=t_seed, seed_back=seed_back)
    ipoint = p_hit - 0.5
    missed = (t_hit >= max_t) | (max_t >= LARGE) | (max_t <= 0.0)
    norm = _norm(compute_gradient(grad_md, p_hit), eps=1e-20)
    from_inside = _dot(norm, ci) > 0.0
    n1 = torch.where(from_inside, _f32(1.333), 1.0)
    n2 = torch.where(from_inside, 1.0, _f32(1.333))
    norm = torch.where(from_inside[..., None], -norm, norm)
    fres, refl, trans = fresnel_tr(ci, norm, n1, n2)
    out = (ipoint,
           torch.where(missed[..., None], ci, refl), torch.where(missed, 1.0, fres),
           torch.where(missed[..., None], ci, trans), torch.where(missed, 0.0, 1.0 - fres))
    # Next frame's seed: the raw march t.
    return out + (t_hit,) if return_t else out


def trace_water2(md, grad_md, inv_m0, co, ci, sphere=None, overstep=None, t_seed=None,
                 seed_back=None, return_t=False):
    """2-bounce water tracing (traceWater2 -> traceWater1 -> traceWater0,
    Render.fx:442-515) as batched levels: each level concatenates its
    children [a; b] along axis 0 and traces them in one call (4 leaf rays
    a pixel). ``t_seed``: (3, *batch), the primary march's t and the two
    level-2 children's."""
    shape = co.shape
    kw = dict(sphere=sphere, overstep=overstep, seed_back=seed_back, return_t=return_t)
    r1 = _expand_bounce(md, grad_md, inv_m0, co, ci,
                        t_seed=None if t_seed is None else t_seed[0], **kw)
    ip1, d_a, w_a, d_b, w_b = r1[:5]
    w2 = torch.cat([w_a, w_b], 0)
    r2 = _expand_bounce(md, grad_md, inv_m0, torch.cat([ip1, ip1], 0), torch.cat([d_a, d_b], 0),
                        w=w2, t_seed=None if t_seed is None else torch.cat([t_seed[1], t_seed[2]], 0),
                        **kw)
    ip2, d_c, w_c, d_d, w_d = r2[:5]
    cols = trace_water0(torch.cat([ip2, ip2], 0), torch.cat([d_c, d_d], 0)).reshape(4, *shape)
    w3 = torch.cat([w2 * w_c, w2 * w_d], 0).reshape(4, *shape[:-1])
    prod = cols * w3[..., None]
    out = prod[0] + prod[1] + prod[2] + prod[3]
    if return_t:
        return out, torch.cat([r1[-1][None], r2[-1].reshape(2, *shape[:-1])], 0)
    return out


def trace_water1(md, grad_md, inv_m0, co, ci, sphere=None, overstep=None, t_seed=None,
                 seed_back=None, return_t=False):
    """1-bounce variant (traceWater1)."""
    shape = co.shape
    r1 = _expand_bounce(md, grad_md, inv_m0, co, ci, sphere=sphere, overstep=overstep,
                        t_seed=None if t_seed is None else t_seed[0], seed_back=seed_back,
                        return_t=return_t)
    ip1, d_a, w_a, d_b, w_b = r1[:5]
    cols = trace_water0(torch.cat([ip1, ip1], 0), torch.cat([d_a, d_b], 0)).reshape(2, *shape)
    prod = cols * torch.cat([w_a, w_b], 0).reshape(2, *shape[:-1])[..., None]
    out = prod[0] + prod[1]
    if return_t:
        # No level-2 march: the child planes carry LARGE.
        return out, torch.cat([r1[-1][None], torch.full((2, *shape[:-1]), LARGE,
                                                         device=out.device)], 0)
    return out


# -- top-level pixel shader --------------------------------------------------

def shade(phi, co, ci, grad_phi=None, bounces: int = 2, sphere=None, overstep=None,
          t_seed=None, seed_back=None, return_t=False):
    """PS main (Render.fx:518-578) for ray batches.

    ``phi``: the march texture (the raw level set, or deepen_phi of it for
    the sphere-trace skip); ``grad_phi``: the field of the surface normals,
    phi if None. ``bounces``: 2 is the reference's traceWater2, 1 and 0 its
    lower tiers. Returns the (*batch, 3) image and, with ``return_t``, the
    (3, *batch) march ts (LARGE on glass-miss lanes)."""
    if return_t and bounces < 1:
        raise ValueError("return_t: bounces=0 has no water march to seed")
    md = functools.partial(map_dist, phi)
    grad_md = md if grad_phi is None else functools.partial(map_dist, grad_phi)
    inv_m0 = _f32(np.float32(1.0) / np.float32(phi.shape[0]))
    h, prim_co, prim_ci, _, _ = trace_glass(co, ci)
    hit = h < LARGE
    kw = dict(sphere=sphere, overstep=overstep, t_seed=t_seed, seed_back=seed_back,
              return_t=return_t)
    t_prim = None
    if bounces >= 2:
        r = trace_water2(md, grad_md, inv_m0, prim_co, prim_ci, **kw)
    elif bounces == 1:
        r = trace_water1(md, grad_md, inv_m0, prim_co, prim_ci, **kw)
    else:
        r = trace_water0(prim_co, prim_ci)
    col_water, t_prim = r if return_t else (r, None)
    col = torch.where(hit[..., None], col_water, sample_environment(ci))
    # The reference shades unset primary rays (every glass bounce TIR) as
    # f32 garbage; bound it instead.
    img = torch.nan_to_num(_in_f64(torch.pow, col.abs(), 2.2), nan=0.0, posinf=1.0, neginf=0.0)
    if return_t:
        return img, torch.where(hit[None], t_prim, LARGE)
    return img


def _fma(a, b, c):
    """a * b + c rounded once (through float64, where the product is exact)."""
    return (a.double() * b + c).float()


def _primary_rays(cam, width: int, height: int, y0: int, x0: int, h: int, w: int):
    """The (h, w, 3) directions of the tile's pixels (Render.fx:521), in the
    form XLA compiles JAX's _render_tile to on the CPU: the division by
    width folded into the constant 2 / width, each product fused with the
    sum that takes it (u = fma(x + 0.5, 2/width, -1), right*u fused into
    up*v, the squares of the norm summed by fma). The glass box's edges
    pick a face by a ray's last bit, and the eager form's rays, one ulp
    off, shade about 0.3% of JAX's values of a frame differently there
    (up to 0.57; tests/test_torch_render.py)."""
    dev = cam.device
    xs = x0 + torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    ys = y0 + torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    u = _fma(xs, _f32(np.float32(2.0) * (np.float32(1.0) / np.float32(width))), -1.0)
    v = _fma(ys, _f32(np.float32(-2.0) * (np.float32(1.0) / np.float32(height))), 1.0)
    d = _fma(u[None, :, None], cam[1], v[:, None, None] * cam[2]) + cam[3]
    s = _fma(d[..., 2], d[..., 2], _fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    return d / _sqrt(s)[..., None]


def _camera(device, *vectors):
    """The four camera vectors as one (4, 3) float32 tensor on device."""
    return torch.from_numpy(np.stack([np.asarray(v, np.float32) for v in vectors])).to(device)


def quirk_pixels(cam_pos, cam_right, cam_up, cam_fwd, width: int, height: int, device="cpu"):
    """The (height, width) mask of the reference's garbage pixels: the ray
    hits the glass and every glass bounce is total internal reflection
    (prim_alpha == 0; Render.fx:341-344 never sets the primary ray), so
    the shader reads the unset sentinels, and one ulp anywhere upstream
    changes their colour at will. Frames of two implementations are held
    against each other without them."""
    cam = _camera(torch.device(device), cam_pos, cam_right, cam_up, cam_fwd)
    ci = _primary_rays(cam, width, height, 0, 0, height, width)
    h, _, _, alpha, _ = trace_glass(cam[0].expand(ci.shape), ci)
    return (h < LARGE) & (alpha == 0.0)


def _render_tile(march, grad, cam, width: int, height: int, y0: int, x0: int, h: int, w: int,
                 **kw):
    """The (h, w) tile at rows [y0, y0+h), columns [x0, x0+w)."""
    ci = _primary_rays(cam, width, height, y0, x0, h, w)
    return shade(march, cam[0].expand(ci.shape), ci, grad_phi=grad, **kw)


def render(phi, cam_pos, cam_right, cam_up, cam_fwd, width: int, height: int,
           band_rows: int = 0, band_cols: int = 0, bounces: int = 2,
           interior_skip: bool = False, sphere_trace: bool = False,
           sphere_margin: float = SPHERE_MARGIN, sphere_scale: float = SPHERE_SCALE,
           sphere_spec: int = SPEC, overstep: float = 0.0, t_seed=None,
           seed_back: float = SEED_BACK, return_t: bool = False, coarse_seed: int = 0):
    """Render a (height, width, 3) float32 image of the level set ``phi``
    (a (nx, ny, nz) float32 tensor) on phi's device.

    The camera vectors are numpy float32 3-vectors as
    camera.OrbitCamera.frame gives them (FOV scaling folded into right/up).
    band_rows/band_cols > 0 render the frame in tiles, one after another,
    each with its own early exits (band_cols defaults to 100 when width is
    a multiple of 100, else the width); the image is the untiled one bit
    for bit. ``sphere_trace``: the inside march skips by the distance it
    read, on the deepened texture (render/interior.py); the surface
    normals come from the raw phi (the JAX renderer's, for grids of at
    most 144 cells an axis). ``overstep``: omega > 1 oversteps the outside
    march; 0 and 1 are the exact march. ``return_t``: also return the
    (3, height, width) march ts, to pass back as ``t_seed`` on the next
    frame if the camera did not move; each seeded march then starts
    ``seed_back`` cells before its previous t.

    ``interior_skip`` and ``coarse_seed`` > 1, measured dead in the JAX
    package, are not ported and raise ValueError."""
    if interior_skip:
        raise ValueError("interior_skip is left behind (measured dead); not ported")
    if coarse_seed > 1:
        raise ValueError("coarse_seed is left behind (measured dead); not ported")
    if phi.dtype != torch.float32 or phi.dim() != 3:
        raise ValueError(f"phi must be a 3D float32 tensor, got {phi.dtype} {tuple(phi.shape)}")
    dev = phi.device
    march = deepen_phi(phi) if sphere_trace else phi
    grad = phi if max(phi.shape) * 0.005 <= 0.72 else march
    cam = _camera(dev, cam_pos, cam_right, cam_up, cam_fwd)
    kw = dict(
        bounces=bounces,
        sphere=(_f32(sphere_margin), _f32(sphere_scale), sphere_spec) if sphere_trace else None,
        overstep=_f32(overstep) if overstep and overstep > 1.0 else None,
        seed_back=_f32(seed_back / phi.shape[0]) if (t_seed is not None or return_t) else None,
        return_t=return_t,
    )
    if sphere_trace and 128 % sphere_spec:
        raise ValueError(f"sphere_spec must divide 128, got {sphere_spec}")
    if t_seed is not None:
        t_seed = torch.as_tensor(t_seed, dtype=torch.float32, device=dev)
        if tuple(t_seed.shape) != (3, height, width):
            raise ValueError(f"t_seed must be (3, {height}, {width}), got {tuple(t_seed.shape)}")
    if band_rows <= 0 and band_cols <= 0:
        tile_h, tile_w = height, width
    else:
        tile_h = band_rows if 0 < band_rows <= height else height
        tile_w = band_cols if 0 < band_cols <= width else (100 if width % 100 == 0 else width)
    img = torch.empty(height, width, 3, device=dev)
    t_out = torch.empty(3, height, width, device=dev) if return_t else None
    for y0 in range(0, height, tile_h):
        for x0 in range(0, width, tile_w):
            h, w = min(tile_h, height - y0), min(tile_w, width - x0)
            seed = None if t_seed is None else t_seed[:, y0:y0 + h, x0:x0 + w]
            out = _render_tile(march, grad, cam, width, height, y0, x0, h, w, t_seed=seed, **kw)
            if return_t:
                out, t_out[:, y0:y0 + h, x0:x0 + w] = out
            img[y0:y0 + h, x0:x0 + w] = out
    return (img, t_out) if return_t else img


def render_frame(phi, cam_pos, cam_right, cam_up, cam_fwd, *, width: int, height: int,
                 band_rows: int = 0, band_cols: int = 0, bounces: int = 2,
                 interior_skip: bool = False, sphere_trace: bool = True,
                 sphere_margin: float = SPHERE_MARGIN, sphere_scale: float = SPHERE_SCALE,
                 sphere_spec: int = SPEC, overstep: float = 0.0, t_seed=None,
                 seed_back: float = SEED_BACK, return_t: bool = False, coarse_seed: int = 0):
    """One frame from the raw level set: ``render`` with the JAX entry's
    defaults (``sphere_trace`` on; measured bit-identical to the plain
    march on every tested scene, tests/test_render.py). The demo and
    tests/test_torch_cuda.py's card frames call this."""
    return render(phi, cam_pos, cam_right, cam_up, cam_fwd, width, height,
                  band_rows=band_rows, band_cols=band_cols, bounces=bounces,
                  interior_skip=interior_skip, sphere_trace=sphere_trace,
                  sphere_margin=sphere_margin, sphere_scale=sphere_scale,
                  sphere_spec=sphere_spec, overstep=overstep, t_seed=t_seed,
                  seed_back=seed_back, return_t=return_t, coarse_seed=coarse_seed)
