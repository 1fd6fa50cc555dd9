"""The port's renderer (fluidsimulation_tpu_torch/render/) against the JAX
package's on the CPU.

The JAX renderer is XLA with no Pallas kernel. Run op by op (eagerly), its
arithmetic is the port's: the camera, map_dist (JAX's packed texture
sample, map_dist_packed), the four-tap gradient (compute_gradient9),
deepen_phi and the distance transform are held bit for bit. Its loops
(lax.while_loop, fori_loop) and jitted frames are compiled programs, where
XLA fuses a product into the sum that takes it and folds a division by a
constant into a product; those drift from the port by an ulp here and
there, so the march is held within 1e-5 but for a few rays whose exit at
a threshold moved by one step (tests/test_wavefront.py's bound) and the
frames within 2e-4 but for a few values (its frame bound). Frames leave
out the quirk pixels, where every glass bounce is total internal
reflection and the reference shades unset rays (raytrace.quirk_pixels).
The port's own identities (tiles, the sphere-trace skip, overstep 1.0, a
huge seed backoff) are bit for bit, as tests/test_render.py holds JAX's.
The file compiles six JAX frames, at 32^3 and 80x60."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.render import camera as jcam
from fluidsimulation_tpu.render import interior as jint
from fluidsimulation_tpu.render import raytrace as jrt
from fluidsimulation_tpu.solver.step3d import step_jit

from fluidsimulation_tpu_torch.render import camera as tcam
from fluidsimulation_tpu_torch.render import interior as tint
from fluidsimulation_tpu_torch.render import raytrace as trt

W, H = 80, 60
GOLDEN_FRAME = "tests/golden/frame16_r1.npz"


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _jax_phi(n: int, steps: int, dt: float) -> np.ndarray:
    cfg = JaxConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n))
    state = jax_init(cfg)
    for _ in range(steps):
        state = step_jit(state, dt, cfg)
    return np.array(state.phi)


@pytest.fixture(scope="module")
def phi32():
    """The 32^3 dam break after three JAX steps of 1/120 s
    (tests/test_render.py's scene)."""
    return _jax_phi(32, 3, 1.0 / 120.0)


@pytest.fixture(scope="module")
def phi24():
    """The 24^3 dam break after three JAX steps of 1/60 s
    (tests/test_wavefront.py's scene)."""
    return _jax_phi(24, 3, 1.0 / 60.0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _rays(n, seed, inside_frac=0.4):
    """tests/test_wavefront.py::_rays's recipe: rays from outside the box
    and rays starting inside the water region."""
    rng = np.random.default_rng(seed)
    n_in = int(n * inside_frac)
    co_out = rng.uniform(-1.6, 1.6, size=(n - n_in, 3)).astype(np.float32)
    co_out[:, 2] -= 1.5
    co_in = rng.uniform(-0.45, 0.45, size=(n_in, 3)).astype(np.float32)
    co_in[:, 1] = rng.uniform(-0.49, -0.2, size=n_in)
    co = np.concatenate([co_out, co_in], axis=0)
    ci = rng.normal(size=(n, 3)).astype(np.float32)
    ci /= np.linalg.norm(ci, axis=1, keepdims=True)
    return co, ci


def _assert_close_mostly(a, b, atol, outlier_frac, outlier_max):
    """All but a few elements within atol; the few bounded by outlier_max
    (tests/test_wavefront.py's rule)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    frac = float((d > atol).mean())
    assert frac <= outlier_frac, f"{frac:.4%} elements beyond atol={atol} (max {d.max():.3e})"
    assert float(d.max()) <= outlier_max, f"outlier too large: {d.max():.3e}"


# -- camera, sampling, interior distance --------------------------------------

def test_camera_matches_jax_bit_for_bit():
    ours, theirs = tcam.OrbitCamera(), jcam.OrbitCamera()
    moves = [("frame", (800, 600)), ("orbit", (10.0, 5.0)), ("frame", (80, 60)),
             ("zoom", (3.0, 600)), ("frame", (32, 24)), ("orbit", (-400.0, 1e6)),
             ("zoom", (-250.0, 120)), ("frame", (161, 97)), ("reset", ()), ("frame", (48, 36))]
    for name, args in moves:
        a, b = getattr(ours, name)(*args), getattr(theirs, name)(*args)
        if name == "frame":
            for x, y in zip(a, b):
                assert x.dtype == np.float32 and _bits_equal(x, y)
        assert (ours.cam_phi, ours.cam_theta, ours.fov, ours.radius) == (
            theirs.cam_phi, theirs.cam_theta, theirs.fov, theirs.radius)


@pytest.mark.parametrize("shape", [(24, 24, 24), (16, 24, 20)])
def test_map_dist_matches_jax_packed_sampler(shape):
    """map_dist against JAX's map_dist_packed(PackedPhi(phi)), op by op, on
    20,000 points in [-0.05, 1.05]^3: bit for bit; and the plain texture
    sample against JAX's sample_phi."""
    rng = np.random.default_rng(7)
    phi = rng.normal(size=shape).astype(np.float32)
    pts = rng.uniform(-0.05, 1.05, size=(20000, 3)).astype(np.float32)
    want = jrt.map_dist_packed(jrt.PackedPhi(jnp.asarray(phi)), jnp.asarray(pts))
    assert _bits_equal(trt.map_dist(_t(phi), _t(pts)), want)
    assert _bits_equal(trt.sample_phi(_t(phi), _t(pts)),
                       jrt.sample_phi(jnp.asarray(phi), jnp.asarray(pts)))


def test_compute_gradient_matches_jax_gradient9(phi32):
    """The four-tap gradient at points within two cells of the surface
    against JAX's compute_gradient9 (one-row texture, documented as the
    four taps' arithmetic): bit for bit, the top-face override included."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.01, 0.99, size=(60000, 3)).astype(np.float32)
    near = np.abs(np.asarray(jrt.map_dist(jnp.asarray(phi32), jnp.asarray(pts)))) < 2.0 / 32
    pts = np.concatenate([pts[near][:5000], [[0.4, 0.9995, 0.6]]]).astype(np.float32)
    assert len(pts) > 1000
    want = jrt.compute_gradient9(jrt.PackedPhi9(jnp.asarray(phi32)), jnp.asarray(pts))
    got = trt.compute_gradient(lambda p: trt.map_dist(_t(phi32), p), _t(pts))
    assert _bits_equal(got, want)
    assert got[-1].tolist() == [0.0, 1.0, 0.0]


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 20, 9)])
def test_deepen_phi_matches_jax(shape):
    """Water below 70% of the height, deep enough to be deepened, with
    noise and a few dry nodes inside: the L1 distance transform and the
    deepened texture bit for bit."""
    rng = np.random.default_rng(5)
    y = np.arange(shape[1], dtype=np.float32)[None, :, None]
    phi = np.broadcast_to(y - 0.7 * shape[1], shape) + rng.normal(scale=0.3, size=shape)
    phi = np.where(rng.uniform(size=shape) < 0.01, 0.5, phi).astype(np.float32)
    got_l1, want_l1 = tint.l1_distance_to_nonneg(_t(phi)), jint.l1_distance_to_nonneg(jnp.asarray(phi))
    assert _bits_equal(got_l1, want_l1)
    got, want = tint.deepen_phi(_t(phi)), jint.deepen_phi(jnp.asarray(phi))
    assert _bits_equal(got, want)
    assert int((got.numpy() != phi).sum()) > 0  # some nodes were deepened


# -- geometry, sky, glass -----------------------------------------------------

def test_geometry_sky_and_glass_match_jax():
    """intersect_aabb, fresnel_tr (with total internal reflection),
    sample_environment and trace_glass on 777 mixed rays: atol 1e-6."""
    co, ci = _rays(777, seed=0)
    jco, jci, tco, tci = jnp.asarray(co), jnp.asarray(ci), _t(co), _t(ci)
    lo, hi = np.full(3, -0.52, np.float32), np.array([0.52, 0.5, 0.52], np.float32)
    pairs = list(zip(trt.intersect_aabb(tco, tci, _t(lo), _t(hi)),
                     jrt.intersect_aabb(jco, jci, jnp.asarray(lo), jnp.asarray(hi))))
    rng = np.random.default_rng(1)
    n = rng.normal(size=(777, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n1 = np.where(rng.uniform(size=777) < 0.5, 1.333, 1.0).astype(np.float32)
    n2 = np.where(n1 > 1.0, 1.0, 1.333).astype(np.float32)
    tir = 0
    for args in [(1.0, 1.5), (1.5, 1.0), (1.5, 1.333), (n1, n2)]:
        targs = tuple(_t(a) if isinstance(a, np.ndarray) else a for a in args)
        got = trt.fresnel_tr(tci, _t(n), *targs)
        pairs += list(zip(got, jrt.fresnel_tr(jci, jnp.asarray(n), *args)))
        tir += int((got[0] == 1.0).sum())
    assert tir > 0
    pairs.append((trt.sample_environment(tci), jrt.sample_environment(jci)))
    pairs += list(zip(trt.trace_glass(tco, tci), jrt.trace_glass(jco, jci)))
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6, err_msg=str(i))


def test_trace_floor_matches_jax():
    co, ci = _rays(300, seed=4)
    np.testing.assert_allclose(trt.trace_floor(_t(co), _t(ci)).numpy(),
                               np.asarray(jrt.trace_floor(jnp.asarray(co), jnp.asarray(ci))),
                               rtol=1e-6, atol=0)


# -- the water march ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "sphere"])
def test_intersect_water_matches_jax(phi24, mode):
    """intersect_water on 777 rays (tests/test_wavefront.py's batch), the
    exact march and the sphere-trace skip on the deepened texture: t and p
    within 1e-5 but for at most 0.2% of rays, and those within 0.1."""
    co, ci = _rays(777, seed=0)
    half = np.full(3, 0.5, np.float32)
    _, max_t, _, _ = jrt.intersect_aabb(jnp.asarray(co), jnp.asarray(ci), jnp.asarray(-half),
                                        jnp.asarray(half))
    march = phi24 if mode == "exact" else np.asarray(jint.deepen_phi(jnp.asarray(phi24)))
    if mode == "sphere":
        assert _bits_equal(tint.deepen_phi(_t(phi24)), march)
    sphere = (trt.SPHERE_MARGIN, trt.SPHERE_SCALE, trt.SPEC) if mode == "sphere" else None
    tex = jrt.PackedPhi(jnp.asarray(march))
    p_ref, t_ref = jrt.intersect_water(lambda p: jrt.map_dist_packed(tex, p),
                                       1.0 / jnp.float32(24), jnp.asarray(co), jnp.asarray(ci),
                                       max_t, sphere=sphere)
    p, t = trt.intersect_water(lambda p: trt.map_dist(_t(march), p), trt._f32(1.0 / 24), _t(co),
                               _t(ci), _t(max_t), sphere=sphere)
    _assert_close_mostly(t.numpy(), t_ref, 1e-5, 0.002, 0.1)
    _assert_close_mostly(p.numpy(), p_ref, 1e-5, 0.002, 0.1)


# -- frames -------------------------------------------------------------------

@pytest.mark.parametrize("sphere_trace", [False, True], ids=["render", "render_frame"])
@pytest.mark.parametrize("bounces", [2, 1, 0])
def test_frame_matches_jax(phi32, bounces, sphere_trace):
    """JAX's render (sphere trace off) and render_frame (on, its default)
    against the port's at 80x60: within 2e-4 but for at most 0.1% of the
    values, and those within 0.5, the quirk pixels left out."""
    cam = tcam.OrbitCamera().frame(W, H)
    if sphere_trace:
        want = jrt.render_frame(jnp.asarray(phi32), *cam, width=W, height=H, bounces=bounces)
        got = trt.render_frame(_t(phi32), *cam, width=W, height=H, bounces=bounces)
    else:
        want = jrt.render(jnp.asarray(phi32), *cam, W, H, bounces=bounces)
        got = trt.render(_t(phi32), *cam, W, H, bounces=bounces)
    quirk = trt.quirk_pixels(*cam, W, H).numpy()
    assert 0 < quirk.mean() < 0.1
    got = got.numpy()
    _assert_close_mostly(got[~quirk], np.asarray(want)[~quirk], 2e-4, 0.001, 0.5)
    assert np.isfinite(got).all() and np.clip(got, 0.0, 1.0).std() > 0.01


def test_golden_frame():
    """The port's render of the 16^3 one-step JAX phi at 48x36 against the
    golden frame JAX is held to (tests/test_units.py): atol 1e-4 on every
    pixel but the quirk pixels and one. That one, (33, 39), misses the
    water and leaves the glass through the box's bottom edge
    (x = 0.5, y = -0.5), where an ulp of the compiled JAX program's glass
    trace (fused multiply-adds) decides the face: its leaf ray is the
    reference's all-TIR garbage in the port (an infinite colour, bounded
    to 1.0) and not in JAX."""
    cfg = JaxConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)
    phi = np.array(step_jit(jax_init(cfg), 0.01, cfg).phi)
    cam = tcam.OrbitCamera().frame(48, 36)
    img = trt.render(_t(phi), *cam, 48, 36).numpy()
    keep = ~trt.quirk_pixels(*cam, 48, 36).numpy()
    assert int((~keep).sum()) == 97
    edge = (33, 39)
    keep[edge] = False
    assert img[edge].tolist() == [1.0, 1.0, 1.0]
    with np.load(GOLDEN_FRAME) as z:
        np.testing.assert_allclose(img[keep], z["img"][keep], rtol=0, atol=1e-4)


# -- the port's own identities ------------------------------------------------

def _frame(phi, **kw):
    return trt.render(_t(phi), *tcam.OrbitCamera().frame(W, H), W, H, **kw)


def test_tiles_equal_the_untiled_frame(phi32):
    """Tiles of 30x40, and ragged ones of 25 rows x 33 columns, give the
    untiled image and march ts bit for bit."""
    base, t_base = _frame(phi32, return_t=True)
    for tiles in [dict(band_rows=30, band_cols=40), dict(band_rows=25, band_cols=33)]:
        img, t = _frame(phi32, return_t=True, **tiles)
        assert torch.equal(img, base) and torch.equal(t, t_base), tiles


def test_sphere_trace_equals_exact_march(phi32):
    """The sphere-trace skip at the certified margin, and at scale 0, give
    the exact march's image bit for bit on the 32^3 scene."""
    base = _frame(phi32, band_rows=30, band_cols=40)
    assert torch.equal(_frame(phi32, band_rows=30, band_cols=40, sphere_trace=True), base)
    assert torch.equal(_frame(phi32, sphere_trace=True, sphere_scale=0.0), base)


def test_overstep_one_equals_exact_march(phi32):
    """render maps overstep 1.0 to the exact march; the overstep loop itself
    at omega = 1.0, driven through shade, gives the exact image too."""
    base = _frame(phi32)
    assert torch.equal(_frame(phi32, overstep=1.0), base)
    cam = trt._camera(torch.device("cpu"), *tcam.OrbitCamera().frame(W, H))
    ci = trt._primary_rays(cam, W, H, 0, 0, H, W)
    co = cam[0].expand(ci.shape)
    plain = trt.shade(_t(phi32), co, ci)
    assert torch.equal(plain, base)
    assert torch.equal(trt.shade(_t(phi32), co, ci, overstep=1.0), plain)


def test_huge_seed_back_equals_cold_march(phi32):
    """A seed backoff past the grid's diameter is the cold march, bit for
    bit, at bounces 2 and 1."""
    for bounces in (2, 1):
        cold, t0 = _frame(phi32, band_rows=30, band_cols=40, bounces=bounces, return_t=True)
        huge = _frame(phi32, band_rows=30, band_cols=40, bounces=bounces, t_seed=t0.numpy(),
                      seed_back=1000.0)
        assert torch.equal(cold, huge), bounces


def test_return_t_planes(phi32):
    """return_t: (3, H, W) march ts, finite, LARGE on every glass-miss pixel;
    at bounces 1 the two child planes are LARGE."""
    cam = tcam.OrbitCamera().frame(W, H)
    ci = trt._primary_rays(trt._camera(torch.device("cpu"), *cam), W, H, 0, 0, H, W)
    h = trt.trace_glass(_t(cam[0]).expand(ci.shape), ci)[0]
    miss = h >= trt.LARGE
    assert 0 < int(miss.sum()) < miss.numel()
    for bounces in (2, 1):
        _, t = _frame(phi32, bounces=bounces, return_t=True)
        assert t.shape == (3, H, W) and bool(t.isfinite().all())
        assert bool((t[:, miss] == trt.LARGE).all())
        assert bool((t[0, ~miss] < trt.LARGE).any())
        if bounces == 1:
            assert bool((t[1:] == trt.LARGE).all())


@pytest.mark.parametrize("kw, match", [
    (dict(interior_skip=True), "interior_skip"),
    (dict(coarse_seed=2), "coarse_seed"),
    (dict(bounces=0, return_t=True), "bounces=0"),
    (dict(t_seed=np.zeros((3, 2, 2), np.float32)), "t_seed"),
])
def test_left_behind_and_bad_arguments_raise(kw, match):
    phi = torch.zeros(8, 8, 8)
    with pytest.raises(ValueError, match=match):
        trt.render(phi, *tcam.OrbitCamera().frame(8, 6), 8, 6, **kw)
