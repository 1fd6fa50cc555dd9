"""The RK3 advection's grid gather (ops/cuda_interp.py, csrc/interp.cu)
against the plain chain it stands in for on the card,
core/interp.py::interp_mac3_vec.

On the CPU (no card needed): the wrapper is the plain version, bit for bit,
and launches nothing; it raises on what the kernel does not take (float64
or non-contiguous tensors, positions not (N, 3), grids that are not MAC
grids, an axis of fewer than 2 cells) on either device; and
``ops.advect.interp_mac3_vec`` is the name the RK3 stages look up at each
call, once a gathered stage: 3 calls without k1, 2 with it, 2 for APIC.

Marked ``cuda`` (skipped without a card; ``python -m pytest
tests/test_torch_interp_kernel.py -m cuda -q``): the kernel equals the plain
chain on the same card tensors bit for bit (``torch.equal``; where a
coordinate is NaN, that particle's row is NaN in both and the other rows
equal): random positions in 32^3 grids, a 24 x 16 x 40 grid and an 8 x 64 x
64 slab, positions outside the domain and on each top edge, NaN and +-inf
coordinates, N = 0 and N not a multiple of the block; a whole
``advect_rk3_cached`` and ``advect_rk3_pic`` on the 64^3 dam break after
three steps, against the same calls through the plain chain; the FLIP
gather (csrc/g2p.cu, whose interpolation helpers now live in common.cuh)
still its plain version's bits; one launch a call, and a step's launches
its gathered stages: 2 with k1, 3 without, 2 an APIC step.
"""

import numpy as np
import pytest
import torch

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core import interp
from fluidsimulation_tpu_torch.ops import advect, cuda_g2p, cuda_interp
from fluidsimulation_tpu_torch.ops.binning import build_csr, sort_particles


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _grids(shape, seed):
    """Random u, v, w MAC grids of shape (nx, ny, nz) cells."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]


def _positions(shape, n, seed, margin=2.0):
    """n positions in cell units, uniform over the grid grown by ``margin``
    cells on every side (so some lie outside the domain)."""
    rng = np.random.default_rng(seed)
    hi = np.array(shape, dtype=np.float32) + margin
    return torch.from_numpy(rng.uniform(-margin, hi, size=(n, 3)).astype(np.float32))


def _edges(shape):
    """Positions on and past each axis's edges: below 0, 0, -0.5 (the
    staggered axis's lower clamp), m-2, m-1 (the normal axis's cap), m-0.5,
    m (the staggered cap), past m; the other two axes at a cell's interior."""
    rows = []
    for axis, m in enumerate(shape):
        for c in (-3.0, -0.5, -0.0, 0.0, 0.25, m - 2.0, m - 1.5, m - 1.0, m - 0.5,
                  np.nextafter(np.float32(m - 1), np.float32(0)), m - 0.25, float(m), m + 0.5,
                  m + 7.0):
            p = [1.3, 0.7, 1.6]
            p[axis] = c
            rows.append(p)
    return torch.tensor(rows, dtype=torch.float32)


def _same(a, b):
    """Equal bits where finite; NaN in the same places."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def _on_card(dev, grids, pos):
    """The kernel and the plain chain on the same card tensors, and the
    kernel's launches."""
    g = [t.to(dev) for t in grids]
    p = pos.to(dev)
    before = cuda_interp.KERNEL.launches
    got = cuda_interp.interp_mac3_vec(*g, p)
    torch.cuda.synchronize()
    assert cuda_interp.KERNEL.launches - before == 1
    return got, interp.interp_mac3_vec(*g, p)


class _Counting:
    """Stands in for ops.advect.interp_mac3_vec: counts the calls and
    passes them on."""

    def __init__(self):
        self.calls = 0

    def __call__(self, u, v, w, pos_cells):
        self.calls += 1
        return cuda_interp.interp_mac3_vec(u, v, w, pos_cells)


# --- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 9, 7)], ids=["8", "5x9x7"])
def test_cpu_wrapper_is_the_plain_version(shape):
    grids = _grids(shape, 1)
    pos = torch.cat([_positions(shape, 500, 2), _edges(shape)])
    before = cuda_interp.KERNEL.launches
    got = cuda_interp.interp_mac3_vec(*grids, pos)
    assert cuda_interp.KERNEL.launches == before
    assert torch.equal(got, interp.interp_mac3_vec(*grids, pos))


def _bad_arguments(device="cpu"):
    """Each made on ``device`` (moving a strided view would copy it whole)."""
    u, v, w = (g.to(device) for g in _grids((4, 5, 6), 3))
    pos = _positions((4, 5, 6), 10, 4).to(device)
    return {
        "pos-float64": (u, v, w, pos.double()),
        "pos-non-contiguous": (u, v, w, torch.cat([pos, pos], 1)[:, ::2]),
        "pos-transposed": (u, v, w, pos.t().contiguous().t()),
        "pos-flat": (u, v, w, pos.reshape(-1)),
        "pos-4-columns": (u, v, w, torch.cat([pos, pos[:, :1]], 1)),
        "grid-float64": (u.double(), v, w, pos),
        "grid-non-contiguous": (u, v.transpose(0, 2).contiguous().transpose(0, 2), w, pos),
        "grids-mismatched": (u, v[:, :, :-1].contiguous(), w, pos),
        "grid-of-one-cell": (u[:2, :1, :1].contiguous(), v[:1, :2, :1].contiguous(),
                             w[:1, :1, :2].contiguous(), pos),
    }


@pytest.mark.parametrize("case", list(_bad_arguments()))
def test_wrapper_rejects_bad_arguments(case):
    with pytest.raises(ValueError):
        cuda_interp.interp_mac3_vec(*_bad_arguments()[case])


def _advect_run(family):
    """One RK3 advection of 300 particles in random 8^3 grids, and the
    gathers it makes."""
    cfg = ft.SimConfig(nx=8, ny=8, nz=8, cells_per_meter=8.0)
    u, v, w = _grids((8, 8, 8), 5)
    rng = np.random.default_rng(6)
    pos = torch.from_numpy(rng.uniform(0.1, 0.9, size=(300, 3)).astype(np.float32))
    k1 = torch.from_numpy(rng.standard_normal((300, 3)).astype(np.float32))
    return {
        "flip-k1": (lambda: advect.advect_rk3_cached(cfg, u, v, w, k1, pos, 0.01), 2),
        "flip-no-k1": (lambda: advect.advect_rk3(cfg, u, v, w, pos, 0.01), 3),
        "apic": (lambda: advect.advect_rk3_pic(cfg, u, v, w, pos, k1, 0.01), 2),
    }[family]


def _step_run(family):
    """One whole 12^3 step of the dam break, and the gathers it makes."""
    cfg = ft.SimConfig(nx=12, ny=12, nz=12, cells_per_meter=12.0)
    if family == "apic":
        s = ft.init_apic_state(cfg, "cpu")
        return (lambda: ft.step_apic(s, 0.01, cfg).pos), 2
    s = ft.init_state(cfg, "cpu", with_cache=family == "flip-k1")
    return (lambda: ft.step(s, 0.01, cfg).pos), 2 if family == "flip-k1" else 3


@pytest.mark.parametrize("scope", ["advect", "step"])
@pytest.mark.parametrize("family", ["flip-k1", "flip-no-k1", "apic"])
def test_rk3_looks_up_the_gather_at_each_call(monkeypatch, scope, family):
    """ops.advect.interp_mac3_vec is the wrapper, and _rk3 finds it by name
    at each call: a function set there in its place takes every gathered
    stage, 2 with k1, 3 without, 2 in APIC (what the benchmark's
    flip_gather site table relies on), and the answer is unchanged; in a
    whole step each call's arguments pass the kernel's checks."""
    assert advect.interp_mac3_vec is cuda_interp.interp_mac3_vec
    run, calls = (_advect_run if scope == "advect" else _step_run)(family)
    want = run()
    counting = _Counting()
    monkeypatch.setattr(advect, "interp_mac3_vec", counting)
    assert torch.equal(run(), want)
    assert counting.calls == calls


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 32), (24, 16, 40), (8, 64, 64)],
                         ids=["32", "24x16x40", "slab-8x64x64"])
def test_kernel_bit_exact_random(dev, shape):
    got, want = _on_card(dev, _grids(shape, 7), _positions(shape, 100_003, 8))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 32), (24, 16, 40)], ids=["32", "24x16x40"])
def test_kernel_bit_exact_at_the_edges(dev, shape):
    got, want = _on_card(dev, _grids(shape, 9), _edges(shape))
    assert got.isfinite().all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("value", [float("nan"), float("inf"), float("-inf")],
                         ids=["nan", "inf", "-inf"])
def test_kernel_non_finite_coordinates(dev, value):
    """NaN in any coordinate: that particle's row is NaN, every other row is
    the plain chain's bits; +-inf clamps to the edge as the chain does."""
    shape = (32, 32, 32)
    pos = _positions(shape, 1_000, 10)
    bad = [3, 400, 999]
    for axis, row in enumerate(bad):
        pos[row, axis] = value
    got, want = _on_card(dev, _grids(shape, 11), pos)
    if value != value:
        assert got[bad].isnan().all() and want[bad].isnan().all()
        keep = torch.ones(pos.shape[0], dtype=torch.bool, device=dev)
        keep[bad] = False
        assert got[keep].isfinite().all()
        assert torch.equal(got[keep], want[keep])
        assert _same(got, want)
    else:
        assert got.isfinite().all()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 33, 255, 257, 1_000], ids=str)
def test_kernel_partial_blocks(dev, n):
    shape = (16, 16, 16)
    got, want = _on_card(dev, _grids(shape, 12), _positions(shape, n, 13))
    assert got.shape == (n, 3)
    assert torch.equal(got, want)


def _stepped(dev, init, step, n_steps=3):
    cfg = ft.SimConfig(nx=64, ny=64, nz=64, cells_per_meter=64.0, particles_per_cell_axis=2)
    s = init(cfg, dev)
    for _ in range(n_steps):
        s = step(s, 1.0 / 120.0, cfg)
    torch.cuda.synchronize()
    return cfg, s


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["flip", "apic"])
def test_advect_matches_the_plain_chain(dev, monkeypatch, family):
    """One whole RK3 advection of the 64^3 dam break (ppc 2, after 3 steps)
    through the kernel and through the plain chain (the gather before the
    kernel): the same positions, bit for bit; 2 launches."""
    if family == "flip":
        cfg, s = _stepped(dev, ft.init_state, ft.step)
        run = lambda: advect.advect_rk3_cached(cfg, s.u, s.v, s.w, s.k1, s.pos, 1.0 / 120.0)  # noqa: E731
    else:
        cfg, s = _stepped(dev, ft.init_apic_state, ft.step_apic)
        run = lambda: advect.advect_rk3_pic(cfg, s.u, s.v, s.w, s.pos, s.vel, 1.0 / 120.0)  # noqa: E731
    assert float(s.u.abs().max()) > 0.0
    before = cuda_interp.KERNEL.launches
    got = run()
    torch.cuda.synchronize()
    assert cuda_interp.KERNEL.launches - before == 2
    monkeypatch.setattr(advect, "interp_mac3_vec", interp.interp_mac3_vec)
    want = run()
    assert not torch.equal(got, s.pos)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_g2p_flip_unchanged(dev):
    """The FLIP gather on the 64^3 dam break's last step inputs, after its
    interpolation helpers moved to common.cuh: its plain version's bits."""
    cfg, s = _stepped(dev, ft.init_state, ft.step)
    csr = build_csr(cfg, s.pos)
    walk = sort_particles(cfg, csr, s.pos, s.vel)
    old = [g * 0.5 for g in (s.u, s.v, s.w)]
    args = (cfg, csr.order, walk.pcs, walk.vels, s.u, s.v, s.w, *old, 0.05)
    got = cuda_g2p.g2p_flip(*args)
    want = cuda_g2p.g2p_flip_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["flip-k1", "flip-no-k1", "apic"])
def test_step_launches_once_a_gathered_stage(dev, family):
    cfg = ft.SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    if family == "apic":
        s, step, want = ft.init_apic_state(cfg, dev), ft.step_apic, 2
    else:
        s, step = ft.init_state(cfg, dev, with_cache=family == "flip-k1"), ft.step
        want = 2 if family == "flip-k1" else 3
    before = cuda_interp.KERNEL.launches
    step(s, 1.0 / 60.0, cfg)
    torch.cuda.synchronize()
    assert cuda_interp.KERNEL.launches - before == want


@pytest.mark.cuda
def test_wrapper_rejects_bad_arguments_on_card(dev):
    for args in _bad_arguments(dev).values():
        with pytest.raises(ValueError):
            cuda_interp.interp_mac3_vec(*args)
    u, v, w = (g.to(dev) for g in _grids((4, 5, 6), 3))
    with pytest.raises(ValueError):  # positions on another device
        cuda_interp.interp_mac3_vec(u, v, w, _positions((4, 5, 6), 10, 4))
