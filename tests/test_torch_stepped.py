"""The port's steps on stepped dam-break states, on the CPU and on the card.

On both devices: a dam break stepped a few times keeps every position
inside advection's clamp box, [-0.4/m, 1 - 0.6/m] on each axis (m the
axis's cells a meter), and lowers the particles' mean height, in each
family (FLIP, APIC, 2D FLIP, 2D APIC); one NaN position stays that
particle's alone (the NaN rule) in each family; two steps of one state give
the same bits (FLIP, APIC). The card runs the demo's grid (64^3 or 64^2, 2
particles a cell axis), the CPU 12^3 or 12^2.

On the CPU: one step of each 3D family under utils/profiling.py::hooked
reaches each kernel-wrapper site of SITES as often as the card test below
expects (a site renamed away would leave that test nothing to hold).

Marked ``cuda`` (skipped without a card; ``python -m pytest
tests/test_torch_stepped.py -m cuda -q``): the demo's dam break (64^3, 2
particles a cell axis, dt 1/120) stepped 60 times on the card, by FLIP and
by APIC. On the last step each wrapper's arguments are kept, and each
kernel is held to its plain version on them: the 27-neighbourhood pass, the
sweeps, the SOR, the FLIP gather and the RK3 gather (its last call, stage
3) bit for bit; the FLIP P2G within tests/test_torch_cuda.py's bound (it
sums in another order than index_add_); the APIC P2G within the bound of
reordering each face's sum; the combined-key pack, on the grids of that
step, bit for bit. Two launches on the same arguments give the same bits.
Every step launches each kernel the expected number of times (LAUNCHES).
"""

import math

import pytest
import torch

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core import cuda_pack
from fluidsimulation_tpu_torch.core.interp import interp_mac3_vec as interp_plain
from fluidsimulation_tpu_torch.ops import (
    cuda_g2p,
    cuda_interp,
    cuda_p2g,
    cuda_p2g_apic,
    cuda_seed,
    cuda_sor,
    cuda_sweep,
)
from fluidsimulation_tpu_torch.ops.apic import (
    APIC_WEIGHT_THRESH,
    _component_nodes,
    _shapes,
    p2g_apic,
    p2g_apic_cells,
)
from fluidsimulation_tpu_torch.ops.common import cell_scale
from fluidsimulation_tpu_torch.utils.profiling import hooked

DEMO_STEPS = 60  # the demo's run: 64^3, ppc 2, dt 1/60 at rate 0.5
DEMO_DT = 1.0 / 120.0
SIZE = {"cpu": 12, "cuda": 64}  # cells a side of the clamp-box and determinism cases
STEPS = 4

# The kernel wrappers, where the step's code looks each one up, under the
# key the card test holds it by.
SITES = [
    ("ops.levelset", "neighborhood_pass", "seed"),
    ("ops.levelset", "sweep_closest", "sweep"),
    ("ops.p2g", "p2g_accumulate", "p2g"),
    ("ops.project", "sor_pressure", "sor"),
    ("ops.flip", "g2p_flip", "g2p"),
    ("ops.advect", "interp_mac3_vec", "interp"),
    ("solver.apic", "p2g_apic", "p2g_apic"),
]
# Calls of each site in one step; FLIP carries k1, so RK3 gathers twice.
CALLS = {
    "flip": {"seed": 1, "sweep": 1, "p2g": 1, "sor": 1, "g2p": 1, "interp": 2, "p2g_apic": 0},
    "apic": {"seed": 1, "sweep": 1, "p2g": 0, "sor": 1, "g2p": 0, "interp": 2, "p2g_apic": 1},
}
MODULES = (cuda_seed, cuda_sweep, cuda_p2g, cuda_sor, cuda_g2p, cuda_interp, cuda_pack,
           cuda_p2g_apic)
# Launches of each kernel in one step on the card (MODULES' order): the 24
# sweeps are one C call; no step packs the combined table.
LAUNCHES = {"flip": [1, 1, 1, 1, 1, 2, 0, 0], "apic": [1, 1, 0, 1, 0, 2, 0, 1]}
BAD = 5  # the particle given a NaN position
# The rows a NaN position leaves non-finite (APIC's spline weights of a NaN
# distance are 0, so its velocity stays finite).
NAN_ROWS = {"flip": ("pos", "vel"), "apic": ("pos", "C"), "flip2d": ("pos", "vel"),
            "apic2d": ("pos", "C")}
FAMILIES = {  # init, step, 2D
    "flip": (ft.init_state, ft.step, False),
    "apic": (ft.init_apic_state, ft.step_apic, False),
    "flip2d": (ft.init_state2d, ft.step2d, True),
    "apic2d": (ft.init_apic_state2d, ft.step_apic2d, True),
}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _config(n: int, two_d: bool):
    if two_d:
        return ft.SimConfig2D(nx=n, ny=n, cells_per_meter=float(n))
    return ft.SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n), particles_per_cell_axis=2)


def _fields(state) -> dict:
    return {k: v for k, v in vars(state).items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dam_break_stays_in_the_clamp_box_and_falls(device, family):
    init, step, two_d = FAMILIES[family]
    cfg = _config(SIZE[device], two_d)
    s = init(cfg, device)
    y0 = float(s.pos[:, 1].mean())
    for _ in range(STEPS):
        s = step(s, DEMO_DT, cfg)
    dims = (cfg.nx, cfg.ny) if two_d else (cfg.nx, cfg.ny, cfg.nz)
    m = torch.tensor(dims, dtype=torch.float32, device=device)
    lo, hi = -0.4 / m, 1.0 - 0.6 / m
    assert bool(((s.pos >= lo - 1e-6) & (s.pos <= hi + 1e-6)).all())
    for name, t in _fields(s).items():
        assert bool(t.isfinite().all()), name
    assert float(s.pos[:, 1].mean()) < y0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_nan_position_stays_in_its_row(device, family):
    """The NaN rule: particle BAD's x is NaN; two steps raise nothing, leave
    its rows of NAN_ROWS non-finite and no other particle's, and every grid
    finite."""
    init, step, two_d = FAMILIES[family]
    cfg = _config(SIZE[device], two_d)
    s = init(cfg, device)
    s.pos[BAD, 0] = float("nan")
    for _ in range(2):
        s = step(s, DEMO_DT, cfg)
    n = s.pos.shape[0]
    for name, t in _fields(s).items():
        if t.shape[0] != n:
            assert bool(t.isfinite().all()), name
            continue
        rows = (~t.reshape(n, -1).isfinite().all(1)).nonzero().flatten().tolist()
        assert rows == [BAD] if name in NAN_ROWS[family] else rows in ([], [BAD]), name


@pytest.mark.parametrize("family", ["flip", "apic"])
def test_step_is_deterministic(device, family):
    init, step, _ = FAMILIES[family]
    cfg = _config(SIZE[device], False)
    s = init(cfg, device)
    for _ in range(2):
        s = step(s, DEMO_DT, cfg)
    a, b = _fields(step(s, DEMO_DT, cfg)), _fields(step(s, DEMO_DT, cfg))
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("family", ["flip", "apic"])
def test_hooked_reaches_every_kernel_wrapper(family):
    init, step, _ = FAMILIES[family]
    cfg = _config(SIZE["cpu"], False)
    s = init(cfg, "cpu")
    calls = {key: 0 for _, _, key in SITES}

    def count(key, orig, args):
        calls[key] += 1
        return orig(*args)

    with hooked(SITES, count):
        step(s, DEMO_DT, cfg)
    assert calls == CALLS[family]


@pytest.fixture(scope="module", params=["flip", "apic"])
def stepped(request):
    """The demo's dam break stepped DEMO_STEPS times on the card: the
    family, its config, each step's launches (MODULES' order) and the last
    step's arguments to each wrapper of SITES."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    family = request.param
    init, step, _ = FAMILIES[family]
    cfg = _config(64, False)
    s = init(cfg, "cuda")
    launches, captured = [], {}

    def keep(key, orig, args):
        captured[key] = args
        return orig(*args)

    for i in range(DEMO_STEPS):
        before = [m.KERNEL.launches for m in MODULES]
        if i == DEMO_STEPS - 1:
            with hooked(SITES, keep):
                s = step(s, DEMO_DT, cfg)
        else:
            s = step(s, DEMO_DT, cfg)
        torch.cuda.synchronize()
        launches.append([m.KERNEL.launches - b for m, b in zip(MODULES, before)])
    assert all(bool(t.isfinite().all()) for t in _fields(s).values())
    return family, cfg, launches, captured


def _p2g_close(cfg, got, want):
    """tests/test_torch_cuda.py's P2G bound: validity equal except within
    1e-6 of the threshold; rtol = atol = 2e-4 on faces valid in both."""
    for (acc_k, amt_k), (acc_p, amt_p) in zip(got, want):
        near = (amt_p - cfg.zero_thresh).abs() < 1e-6
        valid_k, valid_p = amt_k > cfg.zero_thresh, amt_p > cfg.zero_thresh
        assert not bool(((valid_k != valid_p) & ~near).any())
        both = valid_k & valid_p
        torch.testing.assert_close((acc_k / amt_k)[both], (acc_p / amt_p)[both],
                                   rtol=2e-4, atol=2e-4)


def _apic_sums(cfg, pc, vel, C, m):
    """For each component of the APIC P2G, formed as p2g_apic_cells forms
    it: each face's weight sum, its sum of w |value| and its count of
    terms."""
    out = []
    for comp_axis, shape in _shapes(cfg):
        _, sy, sz = shape
        amt, sabs, terms = (torch.zeros(math.prod(shape), device=pc.device) for _ in range(3))
        crow = C[:, comp_axis, :]
        for idx, ok, w, dxm in _component_nodes(cfg, pc, comp_axis, m):
            lin = torch.where(ok, (idx[0] * sy + idx[1]) * sz + idx[2], 0)
            val = (vel[:, comp_axis] + crow[:, 0] * dxm[0] + crow[:, 1] * dxm[1]
                   + crow[:, 2] * dxm[2])
            amt.index_add_(0, lin, torch.where(ok, w, 0.0))
            sabs.index_add_(0, lin, torch.where(ok, w * val.abs(), 0.0))
            terms.index_add_(0, lin, ok.float())
        out.append(tuple(t.reshape(shape) for t in (amt, sabs, terms)))
    return out


def _apic_reordered(cfg, args, got, want):
    """Validity equal except within 1e-6 of the threshold, the same faces
    non-finite, and on faces valid in both the difference 0 or within what
    reordering a face's sum of n terms can move it: 4 n u (sum of w
    |value|) / (sum of w), u = 2^-24 (NaN on the boundary faces, 0 and
    valid by rule, where no weight lands)."""
    _, pos, vel, C = args
    m = cell_scale(cfg, pos.device)
    for g, b, vg, vb, (amt, sabs, terms) in zip(got[:3], want[:3], got[3:], want[3:],
                                               _apic_sums(cfg, pos * m, vel, C, m)):
        near = (amt - APIC_WEIGHT_THRESH).abs() < 1e-6
        assert not bool(((vg != vb) & ~near).any())
        assert torch.equal(g.isfinite(), b.isfinite())
        both = vg & vb & b.isfinite()
        d = (g - b).abs()[both]
        limit = 4 * terms[both] * 2.0**-24 * sabs[both] / amt[both]
        assert bool(((d == 0) | (d <= limit)).all())


def _apic_plain(cfg, pos, vel, C):
    m = cell_scale(cfg, pos.device)
    return p2g_apic_cells(cfg, pos * m, vel, C, m)


# key -> (the wrapper, its plain version); None: held by its own bound.
PLAIN = {
    "seed": (cuda_seed.neighborhood_pass, cuda_seed.neighborhood_pass_plain),
    "sweep": (cuda_sweep.sweep_closest, cuda_sweep.sweep_closest_plain),
    "p2g": (cuda_p2g.p2g_accumulate, lambda cfg, pcs, vels, start:
            cuda_p2g.p2g_accumulate_plain(cfg, pcs, vels)),
    "sor": (cuda_sor.sor_pressure, cuda_sor.sor_pressure_plain),
    "g2p": (cuda_g2p.g2p_flip, cuda_g2p.g2p_flip_plain),
    "interp": (cuda_interp.interp_mac3_vec, interp_plain),
    "p2g_apic": (p2g_apic, _apic_plain),
}


def _flat(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in _flat(part)]


@pytest.mark.cuda
def test_kernels_hold_to_their_plain_versions_on_stepped_state(stepped):
    family, cfg, _, captured = stepped
    keys = [k for k, n in CALLS[family].items() if n]
    assert sorted(captured) == sorted(keys)
    for key in keys:
        wrapper, plain = PLAIN[key]
        args = captured[key]
        got, again, want = wrapper(*args), wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(again))), key
        if key == "p2g":
            _p2g_close(cfg, got, want)
        elif key == "p2g_apic":
            _apic_reordered(cfg, args, got, want)
        else:
            assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(want))), key
    grids = captured["interp"][:3]
    tab = cuda_pack.pack_mac3_combined(*grids).view(torch.int32)
    assert torch.equal(tab, cuda_pack.pack_mac3_combined_plain(*grids).view(torch.int32))
    assert torch.equal(tab, cuda_pack.pack_mac3_combined(*grids).view(torch.int32))


@pytest.mark.cuda
def test_launches_per_step(stepped):
    family, _, launches, _ = stepped
    assert launches == [LAUNCHES[family]] * DEMO_STEPS
    totals = [sum(col) for col in zip(*launches)]
    assert all(t > 0 for t, n in zip(totals, LAUNCHES[family]) if n)
