"""The port's multi-rank family (fluidsimulation_tpu_torch/parallel/) on
the CPU: one world of 4 gloo ranks for the module, against the port's
one-device steps and the JAX package.

The ranks are processes spawned by parallel/comm.py's Ranks; they import
the port and never JAX (checked). What they run lives in
parallel/runs.py. Marked ``cuda``, a second world of 4 gloo ranks shares
the card (NCCL takes one rank a card) and runs the FLIP and APIC halo steps
at 128^3 and the halo SOR against the one-device steps and solve on the
card, each rank's slab on the hand kernels; a world of one NCCL rank runs
the FLIP halo step. Bounds are the JAX package's own for the same
comparisons (tests/test_parallel.py): the FLIP steps pos 1e-6 and the rest
1e-4 after 2 steps, the APIC steps pos 1e-6, vel and grids 1e-5, C 1e-4,
the halo SOR 1e-5. Held to the port's own one-device steps they are
tighter: bit for bit, since each rank's stages see the particles in the
domain's frame (the kernels take the slab's x origin) in the one-device
order.
"""

import numpy as np
import pytest
import torch

import jax

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.ops import levelset as jax_levelset
from fluidsimulation_tpu.ops import project as jax_project
from fluidsimulation_tpu.parallel.halo import sor_pressure_sharded as jax_sor_sharded
from fluidsimulation_tpu.parallel.halo import x_sharding
from fluidsimulation_tpu.parallel.sharding import make_mesh as jax_make_mesh
from fluidsimulation_tpu.solver.step3d import step_jit

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch import _build
from fluidsimulation_tpu_torch.ops.cuda_sor import sor_pressure
from fluidsimulation_tpu_torch.ops.project import compute_diag, compute_rhs
from fluidsimulation_tpu_torch.parallel import comm, runs
from fluidsimulation_tpu_torch.parallel.halo_apic import default_apic_capacity
from fluidsimulation_tpu_torch.parallel.halo_step import default_capacity

D = 4
DT = 0.01
STEPS = 2
FLIP_BOUNDS = {"pos": 1e-6}  # the rest 1e-4
APIC_BOUNDS = {"pos": 1e-6, "C": 1e-4}  # the rest 1e-5
SIZES = {16: 10_976, 24: 42_592}
CARD_N = 128  # the card's halo steps: 1,000,188 particles, 250,047 a rank
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _cfgs(n):
    kw = dict(nx=n, ny=n, nz=n, cells_per_meter=float(n))
    return ft.SimConfig(**kw), JaxConfig(**kw)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    """One world of 4 gloo ranks on the CPU for the whole module; every call
    on it has a deadline, and a rank that fails fails the call."""
    with comm.Ranks(D, "gloo", "cpu", timeout=120.0) as world:
        yield world


@pytest.fixture(scope="module")
def card_ranks():
    """4 gloo ranks sharing the one card, for the module's card cases; the
    kernels are built once before the ranks start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _build.build()
    with comm.Ranks(D, "gloo", "cuda", timeout=120.0) as world:
        yield world


def _world(request, device):
    return request.getfixturevalue("card_ranks" if device == "cuda" else "ranks")


def _launches(device, family):
    """Each rank's kernel launches a step: none on the CPU; on the card the
    pass, P2G and the FLIP gather once (P2G and the gather not in APIC),
    the y/z sweeps in 8 calls, the 8 relayed x-sweeps, 2 x 100 SOR
    half-updates and the RK3 gather once a gathered stage (3 in FLIP, which
    advects without k1; 2 in APIC); the whole-grid SOR and the pack never."""
    if device == "cpu":
        return dict.fromkeys(runs.launches(), 0)
    flip = family == "flip"
    return {"fst_neighborhood_pass": 1, "fst_sweeps": 8, "fst_sweep_x_carry": 8,
            "fst_p2g": int(flip), "fst_sor": 0, "fst_sor_half": 200,
            "fst_g2p_flip": int(flip), "fst_pack_mac3_combined": 0,
            "fst_interp_mac3": 3 if flip else 2}


@pytest.fixture(scope="module")
def flip_runs(ranks):
    """The FLIP halo step, 2 steps, at 16^3 and 24^3."""
    return {n: ranks.run(runs.halo_run, "flip", _cfgs(n)[0], STEPS, DT, deadline=300.0)
            for n in SIZES}


def _port_steps(family, cfg, n_steps, device="cpu", dt=DT):
    state = runs.whole_state(family, cfg, device)
    fn = ft.step_apic if family == "apic" else ft.step
    for _ in range(n_steps):
        state = fn(state, dt, cfg)
    return state


def _held(got: dict, want, bounds: dict, rest: float) -> dict:
    diffs = {}
    for name, arr in got.items():
        ref = getattr(want, name)
        ref = ref.cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
        diffs[name] = float(np.abs(arr - ref).max())
        assert diffs[name] <= bounds.get(name, rest), (name, diffs[name])
    return diffs


@pytest.mark.parametrize("n", sorted(SIZES))
def test_flip_halo_step_matches_port_and_jax(flip_runs, n):
    """After 2 steps the gathered state is the port's one-device step's bit
    for bit, and JAX's exact step's within pos 1e-6, the rest 1e-4; no
    particle dropped at the default capacity."""
    cfg, jcfg = _cfgs(n)
    assert cfg.num_particles == SIZES[n]
    res = flip_runs[n]
    got = res[0]["state"]
    assert sorted(got) == ["phi", "pos", "u", "v", "vel", "w"]
    _held(got, _port_steps("flip", cfg, STEPS), {}, 0.0)
    j = jax_init(jcfg)
    for _ in range(STEPS):
        j = step_jit(j, DT, jcfg, fast=False)
    _held(got, j, FLIP_BOUNDS, 1e-4)
    assert all(r["dropped"] == [0] * STEPS for r in res)


@pytest.mark.parametrize("device", DEVICES)
def test_flip_halo_step_at_demo_dt_is_exact(request, device):
    """Three steps at 1/60 s, where rounding differences grow fastest (the
    JAX package's shifted slab frames leave 1.7e-4 in u at 64^3 here): the
    one-device steps bit for bit, at 16^3 on the CPU and 128^3 on the card.
    Each rank launches each kernel as _launches says, every step, and the
    two slab entries give their plain versions' bits on the last step's
    inputs."""
    cfg = _cfgs(CARD_N if device == "cuda" else 16)[0]
    res = _world(request, device).run(runs.halo_run, "flip", cfg, 3, 1.0 / 60.0,
                                      check_entries=True, deadline=300.0)
    _held(res[0]["state"], _port_steps("flip", cfg, 3, device, 1.0 / 60.0), {}, 0.0)
    for r in res:
        assert r["dropped"] == [0] * 3
        assert r["launches"] == [_launches(device, "flip")] * 3
        assert all(exact for _, exact in r["entries"].values()) and len(r["entries"]) == 2


def test_flip_collective_and_launch_counts(flip_runs):
    """The collectives of one step at 16^3 over 4 ranks, pinned (the
    counterpart of the JAX package's collective budgets): 8 all-gathers
    (grids, particles, diff grids), 1 pmax, 8 plane halos, 1 plane from
    below, 201 SOR exchanges, and the relay's sends and receives (4 each at
    the edge ranks, 8 inside). On the CPU no kernel launches."""
    for r in flip_runs[16]:
        relay = 4 if r["rank"] in (0, D - 1) else 8
        for calls in r["calls"]:
            assert calls == {"all_gather": 8, "pmax": 1, "halo_x": 8, "from_lo": 1,
                             "exchange_x": 201, "send": relay, "recv": relay}
        assert all(not any(step.values()) for step in r["launches"])


def test_drop_counter_counts_slab_overflow(ranks):
    """At 1x the average share (below the dam's 2x x-concentration) the
    step drops particles, and n_dropped is the numpy count of the fullest
    slab's overflow (its particles with a one-cell halo, less the
    capacity)."""
    cfg = _cfgs(16)[0]
    n = cfg.num_particles
    cap = default_capacity(n, D, 1)
    assert cap == min(n, ((n // D) + 127) // 128 * 128) < default_capacity(n, D)
    res = ranks.run(runs.halo_run, "flip", cfg, 1, DT, capacity=cap)
    pos = res[0]["state"]["pos"]  # step 1's advected positions
    cellx = np.floor(pos[:, 0] * np.float32(cfg.nx) + np.float32(0.5))
    sx = cfg.nx // D
    counts = [int(((cellx >= r * sx - 1) & (cellx <= r * sx + sx)).sum()) for r in range(D)]
    want = max(max(c - cap, 0) for c in counts)
    assert want > 0
    assert [r["dropped"] for r in res] == [[want]] * D


def test_gspmd_layout_step_matches_port(ranks):
    """make_sharded_step on the GSPMD layout: the halo step between two
    reshards (each an all-gather of the four grids), 2 steps, the port's
    step bit for bit."""
    cfg = _cfgs(16)[0]
    res = ranks.run(runs.halo_run, "flip", cfg, STEPS, DT, "gspmd")
    _held(res[0]["state"], _port_steps("flip", cfg, STEPS), {}, 0.0)
    for calls in res[1]["calls"]:
        assert calls["reshard"] == 2 and calls["all_gather"] == 8 + 2 * 4


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("layout", ["x", "gspmd"])
def test_apic_halo_step_matches_step_apic(request, layout, device):
    """make_halo_apic_step and make_sharded_apic_step, 2 steps at 16^3:
    step_apic bit for bit (the JAX package's bounds: pos 1e-6, vel and
    grids 1e-5, C 1e-4); 9 all-gathers a halo step (C gathered with the
    particles). On the card, at 128^3: each rank's P2G is the plain form
    (index_add_, whose atomics sum in no fixed order) where the one-device
    step runs the APIC P2G kernel, so the state is held to the card-vs-CPU
    bound of tests/test_torch_cuda.py (1e-4, C 2 m x 1e-4)."""
    cfg = _cfgs(CARD_N if device == "cuda" else 16)[0]
    res = _world(request, device).run(runs.halo_run, "apic", cfg, STEPS, DT, layout,
                                      deadline=300.0)
    got = res[0]["state"]
    assert sorted(got) == ["C", "phi", "pos", "u", "v", "vel", "w"]
    want = _port_steps("apic", cfg, STEPS, device)
    if device == "cuda":
        _held(got, want, {"C": 2 * cfg.nx * 1e-4}, 1e-4)
    else:
        _held(got, want, APIC_BOUNDS, 1e-5)
        _held(got, want, {}, 0.0)
    assert all(r["dropped"] == [0] * STEPS for r in res)
    assert all(r["launches"] == [_launches(device, "apic")] * STEPS for r in res)
    gathers = 9 + (8 if layout == "gspmd" else 0)
    assert all(c["all_gather"] == gathers for r in res for c in r["calls"])


def test_apic_capacity_scaling_and_drops(ranks):
    """The APIC default capacity is JAX's: FLIP's 4x share scaled by
    (slabx + 4) / (slabx + 2). At 32^3 over 8 ranks FLIP's 54,016 would
    drop 3,584 of the fullest frame's 57,600 (halo_apic.py:87-98); the
    scaled one holds them. (Over 4 ranks both are N.) Forced below the
    fullest 2-cell-halo frame at 16^3 (from the unmoved first-step
    positions: stage 1 is the zero velocity), the step reports exactly the
    overflow."""
    big = _cfgs(32)[0]
    assert default_capacity(big.num_particles, 8) == 54_016
    assert default_apic_capacity(big, 8) == 72_064 >= 57_600
    cfg = _cfgs(16)[0]
    n, sx = cfg.num_particles, cfg.nx // D
    jax_rule = min(n, (4 * n * (sx + 4) // (D * (sx + 2)) + 127) // 128 * 128)
    assert default_apic_capacity(cfg, D) == jax_rule == n
    pos = ft.init_apic_state(cfg, "cpu").pos.numpy()
    cellx = np.floor(pos[:, 0] * np.float32(cfg.nx) + np.float32(0.5))
    fullest = max(int(((cellx >= r * sx - 2) & (cellx <= r * sx + sx + 1)).sum())
                  for r in range(D))
    res = ranks.run(runs.halo_run, "apic", cfg, 1, DT, capacity=fullest - 100)
    assert [r["dropped"] for r in res] == [[100]] * D
    assert np.isfinite(res[0]["state"]["C"]).all()


def test_halo_sor_matches_jax_sharded(ranks):
    """The halo SOR over 4 ranks against JAX's sor_pressure_sharded on 4
    devices of the CPU mesh (tests/test_parallel.py's inputs) within 1e-5,
    and the port's one-device solve bit for bit; 1 + 200 exchanges."""
    cfg, jcfg = _cfgs(16)
    state = step_jit(jax_init(jcfg), DT, jcfg)
    phi, _ = jax_levelset.compute_level_set(jcfg, state.pos)
    diag = jax_project.compute_diag(jcfg, phi)
    b = jax_project.compute_rhs(jcfg, state.u, state.v, state.w, np.float32(DT))
    mesh = jax_make_mesh(jax.devices()[:D])
    xs = x_sharding(mesh)
    want = np.asarray(jax_sor_sharded(jcfg, mesh, *(jax.device_put(a, xs)
                                                     for a in (phi, diag, b))))
    args = [np.asarray(a) for a in (phi, diag, b)]
    res = ranks.run(runs.sor_run, cfg, *args)
    assert float(np.abs(res[0]["p"] - want).max()) <= 1e-5
    one = sor_pressure(cfg, *(torch.from_numpy(a.copy()) for a in args)).numpy()
    np.testing.assert_array_equal(res[0]["p"], one)
    assert all(r["calls"] == {"exchange_x": 1 + 2 * cfg.sor_iterations} for r in res)


@pytest.mark.parametrize("device", DEVICES)
def test_halo_sor_on_port_inputs_is_one_device_solve(request, device):
    """At 24^3 on the port's own step's level set and RHS: bit for bit (on
    the card 2 x 100 launches of fst_sor_half a rank against one of
    fst_sor)."""
    world = _world(request, device)
    cfg = _cfgs(24)[0]
    s = ft.step(ft.init_state(cfg, device), DT, cfg)
    diag = compute_diag(cfg, s.phi)
    b = compute_rhs(cfg, s.u, s.v, s.w, DT)
    res = world.run(runs.sor_run, cfg, *(t.cpu().numpy() for t in (s.phi, diag, b)))
    np.testing.assert_array_equal(res[0]["p"], sor_pressure(cfg, s.phi, diag, b).cpu().numpy())


@pytest.mark.parametrize("n", sorted(SIZES))
def test_layouts(ranks, n):
    """shard_state_x / shard_apic_state_x: row blocks of N/4 and x-slabs,
    u cell-indexed; shard_state / shard_apic_state: JAX's GSPMD layout
    (u, w, phi split along y, v along z); each gathers back to the whole
    state bit for bit."""
    cfg = _cfgs(n)[0]
    rows, s = cfg.num_particles // D, n // D
    x = {"pos": (rows, 3), "vel": (rows, 3), "u": (s, n, n), "v": (s, n + 1, n),
         "w": (s, n, n + 1), "phi": (s, n, n)}
    g = {"pos": (rows, 3), "vel": (rows, 3), "u": (n + 1, s, n), "v": (n, n + 1, s),
         "w": (n, s, n + 1), "phi": (n, s, n)}
    for r in ranks.run(runs.layout_run, cfg):
        for (family, layout), want in ((("flip", "x"), x), (("flip", "gspmd"), g),
                                       (("apic", "x"), {**x, "C": (rows, 3, 3)}),
                                       (("apic", "gspmd"), {**g, "C": (rows, 3, 3)})):
            assert r[(family, layout)]["shapes"] == want, (family, layout)
            assert r[(family, layout)]["round_trip"], (family, layout)


def test_ranks_import_neither_jax_nor_the_jax_package(ranks):
    assert ranks.run(runs.imported) == [[]] * D


def test_backend_and_device_rules(monkeypatch):
    """nccl on the CPU, and more nccl ranks than cards, raise and name
    backend="gloo"; nothing switches the backend."""
    with pytest.raises(ValueError, match='backend="gloo"'):
        comm.rank_device("nccl", "cpu", 0, 1)
    with pytest.raises(ValueError, match="backend must be"):
        comm.rank_device("mpi", "cpu", 0, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        comm.rank_device("nccl", "cuda", 0, 4)
    assert comm.rank_device("gloo", "cuda", 3, 4) == torch.device("cuda", 0)
    assert comm.rank_device("nccl", "cuda", 0, 1) == torch.device("cuda", 0)
    assert comm.rank_device("gloo", "cpu", 2, 4) == torch.device("cpu")


@pytest.mark.cuda
def test_one_nccl_rank_is_the_one_device_step():
    """A world of one NCCL rank on the card: the FLIP halo step, 2 steps at
    128^3, bit for bit the one-device step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = _cfgs(CARD_N)[0]
    res = comm.run_ranks(runs.halo_run, 1, "nccl", "cuda", "flip", cfg, STEPS, DT,
                         timeout=120.0, deadline=300.0)
    _held(res[0]["state"], _port_steps("flip", cfg, STEPS, "cuda"), {}, 0.0)


def test_a_failing_rank_fails_the_call():
    """A rank that raises fails run_ranks with its traceback, within the
    deadline (here: a grid that does not split over 3 ranks)."""
    cfg = _cfgs(16)[0]
    a = np.zeros((16, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="must divide"):
        comm.run_ranks(runs.sor_run, 3, "gloo", "cpu", cfg, a, a, a, timeout=30.0,
                       deadline=60.0)


@pytest.mark.slow
def test_flip_halo_step_matches_jax_halo_step(flip_runs):
    """Against JAX's own make_halo_step on 4 devices of the CPU mesh, 2
    steps at 16^3, the FLIP bounds (slow: its compile)."""
    from fluidsimulation_tpu.parallel.halo_step import make_halo_step, shard_state_x

    jcfg = _cfgs(16)[1]
    mesh = jax_make_mesh(jax.devices()[:D])
    j = shard_state_x(jax_init(jcfg), mesh)
    fn = make_halo_step(jcfg, mesh)
    for _ in range(STEPS):
        j = fn(j, DT)
    _held(flip_runs[16][0]["state"], j, FLIP_BOUNDS, 1e-4)
