"""The per-stage step timer (utils/profiling.py) on the CPU: it times every
stage span of the step (utils/trace.py), leaves the step's result
unchanged and leaves the step's functions as they were; its ``hooked``
wraps any function and restores it. The reference's mark table (MARKS,
SHORT, StageProfiler, profile_step, profile_step_apic) against the JAX
package's."""

import numpy as np
import pytest
import torch

from fluidsimulation_tpu.utils import profiling as jax_profiling

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import levelset, project
from fluidsimulation_tpu_torch.solver import step3d
from fluidsimulation_tpu_torch.utils import profiling

N = 12
CFG = ft.SimConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N))
# The stage spans of a step, in the order it runs them: both 3D families,
# and both 2D ones (no CSR index, 27-neighbourhood pass or blur).
STAGES = ["advect", "csr", "sort", "seed", "pass", "sweeps", "p2g", "extrapolate", "gravity",
          "rhs", "diag", "sor", "apply", "particle_update", "blur"]
STAGES_2D = ["advect", "seed", "sweeps", "p2g", "extrapolate", "gravity", "rhs", "diag", "sor",
             "apply", "particle_update"]


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def test_stage_times_marks_every_stage_and_keeps_the_step():
    before = [getattr(m, a) for m, a in ((step3d, "build_csr"), (levelset, "sweep_closest"),
                                         (project, "sor_pressure"))]
    s0 = ft.init_state(CFG, "cpu")
    timed, rows, totals = profiling.stage_times(s0, 0.01, CFG, 2)
    plain = ft.simulate(s0, 0.01, CFG, 2)
    for name in ("pos", "vel", "u", "v", "w", "phi", "k1"):
        torch.testing.assert_close(getattr(timed, name), getattr(plain, name), rtol=0, atol=0)
    assert len(rows) == len(totals) == 2
    for row, total in zip(rows, totals):
        assert list(row) == STAGES
        assert all(row[s] > 0 for s in STAGES)
        assert sum(row.values()) <= total
    after = [getattr(m, a) for m, a in ((step3d, "build_csr"), (levelset, "sweep_closest"),
                                        (project, "sor_pressure"))]
    assert after == before


def test_stage_times_marks_every_apic_stage_and_keeps_the_step():
    """An ApicState is stepped by step_apic, its stages timed (its P2G and
    G2P under p2g and particle_update)."""
    from fluidsimulation_tpu_torch.solver import apic

    before = (apic.p2g_apic, apic.g2p_apic, apic.advect_rk3_pic)
    s0 = ft.init_apic_state(CFG, "cpu")
    timed, rows, totals = profiling.stage_times(s0, 0.01, CFG, 2)
    plain = ft.simulate_apic(s0, 0.01, CFG, 2)
    for name in ("pos", "vel", "C", "u", "v", "w", "phi"):
        torch.testing.assert_close(getattr(timed, name), getattr(plain, name), rtol=0, atol=0)
    for row, total in zip(rows, totals):
        assert list(row) == STAGES
        assert all(row[s] > 0 for s in STAGES)
        assert sum(row.values()) <= total
    assert (apic.p2g_apic, apic.g2p_apic, apic.advect_rk3_pic) == before


@pytest.mark.parametrize("apic", [False, True], ids=["flip", "apic"])
def test_stage_times_marks_every_2d_stage_and_keeps_the_step(apic):
    """A SimState2D is stepped by step2d, an ApicState2D by step_apic2d,
    each with its own stages timed (the 8 sweeps in one span)."""
    from fluidsimulation_tpu_torch.solver import apic2d, step2d

    before = (step2d._sweep_axis2, step2d.sor_pressure, apic2d.p2g_apic2d)
    cfg = ft.SimConfig2D(nx=N, ny=N, cells_per_meter=float(N))
    init, step = (ft.init_apic_state2d, ft.step_apic2d) if apic else (ft.init_state2d, ft.step2d)
    s0 = init(cfg, "cpu")
    timed, rows, totals = profiling.stage_times(s0, 0.01, cfg, 2)
    plain = step(step(s0, 0.01, cfg), 0.01, cfg)
    for name in ("pos", "vel", "u", "v", "phi", *(("C",) if apic else ())):
        torch.testing.assert_close(getattr(timed, name), getattr(plain, name), rtol=0, atol=0)
    for row, total in zip(rows, totals):
        assert list(row) == STAGES_2D
        assert all(row[s] > 0 for s in STAGES_2D)
        assert sum(row.values()) <= total
    assert (step2d._sweep_axis2, step2d.sor_pressure, apic2d.p2g_apic2d) == before


def test_hooked_sees_every_demo_step_and_restores(tmp_path):
    from fluidsimulation_tpu_torch.app import demo

    before = (demo.step, demo.check_state)
    calls = []

    def around(label, orig, args):
        calls.append(label)
        return orig(*args)

    sites = [("app.demo", "step", "step"), ("app.demo", "check_state", "check")]
    with profiling.hooked(sites, around):
        rc = demo.main(["--grid", str(N), "--steps", "3", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    assert calls == ["step", "check", "step", "step"]
    assert (demo.step, demo.check_state) == before


def test_profiling_main_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; main would run in full")
    with pytest.raises(SystemExit, match="CUDA card"):
        profiling.main()


N16 = 16
CFG16 = ft.SimConfig(nx=N16, ny=N16, nz=N16, cells_per_meter=float(N16))
# The marks the JAX package never times: the CSR index replaces the count,
# prefix-sum and bin trio; the clears and the old-grid copy are not stages.
JAX_ZERO = ["TRANSFERPTG_CLEARCOUNTS", "TRANSFERPTG_COUNTPARTICLES",
            "TRANSFERPTG_PREFIXSUM_COPYMAP", "TRANSFERPTG_PREFIXSUM_WAIT",
            "TRANSFERPTG_PREFIXSUM_UNMAPUPDATE", "TRANSFERPTG_LEVELSET_CLEAR",
            "FLIP_COPYVELOCITIES", "PROJECT_PCLEAR"]


def test_marks_and_short_are_jax():
    assert profiling.MARKS == jax_profiling.MARKS and len(profiling.MARKS) == 23
    assert profiling.SHORT == jax_profiling.SHORT
    assert sorted(profiling.STAGE_MARKS + JAX_ZERO + ["DRAW", "END_FRAME"]) == sorted(
        profiling.MARKS)
    assert list(profiling.MARK_OF_STAGE) == STAGES


def test_table_is_jax_table():
    """The same times give JAX's string, header and row; DT reads them."""
    rng = np.random.default_rng(4)
    times = dict(zip(profiling.MARKS, rng.random(23) * 0.2))
    times["DRAW"], times["ADVECT"] = 0.0, 12.3456789
    port, jax = profiling.StageProfiler(), jax_profiling.StageProfiler()
    assert port.table() == jax.table()
    port.times.update(times)
    jax.times.update(times)
    assert port.table() == jax.table()
    assert port.table().startswith("GPU time:\tA     \tTCC")
    assert port.DT("ADVECT") == jax.DT("ADVECT") == 12.3456789 and port.DT("NOPE") == 0.0


@pytest.mark.parametrize("apic", [False, True], ids=["flip", "apic"])
def test_profile_step_is_the_step(apic):
    """profile_step (profile_step_apic) returns the state step (step_apic)
    returns, bit for bit, two steps running; every stage mark > 0, the
    eight marks JAX never times 0, DRAW 0 without render_fn, and the stage
    marks sum to no more than the step's own time."""
    import time

    if apic:
        init, step, prof_step = ft.init_apic_state, ft.step_apic, profiling.profile_step_apic
        fields = ("pos", "vel", "C", "u", "v", "w", "phi")
    else:
        init, step, prof_step = ft.init_state, ft.step, profiling.profile_step
        fields = ("pos", "vel", "u", "v", "w", "phi", "k1")
    timed = plain = init(CFG16, "cpu")
    for _ in range(2):
        t0 = time.perf_counter()
        timed, prof = prof_step(timed, 0.01, CFG16)
        wall = time.perf_counter() - t0
        plain = step(plain, 0.01, CFG16)
        for name in fields:
            torch.testing.assert_close(getattr(timed, name), getattr(plain, name), rtol=0, atol=0)
        assert list(prof.times) == profiling.MARKS
        assert all(prof.times[m] > 0 for m in profiling.STAGE_MARKS)
        assert all(prof.times[m] == 0.0 for m in JAX_ZERO) and prof.times["DRAW"] == 0.0
        assert prof.times["END_FRAME"] >= 0.0
        assert sum(prof.times[m] for m in profiling.STAGE_MARKS) <= wall


def test_render_fn_lands_in_draw():
    """render_fn(new_state) runs once, on the returned state, timed as
    DRAW."""
    import time

    seen = []

    def render(s):
        seen.append(s)
        time.sleep(0.05)

    s0 = ft.init_state(CFG16, "cpu")
    out, prof = profiling.profile_step(s0, 0.01, CFG16, render_fn=render)
    assert seen == [out]
    assert 0.05 <= prof.times["DRAW"] < 1.0
    _, bare = profiling.profile_step(s0, 0.01, CFG16)
    assert bare.times["DRAW"] == 0.0
