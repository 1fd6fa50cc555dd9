"""The demo's --profile table (utils/profiling.py) on the CPU: the
reference's mark table (MARKS, SHORT, StageProfiler, profile_step,
profile_step_apic) against the JAX package's, the profiled step bit for bit
the step; its ``hooked`` wraps any function and restores it."""

import numpy as np
import pytest
import torch

from fluidsimulation_tpu.utils import profiling as jax_profiling

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.utils import profiling

N = 12
CFG = ft.SimConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N))
# The stage spans of a 3D step, in the order it runs them.
STAGES = ["advect", "csr", "sort", "seed", "pass", "sweeps", "p2g", "extrapolate", "gravity",
          "rhs", "diag", "sor", "apply", "particle_update", "blur"]


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


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
