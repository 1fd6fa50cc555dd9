"""The per-stage step timer (utils/profiling.py) on the CPU: it marks every
stage of the step, leaves the step's result unchanged and restores the
functions it wrapped; its ``hooked`` does the same for any function."""

import pytest
import torch

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import levelset, project
from fluidsimulation_tpu_torch.solver import step3d
from fluidsimulation_tpu_torch.utils import profiling

N = 12
CFG = ft.SimConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N))


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
        assert list(row) == profiling.STAGES
        assert all(row[s] > 0 for s in profiling.STAGES)
        assert sum(row.values()) <= total
    after = [getattr(m, a) for m, a in ((step3d, "build_csr"), (levelset, "sweep_closest"),
                                        (project, "sor_pressure"))]
    assert after == before


def test_stage_times_marks_every_apic_stage_and_keeps_the_step():
    """An ApicState is stepped by step_apic, with its own stages marked."""
    from fluidsimulation_tpu_torch.solver import apic

    before = (apic.p2g_apic, apic.g2p_apic, apic.advect_rk3_pic)
    s0 = ft.init_apic_state(CFG, "cpu")
    timed, rows, totals = profiling.stage_times(s0, 0.01, CFG, 2)
    plain = ft.simulate_apic(s0, 0.01, CFG, 2)
    for name in ("pos", "vel", "C", "u", "v", "w", "phi"):
        torch.testing.assert_close(getattr(timed, name), getattr(plain, name), rtol=0, atol=0)
    assert "APIC P2G" in profiling.APIC_STAGES and "FLIP" not in profiling.APIC_STAGES
    for row, total in zip(rows, totals):
        assert list(row) == profiling.APIC_STAGES
        assert all(row[s] > 0 for s in profiling.APIC_STAGES)
        assert sum(row.values()) <= total
    assert (apic.p2g_apic, apic.g2p_apic, apic.advect_rk3_pic) == before


@pytest.mark.parametrize("apic", [False, True], ids=["flip", "apic"])
def test_stage_times_marks_every_2d_stage_and_keeps_the_step(apic):
    """A SimState2D is stepped by step2d, an ApicState2D by step_apic2d,
    each with its own stages marked (the 8 sweeps summed in one)."""
    from fluidsimulation_tpu_torch.solver import apic2d, step2d

    before = (step2d._sweep_axis2, step2d.sor_pressure, apic2d.p2g_apic2d)
    cfg = ft.SimConfig2D(nx=N, ny=N, cells_per_meter=float(N))
    init, step = (ft.init_apic_state2d, ft.step_apic2d) if apic else (ft.init_state2d, ft.step2d)
    stages = profiling.APIC2D_STAGES if apic else profiling.STAGES_2D
    s0 = init(cfg, "cpu")
    timed, rows, totals = profiling.stage_times(s0, 0.01, cfg, 2)
    plain = step(step(s0, 0.01, cfg), 0.01, cfg)
    for name in ("pos", "vel", "u", "v", "phi", *(("C",) if apic else ())):
        torch.testing.assert_close(getattr(timed, name), getattr(plain, name), rtol=0, atol=0)
    assert ("APIC P2G" in stages) is apic and ("FLIP" in stages) is not apic
    for row, total in zip(rows, totals):
        assert list(row) == stages
        assert all(row[s] > 0 for s in stages)
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
