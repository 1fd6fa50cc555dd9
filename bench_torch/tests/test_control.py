"""The comparison's control: the plain reference computed in bfloat16, one
precision below the configuration's float32, put in the program's place.
It has to come out as not correct, while the program's own step passes.
On the card the control was read at each cell's own size
(bench_torch/readings.py, PERF.md section 2); here at a size a test run
holds: the demo's scene at 16^3, three seeds, after 8 steps."""

import dataclasses

import pytest
import torch

from harness import compare, reference

SEEDS = (1, 2**31 + 11, 3_000_000_019)


def _state(transfer: str, seed: int):
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.solver.apic import init_apic_state, step_apic
    from fluidsimulation_tpu_torch.solver.step3d import step

    cfg = ft.SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0, seed=seed)
    init, stepper, fields = {"flip": (ft.init_state, step, reference.FLIP_FIELDS),
                             "apic": (init_apic_state, step_apic, reference.APIC_FIELDS)}[transfer]
    s = init(cfg, "cpu")
    for _ in range(8):
        s = stepper(s, 1.0 / 120.0, cfg)
    out = stepper(s, 1.0 / 120.0, cfg)
    scene = reference.scene_of(dataclasses.asdict(cfg))
    return scene, {k: getattr(s, k) for k in fields}, {k: getattr(out, k) for k in fields}, fields


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("transfer", ["flip", "apic"])
def test_bfloat16_control_fails_and_the_program_passes(transfer, seed):
    scene, inp, got, fields = _state(transfer, seed)
    step = reference.STEPS[transfer][0]
    want = step(scene, inp, 1.0 / 120.0)
    program = compare.checks(compare.numbers(got, want, fields))
    control = compare.checks(compare.numbers(step(scene, inp, 1.0 / 120.0, torch.bfloat16),
                                             want, fields))
    assert compare.passed(program), program
    assert not compare.passed(control), control
    # Each number separates the two by far.
    for name, c in control.items():
        assert c["value"] > 3 * c["limit"], (name, c)
