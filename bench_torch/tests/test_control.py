"""The comparison's control: the plain reference computed in bfloat16, one
precision below the configuration's float32, put in the program's place.
It has to come out as not correct, while the program's own step passes.
On the card the control was read at each cell's own size
(bench_torch/readings.py, PERF.md section 2); here at a size a test run
holds: the demo's scene at 16^3, three seeds, after 8 steps. The
references are loaded as a run loads them, by name through the catalog
(references/<name>.py), and step the scene as a dict."""

import dataclasses

import pytest
import torch

from harness import catalog, compare, reference

SEEDS = (1, 2**31 + 11, 3_000_000_019)
DT = 1.0 / 120.0


def _state(transfer: str, seed: int):
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.solver.apic import init_apic_state, step_apic
    from fluidsimulation_tpu_torch.solver.step3d import step

    cfg = ft.SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0, seed=seed)
    init, stepper = {"flip": (ft.init_state, step), "apic": (init_apic_state, step_apic)}[transfer]
    fields = catalog.reference(transfer).FIELDS
    s = init(cfg, "cpu")
    for _ in range(8):
        s = stepper(s, DT, cfg)
    out = stepper(s, DT, cfg)
    scene = dataclasses.asdict(cfg)
    return scene, {k: getattr(s, k) for k in fields}, {k: getattr(out, k) for k in fields}, fields


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("transfer", ["flip", "apic"])
def test_bfloat16_control_fails_and_the_program_passes(transfer, seed):
    scene, inp, got, fields = _state(transfer, seed)
    step = catalog.reference(transfer).step
    want = step(scene, inp, DT)
    program = compare.checks(compare.numbers(got, want, fields))
    control = compare.checks(compare.numbers(step(scene, inp, DT, torch.bfloat16),
                                             want, fields))
    assert compare.passed(program), program
    assert not compare.passed(control), control
    # Each number separates the two by far.
    for name, c in control.items():
        assert c["value"] > 3 * c["limit"], (name, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transfer", ["flip", "apic"])
def test_the_reference_file_steps_as_the_shared_stages(transfer, dtype):
    """references/<name>.py, given the scene dict as a configuration states
    it, gives the shared 3D stages' step on scene_of(scene) bit for bit."""
    scene, inp, _, fields = _state(transfer, SEEDS[1])
    shared = {"flip": reference.flip_step, "apic": reference.apic_step}[transfer]
    ref = catalog.reference(transfer)
    assert ref.FIELDS == fields == {"flip": reference.FLIP_FIELDS,
                                    "apic": reference.APIC_FIELDS}[transfer]
    got = ref.step(scene, inp, DT, dtype)
    want = shared(reference.scene_of(scene), inp, DT, dtype)
    assert list(got) == list(want)
    for k in fields:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
