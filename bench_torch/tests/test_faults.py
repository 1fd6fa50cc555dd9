"""A run driven on the CPU at a small scene, past the look for a card, with
the timed path broken underneath (harness/faults.py, planted where
faults/<name>.py of the transfer's reference says): each fault a one-card
cell of this system can have must turn ``correct`` false, and the sound
path keeps it true."""

import contextlib
import io
import json

import pytest
import torch

import run
from harness import catalog, faults

CELLS = {"flip": "demo64.flip", "apic": "demo64.apic"}


def drive(transfer: str, seed: int = 2**31 + 5) -> dict:
    conf = catalog.config("demo64")
    conf["scene"].update(nx=12, ny=12, nz=12, cells_per_meter=12.0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELLS[transfer], "--seed", str(seed), "--seconds", "0.5",
                       "--trace", "0"], dev=torch.device("cpu"), conf=conf)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["metrics"] == {}
    return result


@pytest.mark.parametrize("transfer", ["flip", "apic"])
def test_the_sound_step_is_correct(transfer):
    result = drive(transfer)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("transfer", ["flip", "apic"])
def test_each_fault_turns_correct_false(transfer, fault):
    name = catalog.config("demo64")["program"]["transfers"][transfer]["reference"]
    with faults.planted(fault, name):
        result = drive(transfer)
    assert result["correct"] is False, result["checks"]
