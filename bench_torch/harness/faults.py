"""Faults planted in the program under the benchmark, each of which the
comparison (harness/compare.py) has to catch: a step that returns its
state unchanged, P2G over half of the particles (the face means taken over
the rest), and the particle update's velocities 1% off where they are
produced. A run on one card has no exchange between cards to leave out.

``planted(fault, transfer)`` swaps the site in the program's module while
it is open. The harness's tests drive a run on the CPU under each
(tests/test_faults.py); readings.py reads each at a cell's own size on the
card. The benchmark's own runs plant nothing.
"""

from __future__ import annotations

import contextlib
import importlib

FAULTS = ("unchanged_state", "half_batch", "altered_answer")

# transfer -> (module, step, P2G site, particle-update site)
SITES = {
    "flip": ("fluidsimulation_tpu_torch.solver.step3d", "step", "p2g_from_csr",
             "flip_update_carry"),
    "apic": ("fluidsimulation_tpu_torch.solver.apic", "step_apic", "p2g_apic", "g2p_apic"),
}


def _unchanged(state, dt, cfg):
    return state


def _half_batch(orig, transfer):
    """P2G over every other particle. FLIP's kernel walks the CSR index of
    all particles, so the half goes through the program's scatter form,
    which takes any particle order."""
    if transfer == "flip":
        from fluidsimulation_tpu_torch.ops.cuda_p2g import p2g_accumulate_plain
        from fluidsimulation_tpu_torch.ops.p2g import _normalise

        return lambda cfg, csr, pcs, vels, x0=0: _normalise(
            cfg, p2g_accumulate_plain(cfg, pcs[::2], vels[::2], x0))
    return lambda cfg, pos, vel, C: orig(cfg, pos[::2], vel[::2], C[::2])


def _altered(orig):
    def altered(*args, **kwargs):
        vel, other = orig(*args, **kwargs)
        return vel * 1.01, other
    return altered


@contextlib.contextmanager
def planted(fault: str, transfer: str):
    mod_name, step_name, p2g_name, update_name = SITES[transfer]
    module = importlib.import_module(mod_name)
    name = {"unchanged_state": step_name, "half_batch": p2g_name,
            "altered_answer": update_name}[fault]
    orig = getattr(module, name)
    swap = {"unchanged_state": lambda: _unchanged,
            "half_batch": lambda: _half_batch(orig, transfer),
            "altered_answer": lambda: _altered(orig)}[fault]()
    setattr(module, name, swap)
    try:
        yield
    finally:
        setattr(module, name, orig)
