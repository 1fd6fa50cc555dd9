"""Faults planted in the program under the benchmark, each of which the
comparison (harness/compare.py) has to catch: a step that returns its
state unchanged, P2G over half of the particles (the face means taken over
the rest), and the particle update's velocities 1% off where they are
produced. A run on one card has no exchange between cards to leave out.

Where each is planted is a file of its own, faults/<name>.py, found by the
name of the transfer's reference (harness/catalog.py): ``SITES`` = (module,
step, P2G site, particle-update site) and ``half_batch(orig)``, the P2G
site over every other particle. ``planted(fault, name)`` swaps the site in
the program's module while it is open. The harness's tests drive a run on
the CPU under each (tests/test_faults.py); readings.py reads each at a
cell's own size on the card. The benchmark's own runs plant nothing.
"""

from __future__ import annotations

import contextlib
import importlib

from . import catalog

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


def _unchanged(state, dt, cfg):
    return state


def _altered(orig):
    def altered(*args, **kwargs):
        vel, other = orig(*args, **kwargs)
        return vel * 1.01, other
    return altered


@contextlib.contextmanager
def planted(fault: str, name: str):
    table = catalog.faults(name)
    mod_name, step_name, p2g_name, update_name = table.SITES
    module = importlib.import_module(mod_name)
    site = {"unchanged_state": step_name, "half_batch": p2g_name,
            "altered_answer": update_name}[fault]
    orig = getattr(module, site)
    swap = {"unchanged_state": lambda: _unchanged,
            "half_batch": lambda: table.half_batch(orig),
            "altered_answer": lambda: _altered(orig)}[fault]()
    setattr(module, site, swap)
    try:
        yield
    finally:
        setattr(module, site, orig)
