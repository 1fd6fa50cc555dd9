"""The comparison that decides ``correct``.

The window's last step is the answer checked: the plain reference
(references/<name>.py) steps the very state the program's last step
started from, and every field of the state the program returned is held
against the reference's. That covers every stage of the step and every
kernel it launches: the level set's pass and sweeps reach phi, P2G, the
SOR and the FLIP gather (or the APIC transfers) reach the grids, the
velocities and k1 (or C).

A sound float32 program agrees with the reference to rounding nearly
everywhere, but not quite everywhere: P2G sums in another order, and a face
whose weight sum lies within rounding of the validity threshold, or a cell
whose level set lies within rounding of 0, can fall the other way and move
a few values by much more than rounding. So the numbers compared are
shares, one a field (``off_share.<field>``): of the field's values, the
share that lies further from the reference than ``RTOL`` times (|reference
value| + the field's root mean square). Each field is held on its own, so
that a fault in a small part of one field (a wall face of one grid, phi's
surface band) is not diluted by the others. A step computed in bfloat16
moves most values by about 2^-9 of their size and fails them; a step that
leaves its state unchanged, drops half its particles or bends its output
fails them too (harness/faults.py). ``worst_rel_l2``, the largest over the
fields of |program - reference| / |reference| in the 2-norm, is compared
beside them.

The limits were set from readings on the card (PERF.md, section 2): the
largest a dozen seeds of the program read, and the least the bfloat16
control reads.
"""

from __future__ import annotations

import torch

RTOL = 1e-3
OFF_LIMIT = 1e-4  # each field's off_share
REL_L2_LIMIT = 1e-2  # worst_rel_l2


def _field_stats(got: torch.Tensor, want: torch.Tensor, rtol: float):
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    diff = (got - want).abs()
    rms = want.square().mean().sqrt()
    tol = rtol * (want.abs() + rms)
    # NaN in the program's value is off: the test is written so that it fails.
    off = int((~(diff <= tol)).sum())
    norm = float(want.norm())
    rel = float(diff.norm()) / norm if norm > 0 else float(diff.norm())
    if not torch.isfinite(diff).all():
        rel = float("inf")
    return off, got.numel(), rel, float(diff.max()) if diff.numel() else 0.0


def numbers(got: dict, want: dict, fields, rtol: float = RTOL) -> dict:
    """The numbers compared, and per field what they were made of."""
    per_field = {}
    worst = 0.0
    for name in fields:
        o, n, rel, mx = _field_stats(got[name], want[name], rtol)
        worst = max(worst, rel)
        per_field[name] = {"off": o, "off_share": o / n, "rel_l2": rel, "max_abs": mx}
    return {"worst_rel_l2": worst, "fields": per_field}


def checks(nums: dict, off_limit: float = OFF_LIMIT, rel_limit: float = REL_L2_LIMIT) -> dict:
    """{name: {"value": number, "limit": limit}} for each number compared."""
    out = {f"off_share.{name}": {"value": f["off_share"], "limit": off_limit}
           for name, f in nums["fields"].items()}
    out["worst_rel_l2"] = {"value": nums["worst_rel_l2"], "limit": rel_limit}
    return out


def passed(chk: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())
