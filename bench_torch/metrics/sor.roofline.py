"""sor.roofline, %: the least time of the pressure solve over the device
time of everything launched inside the sor span. The least time is the
larger of its bytes over the memory rate and its float32 operations over
the peak rate (harness/roofline.py::sor_work), from the grid, the fluid
cells of the level set the solve was given (phi < 0) and the scene's
iteration count."""

from harness import roofline


def capture(captured):
    calls = captured.get("sor")
    if not calls or len(calls[-1]) < 2:
        return None
    phi = calls[-1][1]  # sor_pressure(cfg, phi, diag, b)
    return {"sor_fluid": int((phi < 0).sum()), "sor_cells": phi.numel()}


def read(trace):
    ms = trace.stage_ms({"sor"})
    fluid, cells = trace.facts("sor_fluid"), trace.facts("sor_cells")
    if ms is None or not fluid or ms <= 0:
        return None
    least = [roofline.least_s(*roofline.sor_work(c, f, trace.scene["sor_iterations"]))
             for c, f in zip(cells, fluid)]
    return 100.0 * 1e3 * (sum(least) / len(least)) / ms
