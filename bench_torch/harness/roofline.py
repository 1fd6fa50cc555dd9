"""The least time a stage's work could take on the card: its bytes and
float32 operations, reckoned from the stage's inputs, against the card's
published peaks.

The counts follow the port's own bound arithmetic (chip_smoke.py::bound at
commit 39175ce), rewritten to take the stage's inputs: every input byte read
once, every output byte written once, whatever a kernel reads again; each
sum, product, compare, floor, sqrt or division one operation. A stage's
roofline share is this least time over the device time of everything
launched inside its span, whatever code implements it. The work of the
pass, P2G and the FLIP gather is here for the metrics that will read
their spans (a later metric is a new file under metrics/ and cannot edit
this one).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W power limit: device memory rate,
# and float32 outside the tensor cores (every stage here is float32).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# |a - b| - r and its compare: 11 operations a candidate.
DIST_OPS = 11
SWEEPS = 24
NEIGHBOURS = 27


def least_s(nbytes: float, ops: float) -> float:
    """The larger of the memory time and the compute time, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


def faces(nx: int, ny: int, nz: int) -> int:
    return (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)


def sor_work(cells: int, fluid: int, iterations: int) -> tuple[int, int]:
    """The red-black SOR from p = 0: phi, diag and b read and p written once;
    6 neighbour subtractions, b - nms, two products, a division and a sum,
    11 operations a fluid cell an iteration."""
    return 4 * 4 * cells, 11 * fluid * iterations


def sweeps_work(cells: int) -> tuple[int, int]:
    """The 24 sweeps: phi (4 B) and the candidates (12 B) read and written
    once; one distance a cell a sweep."""
    return 2 * (4 + 12) * cells, SWEEPS * DIST_OPS * cells


def pass_work(cells: int) -> tuple[int, int]:
    """The 27-neighbourhood pass: the seeded candidates read, phi and the
    candidates written; 27 distances a cell."""
    return (12 + 4 + 12) * cells, NEIGHBOURS * DIST_OPS * cells


def p2g_work(n: int, cells: int, nfaces: int) -> tuple[int, int]:
    """P2G: positions and velocities read, the CSR offsets read, the weighted
    sums and weights of every face written; 3 axis splits (9), 8 hat weights
    (16) and 8 accumulations of w*vel and w (24) a component: 147 a
    particle."""
    return 24 * n + 4 * (cells + 1) + 2 * 4 * nfaces, 147 * n


def g2p_work(n: int, nfaces: int) -> tuple[int, int]:
    """The FLIP gather: position and velocity read, vel' and k1 written, the
    new and old grids read once; 6 trilinear gathers of 7 lerps (126), 6
    axis splits with clamps (33), the blend (6) and g - beta*g_old at the 24
    corner values (48): 213 a particle."""
    return 48 * n + 2 * 4 * nfaces, 213 * n
