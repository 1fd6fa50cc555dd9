"""The benchmark's work counts against the port's own bound arithmetic
(chip_smoke.py::bound at commit 39175ce), whose least times at the dam
break's shapes are kept here: a level set with the dam's block fluid."""

import pytest

from harness import roofline

# n, ppc, particles, fluid cells -> chip_smoke.bound's ms for sor, sweep,
# seed (the 27-neighbourhood pass), p2g and g2p.
BOUND_MS = {
    (64, 2, 953_312, 119_164): (0.001956423880597015, 0.0025040620895522385,
                                0.002191054328358209, 0.00905009791044776,
                                0.015566786865671643),
    (128, 1, 1_000_188, 1_000_188): (0.016420997014925373, 0.020032496716417908,
                                     0.017528434626865673, 0.02481133970149254,
                                     0.029472802388059702),
    (256, 1, 8_193_532, 8_193_532): (0.13452067462686565, 0.16025997373134326,
                                     0.14022747701492538, 0.19939692059701491,
                                     0.23806435343283583),
}


@pytest.mark.parametrize("key", sorted(BOUND_MS), ids=lambda k: f"{k[0]}^3")
def test_least_times_match_the_ports_bound(key):
    n, _ppc, particles, fluid = key
    cells, faces = n**3, roofline.faces(n, n, n)
    got = [
        roofline.least_s(*roofline.sor_work(cells, fluid, 100)),
        roofline.least_s(*roofline.sweeps_work(cells)),
        roofline.least_s(*roofline.pass_work(cells)),
        roofline.least_s(*roofline.p2g_work(particles, cells, faces)),
        roofline.least_s(*roofline.g2p_work(particles, faces)),
    ]
    assert [1e3 * s for s in got] == pytest.approx(BOUND_MS[key], rel=1e-12)


def test_sor_is_bound_by_operations_and_sweeps_by_bytes_at_256():
    cells = 256**3
    nbytes, ops = roofline.sor_work(cells, 8_193_532, 100)
    assert ops / roofline.FP32_FLOP_PER_S > nbytes / roofline.HBM_BYTES_PER_S
    nbytes, ops = roofline.sweeps_work(cells)
    assert nbytes / roofline.HBM_BYTES_PER_S > ops / roofline.FP32_FLOP_PER_S
