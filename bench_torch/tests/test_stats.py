import pytest

from harness import stats


def test_step_ms_is_window_over_steps():
    assert stats.step_ms(51.0, 1020) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        stats.step_ms(1.0, 0)


def test_p95_counts_every_step_by_nearest_rank():
    values = list(range(1, 201))  # 200 steps: the 190th value, ten beyond it
    assert stats.p95(values) == 190
    assert sum(v > stats.p95(values) for v in values) == 10
    assert stats.p95(reversed(values)) == 190
    assert stats.p95([3.0]) == 3.0


def test_p95_needs_two_hundred_steps_for_ten_beyond():
    assert stats.P95_MIN_SAMPLES == 200
    values = list(range(stats.P95_MIN_SAMPLES - 1))
    assert sum(v > stats.p95(values) for v in values) < 10


def test_union_merges_overlaps_and_keeps_gaps():
    ivs = [(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (3.0, 4.0), (7.0, 7.5)]
    assert stats.union(ivs) == [(0.0, 4.0), (5.0, 6.0), (7.0, 7.5)]
    assert stats.covered(ivs, 0.0, 10.0) == pytest.approx(5.5)
    assert stats.covered(ivs, 1.5, 5.5) == pytest.approx(3.0)
    assert stats.gaps(ivs, -1.0, 8.0) == [(-1.0, 0.0), (4.0, 5.0), (6.0, 7.0), (7.5, 8.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
