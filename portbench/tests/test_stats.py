"""The window's statistics keep every tick: a stall shows."""

from portbench import stats


def test_p95_sees_a_stall():
    ticks = [0.013] * 95 + [0.5] * 5        # five stalled ticks of 100
    assert stats.percentile(ticks, 95) == 0.013
    ticks = [0.013] * 94 + [0.5] * 6        # six: the 95th is a stall
    assert stats.percentile(ticks, 95) == 0.5
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_rate_over_the_whole_window():
    # 4 episodes of 50 ticks x 1024 worlds in a window with a 2 s stall
    assert stats.rate(4 * 50 * 1024, 20.0 + 2.0) == 204800 / 22.0
