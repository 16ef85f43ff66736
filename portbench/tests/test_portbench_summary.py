"""The rate and percentile arithmetic over a window that holds a stall."""

import pytest

from portbench import summary


def test_percentile_counts_every_request_and_the_stall():
    # 99 requests of 40 ms and one stall of 2 s: the stall is the 100th
    # percentile; p95 and p50 stay at 40 ms.
    ms = [40.0] * 99 + [2000.0]
    assert summary.percentile(ms, 50) == 40.0
    assert summary.percentile(ms, 95) == 40.0
    assert summary.percentile(ms, 100) == 2000.0
    # Six stalls in 100 requests reach p95.
    ms = [40.0] * 94 + [2000.0] * 6
    assert summary.percentile(ms, 95) == 2000.0


@pytest.mark.parametrize("q,want", [(50, 5), (95, 10), (90, 9), (10, 1)])
def test_percentile_nearest_rank(q, want):
    assert summary.percentile(list(range(10, 0, -1)), q) == want


def test_rate_covers_all_the_time_of_the_window():
    # Three passes of 16 files of 24 MP, the second stalled 3 s in the
    # middle: the rate is all the work over first start to last end.
    starts, ends = [0.0, 1.5, 6.0], [1.5, 6.0, 7.5]
    assert summary.rate([384.0] * 3, starts, ends) == pytest.approx(1152.0 / 7.5)

