"""The interval union and the idle gaps of a synthetic trace."""

import pytest

from yardstick.trace import Trace, complement, union_length


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),          # overlapping kernels count once
    ([(0, 10), (2, 3), (20, 25)], 15.0),  # nested, then a gap
    ([(20, 25), (0, 10), (10, 12)], 17.0),  # unsorted, touching
])
def test_union_length(intervals, length):
    assert union_length(intervals) == length


def test_complement_within_the_window():
    assert complement([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert complement([], 0, 5) == [(0, 5)]


def test_trace_busy_idle_and_gaps():
    device = [("k1", 100.0, 300.0), ("k2", 200.0, 400.0), ("k1", 600.0, 700.0),
              ("early", -50.0, 50.0)]
    host = [("bench.window", 0.0, 1000.0), ("aten::item", 390.0, 650.0),
            ("run_epoch", 0.0, 1000.0)]
    tr = Trace(sorted(device, key=lambda t: t[1]), host, (0.0, 1000.0))
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx((50 + 300 + 100) * 1e-6)
    assert tr.kernel_s(lambda n: n == "k1") == pytest.approx(300e-6)
    gaps = tr.idle_gaps(2)
    assert gaps[0] == ["run_epoch", pytest.approx(300e-6)]  # 700-1000
    assert gaps[1] == ["aten::item", pytest.approx(200e-6)]  # 400-600
    assert tr.top_ops(1) == [["k1", pytest.approx(300e-6)]]
