"""The trace arithmetic on synthetic intervals: busy time is a union, idle
gaps are named by the innermost host operation over their middle."""

from __future__ import annotations

import pytest

from perfbench import trace
from perfbench.trace import Interval, Trace


def make():
    device = [Interval("k1", 10, 30), Interval("k2", 20, 40),  # overlap on two streams
              Interval("k3", 50, 60), Interval("k1", 55, 58),  # nested
              Interval("k4", 95, 120)]                          # runs past the window
    host = [Interval("batch", 0, 100), Interval("aten::item", 40, 50),
            Interval("cudaStreamSynchronize", 62, 90)]
    return Trace((0.0, 100.0), device, host)


def test_busy_is_a_union_clipped_to_the_window():
    tr = make()
    assert trace.union_s(tr.device, tr.window) == pytest.approx((30 + 10 + 5) / 1e6)
    assert tr.window_s == pytest.approx(100e-6)


def test_gaps_longest_first():
    assert trace.gaps(make()) == [(60.0, 95.0), (0.0, 10.0), (40.0, 50.0)]


def test_idle_gaps_named_by_innermost_host_op():
    names = trace.idle_gaps(make())
    assert names[0] == ["cudaStreamSynchronize", pytest.approx(35e-6)]
    assert names[2][0] == "aten::item"


def test_device_ops_sum_by_name():
    ops = dict(trace.device_ops(make()))
    assert ops["k1"] == pytest.approx(23e-6) and ops["k4"] == pytest.approx(5e-6)


def test_kernel_seconds():
    s, n = trace.kernel_seconds(make(), lambda name: name == "k1")
    assert (s, n) == (pytest.approx(23e-6), 2)
