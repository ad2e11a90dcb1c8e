"""The frozen byte and operation formulas of the kernels, at the run and
sweep shapes of PERF.md's table of kernels (seed 0, scale 1.0: the
userbehavior day of 10,630,486 records keeps 442,987 at 3600 s), with the
sweep's rows at their own lengths, give the bounds PERF.md states."""

from __future__ import annotations

import pytest

from stream_bench import roofline as rf

RANGES = [600, 1200, 1800, 2400, 3000, 3600]
#: seed 0, scale 1.0: records of each day and kept at each range
DAYS = {"sogouq": (2_221_781, [15_466, 30_924, 46_383, 61_844, 77_278,
                               92_778]),
        "traffic": (1_859_160, [12_920, 25_852, 38_795, 51_696, 64_627,
                                77_579]),
        "userbehavior": (10_630_486, [73_829, 147_648, 221_466, 295_314,
                                      369_106, 442_987])}
UB, KEPT = DAYS["userbehavior"][0], DAYS["userbehavior"][1][-1]
SWEEP_N = [n for n, _ in DAYS.values() for _ in RANGES]
SWEEP_KEPT = [k for _, kept in DAYS.values() for k in kept]
SWEEP_RANGES = RANGES * 3


def _ms(launch):
    return rf.bound_s(launch[1], launch[2]) * 1e3


@pytest.mark.parametrize("launch,want_ms,digits", [
    (rf.stream_sample([UB], [3600]), 0.0286, 4),
    (rf.stream_sample(SWEEP_N, SWEEP_RANGES), 0.237, 3),
    (rf.compact([UB], [KEPT]), 0.00370, 5),
    (rf.compact(SWEEP_N, SWEEP_KEPT), 0.0289, 4),
    (rf.metrics_fused([UB], [86_400]), 0.0128, 4),
    (rf.metrics_fused([KEPT], [3600]), 0.00053, 5),
    (rf.metrics_fused(SWEEP_KEPT, SWEEP_RANGES), 0.0026, 4),
    (rf.trend_scan(6, 86_400), 0.00124, 5),
    (rf.pair_stats(6, 3600), 0.00003, 5),
])
def test_bounds_match_the_table(launch, want_ms, digits):
    assert round(_ms(launch), digits) == pytest.approx(want_ms)


def test_no_byte_counted_twice():
    """Each formula is the bytes the work needs, read once and written
    once: rows at their own lengths, no padding."""
    assert rf.stream_sample([5000, 70], [600, 60])[1] == \
        5070 * (4 + 4 + 1) + 12 * (600 + 62) + 2 * 16
    assert rf.compact([5000, 70], [50, 7])[1] == 5070 + 57 * 4 + 2 * 4
    assert rf.metrics_fused([5000, 7], [600, 60])[1] == 5007 * 4 + \
        2 * 4 + 660 * 4 + 2 * 2 * 4
    assert rf.trend_scan(3, 1000)[1] == 3 * 1000 * 4 * 2
    assert rf.pair_stats(4, 100)[1] == 4 * 100 * 4 + 4 * 4 + 16 * 4


def test_rows_count_at_their_own_length():
    """A short row costs its own records, not the widest row's."""
    one = rf.stream_sample([UB], [3600])[1]
    two = rf.stream_sample([UB, 1000], [3600, 3600])[1]
    assert two - one == 1000 * 9 + 12 * 3600 + 16
    assert rf.compact([UB, 1000], [KEPT, 10])[1] - \
        rf.compact([UB], [KEPT])[1] == 1000 + 40 + 4


def test_job_launches_of_each_entry():
    records = {"a": 3000, "b": 2000}
    seconds = {"a": 86_400, "b": 86_399}
    kept = {("a", 600): 30, ("b", 600): 20, ("a", 1200): 60,
            ("b", 1200): 40}
    run = rf.job_launches("run", ["a"], [600], records, seconds, kept)
    assert [f for f, _, _ in run] == ["stream_sample", "compact",
                                      "metrics_fused", "metrics_fused"]
    many = rf.job_launches("run_many", ["a", "b"], [600, 1200], records,
                           seconds, kept)
    assert [f for f, _, _ in many].count("trend_scan") == 2
    assert [f for f, _, _ in many].count("pair_stats") == 2
    assert len(many) == 8
    assert many[1] == rf.compact([3000, 3000, 2000, 2000], [30, 60, 20, 40])


def _trace(events, labels):
    from stream_bench.trace import DeviceTrace
    return DeviceTrace([(n, k, a, b) for n, k, a, b in events], set(labels))


def test_device_trace_busy_and_idle_by_host_range():
    tr = _trace([("bench.window", "CPU", 0, 100), ("job", "CPU", 0, 60),
                 ("load", "CPU", 10, 30), ("k", "CUDA", 40, 50),
                 ("copy", "CUDA", 45, 55), ("k", "CUDA", 70, 75),
                 ("load", "CUDA", 10, 30)],   # a range's device mirror
                ["bench.window", "job", "load"])
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(20e-6)
    idle = dict(tr.idle_by_host())
    assert idle == pytest.approx({"job": 25e-6, "load": 20e-6,
                                  "untraced": 35e-6})
    assert sum(idle.values()) + tr.busy_s() == pytest.approx(tr.window_s)


def test_share_charges_every_kernel_whatever_its_name():
    """The bound is the jobs' work; the time is every kernel's, however
    many launches and under whatever name, and copies are left out."""
    tr = _trace([("stream_sample_kernel<true>", "CUDA", 0, 40),
                 ("a_fused_kernel_of_a_later_program", "CUDA", 50, 60),
                 ("metrics_fused<false>", "CUDA", 70, 80),
                 ("metrics_fused<false>", "CUDA", 85, 90),
                 ("Memcpy HtoD (Pageable -> Device)", "CUDA", 90, 190),
                 ("Memset (Device)", "CUDA", 190, 191)], [])
    launches = [rf.stream_sample([1000], [60]), rf.compact([1000], [10]),
                rf.metrics_fused([10], [60])]
    bound, secs = rf.share(launches, 3, tr)
    assert secs == pytest.approx(65e-6)
    assert bound == pytest.approx(3 * sum(rf.bound_s(b, o)
                                          for _, b, o in launches))
