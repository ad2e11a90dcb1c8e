"""Test set-up of the benchmark's own tests: the numbers each cell added
after ``test_stream_bench_harness.py`` was written prints in its checks,
in order, for that file's ``CHECK_KEYS`` (a chunked cell's: the
monolithic grid's and ``feed_hwm``)."""

from stream_bench import test_stream_bench_harness as _harness

_harness.CHECK_KEYS.setdefault(
    "ub-9day.r3600", list(_harness.CHECK_KEYS[_harness.CHUNKED]))
