"""Parity of the port's task tier (``repro_torch.streamsim.tasks`` and
``taskbench``) with the JAX package, on the CPU.

The bucket tasks are host code in both packages: on the same buckets they
must give the same output series, record and bucket counts and
task-specific counters, exactly. The task bench runs the port's torch
backend on the CPU (``device="cpu"``: kernel B3's and B5's plain
versions) against the JAX package's numpy runner: the same records and a
trend fidelity within 1e-3 (the float32 device chain against float64).
Latency bins and speedups are wall-clock measurements and are never
compared across packages or runs.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import repro.streamsim as J
import repro_torch.streamsim as T
from repro.streamsim import engine as jengine
from repro.streamsim import taskbench as jtaskbench
from repro.streamsim.queue import Bucket as JBucket
from repro.streamsim.queue import StreamQueue as JQueue
from repro_torch.streamsim import engine as tengine
from repro_torch.streamsim import taskbench as ttaskbench
from repro_torch.streamsim.queue import Bucket as TBucket
from repro_torch.streamsim.queue import StreamQueue as TQueue

CPU = "cpu"

#: (name, keyword arguments) of each task configuration held to the
#: reference; both packages build the task from the same arguments
TASKS = [
    ("ETLTask", {}),
    ("ETLTask", {"bounds": {"v": (0.0, 5.0), "w": (-1.0, 1.0)}}),
    ("WindowedStatsTask", {"window_s": 30}),
    ("WindowedStatsTask", {"window_s": 7, "mode": "tumbling"}),
    ("EventDetectTask", {"mode": "threshold", "threshold": 4.0}),
    ("EventDetectTask", {"mode": "threshold", "threshold": 2.0,
                         "reorder_tolerance": 3}),
    ("EventDetectTask", {"mode": "cusum", "drift": 0.5, "h": 3.0}),
    ("EventDetectTask", {"mode": "cusum", "drift": 0.25, "h": 2.0,
                         "reorder_tolerance": 4}),
]
#: outputs that are pure functions of the replayed buckets
COUNTERS = ("task", "task_buckets", "task_records", "etl_clean", "etl_dirty",
            "etl_checksum", "stats_mode", "stats_window_s", "stats_peak",
            "stats_mean", "detect_mode", "detect_events", "detect_tolerance")
SERIES = ("task_output_counts", "stats_aggregate", "task_events")


def _task_id(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in sorted(kw.items()))


def _pair(case):
    name, kw = case
    return getattr(J, name)(**kw), getattr(T, name)(**kw)


def _assert_same_output(got, want):
    for key in COUNTERS:
        assert (key in got) == (key in want), key
        if key in want:
            assert got[key] == want[key], key
    for key in SERIES:
        assert (key in got) == (key in want), key
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for m in (got, want):
        assert m["task_latency_bins"].dtype == np.int32
        assert len(m["task_latency_bins"]) == m["task_buckets"]


def _buckets(seed=0, n=240):
    """A seeded bucket sequence: ragged per-second counts (zeros and
    bursts), a string column, NaNs and out-of-bounds values, stamps
    locally shuffled (each at most 3 places from its order) and one
    duplicated."""
    rng = np.random.default_rng(seed)
    stamps = np.arange(n)
    for i in range(0, n - 3, 4):
        stamps[i:i + 4] = rng.permutation(stamps[i:i + 4])
    stamps = np.insert(stamps, n // 2, stamps[n // 2])
    out = []
    for s in stamps:
        c = int(rng.choice([0, 1, 2, 3, 5, 9], p=[.1, .2, .3, .2, .15, .05]))
        v = rng.normal(2.0, 3.0, c)
        v[rng.random(c) < 0.05] = np.nan
        w = rng.normal(0.0, 0.8, c)
        words = np.array([f"q{int(x)}" for x in rng.integers(0, 50, c)])
        out.append((int(s), np.full(c, float(s)),
                    {"v": v, "w": w, "word": words}))
    return out


def _feed(queue_cls, bucket_cls, buckets):
    q = queue_cls(maxsize=len(buckets) + 1)
    for s, t, payload in buckets:
        q.put(bucket_cls(scale_stamp=s, t=t.copy(),
                         payload={k: v.copy() for k, v in payload.items()},
                         emit_time=0.0))
    q.close()
    return q


@pytest.fixture(scope="module")
def source():
    """The reference suite's fixture: a 2-hour slice of sogouq at scale
    0.3 and its simulation at max_range 100, made by each package."""
    j_orig = J.slice_stream(J.preprocess(J.make_stream("sogouq", scale=0.3,
                                                       seed=0)), 7200)
    t_orig = T.slice_stream(T.preprocess(T.make_stream("sogouq", scale=0.3,
                                                       seed=0)), 7200)
    np.testing.assert_array_equal(j_orig.t, t_orig.t)
    return (j_orig, J.nsa(j_orig, 100)), (t_orig, T.nsa(t_orig, 100))


# ------------------------------------------------------------ bucket tasks
@pytest.mark.parametrize("case", TASKS, ids=_task_id)
def test_task_matches_reference_on_same_queue(case):
    jt, tt = _pair(case)
    buckets = _buckets()
    _assert_same_output(tt(_feed(TQueue, TBucket, buckets)),
                        jt(_feed(JQueue, JBucket, buckets)))


@pytest.mark.parametrize("case", TASKS, ids=_task_id)
def test_task_matches_reference_through_replay_many(case, source):
    """The fixture's original (as the bench replays it) and its simulation,
    through each package's replay_many with one task instance draining
    both scenarios concurrently."""
    (j_orig, j_sim), (t_orig, t_sim) = source
    jt, tt = _pair(case)
    j_runs, _ = jengine.replay_many(
        {"orig": J.original_replay_stream(j_orig), "sim": j_sim}, jt, 64)
    t_runs, _ = tengine.replay_many(
        {"orig": T.original_replay_stream(t_orig), "sim": t_sim}, tt, 64)
    for key in ("orig", "sim"):
        _assert_same_output(t_runs[key], j_runs[key])
    assert t_runs["sim"]["task_records"] == len(t_sim.t)
    assert t_runs["orig"]["task_records"] == len(t_orig.t)


def test_windowed_aggregate_matches_reference():
    q = np.random.default_rng(3).integers(0, 40, 1001)
    for kw in ({"window_s": 16}, {"window_s": 16, "mode": "tumbling"},
               {"window_s": 5000}, {"window_s": 1, "mode": "tumbling"}):
        np.testing.assert_array_equal(T.WindowedStatsTask(**kw).aggregate(q),
                                      J.WindowedStatsTask(**kw).aggregate(q))
    assert len(T.WindowedStatsTask(mode="tumbling").aggregate([])) == 0


@pytest.mark.parametrize("case", [
    ("BucketTask", {"bin_us": 0}),
    ("BucketTask", {"n_bins": 1}),
    ("ETLTask", {"bin_us": -1.0}),
    ("WindowedStatsTask", {"mode": "hopping"}),
    ("WindowedStatsTask", {"window_s": 0}),
    ("EventDetectTask", {"mode": "zscore"}),
    ("EventDetectTask", {"mode": "threshold"}),
    ("EventDetectTask", {"mode": "cusum", "reorder_tolerance": -1}),
], ids=_task_id)
def test_task_constructors_raise_as_reference(case):
    name, kw = case
    with pytest.raises(ValueError) as want:
        getattr(J, name)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(T, name)(**kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- task bench
@pytest.fixture(scope="module")
def bench_pair():
    """The reference suite's bench over its three bucket tasks: the JAX
    package's numpy runner and the port's torch runner on the CPU."""
    kw = dict(scale=0.3, seed=0, span_s=7200)

    def tasks(pkg):
        return [pkg.ETLTask(), pkg.WindowedStatsTask(window_s=30),
                pkg.EventDetectTask(mode="threshold", threshold=4.0)]

    want = J.TaskBenchRunner(["sogouq"], [100, 600], backend="numpy",
                             **kw).run(tasks(J))
    got = T.TaskBenchRunner(["sogouq"], [100, 600], backend="torch",
                            device=CPU, **kw).run(tasks(T))
    return got, want


def test_runner_matches_reference(bench_pair):
    got, want = bench_pair
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g.task, g.dataset, g.max_range) == (w.task, w.dataset,
                                                    w.max_range)
        assert g.records_original == w.records_original
        assert g.records_simulated == w.records_simulated
        assert abs(g.trend_fidelity - w.trend_fidelity) <= 1e-3
        assert g.cv_original == w.cv_original
        assert g.cv_simulated == w.cv_simulated
        assert g.paper_ratio == w.paper_ratio == T.PAPER_SPEEDUP
        assert g.trend_fidelity >= T.FIDELITY_FLOOR == J.FIDELITY_FLOOR
        assert g.speedup > 1.0
        assert set(g.to_dict()) == set(w.to_dict())
        assert g.latency["samples"] == w.latency["samples"]


def test_runner_torch_matches_its_numpy_backend(bench_pair, source):
    """The torch chain against the port's own float64 numpy chain on the
    same output series, through the runner's own correlation call."""
    got, _ = bench_pair
    (_, _), (t_orig, t_sim) = source
    task = T.WindowedStatsTask(window_s=30)
    runs, _ = tengine.replay_many(
        {"orig": T.original_replay_stream(t_orig), "sim": t_sim}, task, 64)
    series = [runs["orig"]["task_output_counts"],
              runs["sim"]["task_output_counts"]]
    c_t = T.trend_correlation_matrix(series, 60, backend="torch", device=CPU)
    c_n = T.trend_correlation_matrix(series, 60, backend="numpy")
    assert abs(c_t[0, 1] - c_n[0, 1]) <= 1e-3
    rep = [r for r in got if r.task == task.name and r.max_range == 100][0]
    assert abs(rep.trend_fidelity - c_n[0, 1]) <= 1e-3


def test_original_replay_and_slice_match_reference(source):
    (j_orig, _), (t_orig, _) = source
    np.testing.assert_array_equal(
        T.original_replay_stream(t_orig).scale_stamp,
        J.original_replay_stream(j_orig).scale_stamp)
    for span in (1, 600, 10 ** 6):
        np.testing.assert_array_equal(T.slice_stream(t_orig, span).t,
                                      J.slice_stream(j_orig, span).t)
    with pytest.raises(ValueError, match="span_s must be positive"):
        T.slice_stream(t_orig, 0)


# ------------------------------------------------------- latency summaries
def _bin_rows(seed=0):
    """Seeded latency-bin rows: skewed, empty, all in the overflow bin,
    one sample, and a wide row touching both ends."""
    rng = np.random.default_rng(seed)
    n_bins = T.LATENCY_BINS
    return [rng.geometric(0.05, 5000).clip(0, n_bins - 1).astype(np.int32),
            np.zeros(0, np.int32),
            np.full(37, n_bins - 1, np.int32),
            np.array([7], np.int32),
            np.concatenate([rng.integers(0, n_bins, 2999),
                            [0, n_bins - 1]]).astype(np.int32)]


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_summaries_equal_reference(backend):
    rows = _bin_rows()
    want = J.summarize_latencies(rows, backend="numpy")
    got = T.summarize_latencies(rows, backend=backend, device=CPU)
    assert len(got) == len(want) == len(rows)
    for g, w in zip(got, want):
        gd, wd = g.to_dict(), w.to_dict()
        assert set(gd) == set(wd)
        for key in wd:
            assert gd[key] == wd[key] or (np.isnan(gd[key])
                                          and np.isnan(wd[key])), key
    assert T.summarize_latencies([], device=CPU) == []


def test_hist_rows_equal_bincount_and_reference():
    rows = _bin_rows(1)
    want = jtaskbench._hist_rows(rows, 2048, "numpy")
    np.testing.assert_array_equal(
        ttaskbench._hist_rows(rows, 2048, "torch", torch.device(CPU)), want)
    np.testing.assert_array_equal(
        ttaskbench._hist_rows(rows, 2048, "numpy"), want)


def test_summaries_one_histogram_call(monkeypatch):
    from repro_torch.kernels import ops
    calls = []
    real = ops.stream_metrics_batched

    def spy(arrays, max_range, **kw):
        calls.append(len(arrays))
        return real(arrays, max_range, **kw)

    monkeypatch.setattr(ops, "stream_metrics_batched", spy)
    T.summarize_latencies(_bin_rows(), device=CPU)
    assert calls == [5]


# -------------------------------------------------------- devices, errors
def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.TaskBenchRunner(["sogouq"], [100], backend="torch")
    with pytest.raises(RuntimeError, match="cuda"):
        T.TaskBenchRunner(["sogouq"], [100])
    with pytest.raises(RuntimeError, match="cuda"):
        T.summarize_latencies([np.zeros(3, np.int32)], backend="auto")
    # the numpy backend asks for no device
    T.TaskBenchRunner(["sogouq"], [100], backend="numpy")
    assert T.summarize_latencies([np.zeros(3, np.int32)],
                                 backend="numpy")[0].samples == 3


@pytest.mark.parametrize("args", [([], [100]), (["sogouq"], [])],
                         ids=["no-datasets", "no-ranges"])
def test_runner_rejects_what_reference_rejects(args):
    with pytest.raises(ValueError) as want:
        J.TaskBenchRunner(*args)
    with pytest.raises(ValueError) as got:
        T.TaskBenchRunner(*args, device=CPU)
    assert str(got.value) == str(want.value)


def test_runner_rejects_unknown_backend():
    # the port's vocabulary is numpy | torch | auto (the reference's
    # "pallas" names no backend here)
    with pytest.raises(ValueError, match="backend must be one of"):
        T.TaskBenchRunner(["sogouq"], [100], backend="pallas", device=CPU)
    with pytest.raises(ValueError, match="backend must be one of"):
        T.summarize_latencies([np.zeros(1, np.int32)], backend="pallas")
