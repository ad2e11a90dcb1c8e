"""Stream tasks: the SPS workloads the paper times, as replay consumers.

Counterpart of ``repro/streamsim/tasks.py``. The taxonomy follows Shukla &
Simmhan's RIoTBench application dataflows: :class:`ETLTask` (parse /
clean / annotate), :class:`WindowedStatsTask` (statistical summarization)
and :class:`EventDetectTask` (Karras et al.'s threshold / CUSUM event
detectors), all on the shared :class:`BucketTask` machinery, plus
:class:`ServingTask`, the serving workload. Every task is a drop-in replay
consumer — ``task(queue) -> dict`` — so it plugs into
:func:`repro_torch.streamsim.engine.replay_one`/``replay_many`` and
:meth:`repro_torch.streamsim.controller.Controller.run`/``run_many``.

Each call returns, alongside task-specific metrics:

- ``task_output_counts`` — the task's own output stream as per-second
  counts indexed by scale stamp;
- ``task_latency_bins`` — latencies quantized into ``bin_us``-wide integer
  bins, the last bin absorbing everything beyond. The bins are
  scale-stamp-shaped integers, so a whole sweep's worth feeds one fused
  histogram call (:func:`repro_torch.streamsim.taskbench.
  summarize_latencies`). Latency bins are wall-time measurements and
  therefore the one non-deterministic output; everything else is a pure
  function of the replayed buckets.

All per-replay state lives in a per-call state object, so one task
instance can drain many sweep scenarios concurrently (the engine runs one
consumer thread per scenario).
"""

from __future__ import annotations

import heapq
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.streamsim.metrics import sliding_mean
from repro_torch.streamsim.queue import Bucket, StreamQueue

__all__ = [
    "LATENCY_BINS",
    "LATENCY_BIN_US",
    "BucketTask",
    "ETLTask",
    "EventDetectTask",
    "ServingTask",
    "StreamTask",
    "WindowedStatsTask",
    "output_series",
]

#: default latency-histogram geometry shared by the tasks: bins of
#: ``LATENCY_BIN_US`` microseconds, the last bin absorbing everything past
#: ``LATENCY_BINS * LATENCY_BIN_US``.
LATENCY_BIN_US = 5.0
LATENCY_BINS = 2048


class StreamTask:
    """Structural contract of a stream task (duck-typed, no ABC machinery):
    a named callable consuming one scenario's queue and returning a metrics
    dict that carries ``task_output_counts`` + ``task_latency_bins``."""

    #: task name, surfaced in reports and in the engine's wedged-consumer
    #: deadline errors (see :func:`repro_torch.streamsim.engine.
    #: consumer_label`)
    name: str = "task"

    def __call__(self, queue: StreamQueue) -> Dict:
        raise NotImplementedError


def output_series(stamps, counts) -> np.ndarray:
    """Per-second output series from (scale stamp, count) pairs.

    Duplicate stamps accumulate (a duplicated bucket under a fault plan
    lands on the same simulated second, exactly like a duplicated Kafka
    record would); the array spans ``[0, max(stamp)]``.
    """
    stamps = np.asarray(stamps, np.int64).reshape(-1)
    counts = np.asarray(counts, np.int64).reshape(-1)
    if len(stamps) == 0:
        return np.zeros(0, np.int64)
    if stamps.min() < 0:
        raise ValueError("scale stamps must be non-negative")
    out = np.zeros(int(stamps.max()) + 1, np.int64)
    np.add.at(out, stamps, counts)
    return out


class BucketTask(StreamTask):
    """Shared per-bucket machinery for the host-side tasks.

    Subclasses implement ``_start() -> state``, ``_process(state, bucket)
    -> int`` (the task's output count for that bucket) and optionally
    ``_finalize(state, out) -> dict`` (extra metrics, and the place to
    flush any held-back input). The base class owns the consumer loop,
    the per-bucket latency clock, and the common metric keys.
    """

    name = "bucket-task"

    def __init__(self, *, bin_us: float = LATENCY_BIN_US,
                 n_bins: int = LATENCY_BINS):
        if bin_us <= 0:
            raise ValueError("bin_us must be positive")
        if n_bins < 2:
            raise ValueError("n_bins must be >= 2")
        self.bin_us = float(bin_us)
        self.n_bins = int(n_bins)

    # ------------------------------------------------------ subclass hooks
    def _start(self):
        raise NotImplementedError

    def _process(self, state, bucket: Bucket) -> int:
        raise NotImplementedError

    def _finalize(self, state, out: np.ndarray) -> Dict:
        return {}

    # --------------------------------------------------- consumer contract
    def __call__(self, queue: StreamQueue) -> Dict:
        state = self._start()
        stamps: List[int] = []
        emitted: List[int] = []
        lat: List[int] = []
        records = 0
        t0 = time.perf_counter()
        for bucket in queue:
            tb = time.perf_counter()
            n_out = self._process(state, bucket)
            dt_us = (time.perf_counter() - tb) * 1e6
            lat.append(min(int(dt_us / self.bin_us), self.n_bins - 1))
            records += len(bucket)
            stamps.append(int(bucket.scale_stamp))
            emitted.append(int(n_out))
        wall = time.perf_counter() - t0
        out = output_series(stamps, emitted)
        metrics = {
            "task": self.name,
            "task_buckets": len(lat),
            "task_records": records,
            "task_wall_s": wall,
            "task_throughput_rps": records / wall if wall > 0 else 0.0,
            "task_latency_bins": np.asarray(lat, np.int32),
            "task_output_counts": out,
        }
        metrics.update(self._finalize(state, out))
        return metrics


# --------------------------------------------------------------- ETL task
def _parse_column(values: np.ndarray) -> np.ndarray:
    """Parse one payload column to float64. String columns hash through
    crc32 (stable across processes, unlike ``hash``) so the parse work is
    real but reproducible."""
    v = np.asarray(values)
    if v.dtype.kind in "US":
        return np.array([zlib.crc32(str(s).encode()) % 10_000 for s in v],
                        np.float64)
    return v.astype(np.float64)


class ETLTask(BucketTask):
    """Parse / clean / annotate per bucket (the RIoTBench ETL dataflow).

    Per bucket: every payload column is parsed to float64; records with a
    non-finite or out-of-``bounds`` value in ANY column are dropped
    (clean); survivors are annotated with a per-record feature (the column
    sum) folded into a running checksum so the annotate stage cannot be
    dead-code-eliminated. Output stream = cleaned records per second.

    Parameters
    ----------
    bounds : dict, optional
        ``{column: (lo, hi)}`` inclusive validity ranges; columns absent
        from the dict are only checked for finiteness.
    """

    name = "etl"

    def __init__(self, bounds: Optional[Dict[str, Tuple[float, float]]]
                 = None, **kw):
        super().__init__(**kw)
        self.bounds = dict(bounds or {})

    def _start(self):
        return {"clean": 0, "dirty": 0, "checksum": 0}

    def _process(self, state, bucket: Bucket) -> int:
        n = len(bucket)
        keep = np.ones(n, bool)
        annot = np.zeros(n, np.float64)
        for col, values in bucket.payload.items():
            x = _parse_column(values)
            finite = np.isfinite(x)
            lo, hi = self.bounds.get(col, (-np.inf, np.inf))
            keep &= finite & (x >= lo) & (x <= hi)
            annot += np.where(finite, x, 0.0)
        kept = int(keep.sum())
        state["clean"] += kept
        state["dirty"] += n - kept
        state["checksum"] = (state["checksum"]
                             + int(np.round(annot[keep].sum()))) % (2 ** 31)
        return kept

    def _finalize(self, state, out):
        return {"etl_clean": state["clean"], "etl_dirty": state["dirty"],
                "etl_checksum": state["checksum"]}


# --------------------------------------------------------------- STATS task
class WindowedStatsTask(BucketTask):
    """Tumbling/sliding count aggregates (the RIoTBench STATS dataflow).

    Accumulates the per-second record counts keyed by scale stamp and
    aggregates at stream close: ``mode="sliding"`` reuses
    :func:`repro_torch.streamsim.metrics.sliding_mean`'s O(n) cumulative-sum
    machinery (same zero-padded-edge convention), ``mode="tumbling"``
    means over non-overlapping ``window_s`` blocks (the trailing partial
    window divides by its true length). The task's output stream is the
    per-second count series it forwards; the aggregate rides in the
    metrics dict.
    """

    name = "windowed-stats"

    def __init__(self, window_s: int = 60, mode: str = "sliding", **kw):
        super().__init__(**kw)
        if mode not in ("sliding", "tumbling"):
            raise ValueError(f"mode must be 'sliding' or 'tumbling', "
                             f"got {mode!r}")
        if window_s < 1:
            raise ValueError("window_s must be >= 1")
        self.window_s = int(window_s)
        self.mode = mode

    def aggregate(self, q: np.ndarray) -> np.ndarray:
        """The windowed aggregate of a per-second count series (public so
        the property suite can check it against an O(n*w) oracle)."""
        q = np.asarray(q, np.float64).reshape(-1)
        if self.mode == "sliding":
            return sliding_mean(q, self.window_s)
        n, w = len(q), self.window_s
        if n == 0:
            return q
        n_win = -(-n // w)
        padded = np.zeros(n_win * w, np.float64)
        padded[:n] = q
        sums = padded.reshape(n_win, w).sum(axis=1)
        lengths = np.minimum(w, n - w * np.arange(n_win))
        return sums / lengths

    def _start(self):
        return {}

    def _process(self, state, bucket: Bucket) -> int:
        return len(bucket)

    def _finalize(self, state, out):
        agg = self.aggregate(out)
        return {"stats_mode": self.mode, "stats_window_s": self.window_s,
                "stats_aggregate": agg,
                "stats_peak": float(agg.max()) if len(agg) else 0.0,
                "stats_mean": float(agg.mean()) if len(agg) else 0.0}


# ----------------------------------------------------------- detection task
class EventDetectTask(BucketTask):
    """Threshold / CUSUM event detection (Karras et al.'s detector pair).

    Processes the per-bucket record counts as an online sample sequence:

    - ``mode="threshold"`` fires an event for every bucket whose count
      exceeds ``threshold``. Because the event is stamped with the
      triggering bucket's own scale stamp, the SET of event stamps is
      invariant under ANY arrival reorder.
    - ``mode="cusum"`` keeps a one-sided CUSUM against a Welford running
      mean: ``s = max(0, s + (x - mean - drift))``, alarming (and
      resetting) when ``s > h``. Order-sensitive by nature, so a
      ``reorder_tolerance`` is offered:

    ``reorder_tolerance=w`` holds arriving buckets in a min-heap keyed by
    (scale stamp, arrival seq) and only processes a bucket once ``w``
    newer ones have arrived — the streaming watermark idiom. A sequence
    in which every bucket is displaced at most ``w`` positions from stamp
    order is fully re-sorted by a ``w+1``-deep heap, so detection under a
    bounded fault-plan reorder (``FaultSpec.reorder_window <= w``) is
    IDENTICAL to the in-order replay.

    ``task_events`` in the metrics dict carries the event stamps;
    ``task_output_counts`` attributes each event to the bucket being
    processed when it fired (off by <= ``reorder_tolerance`` seconds from
    the triggering stamp; events flushed at close land only in
    ``task_events``).
    """

    name = "event-detect"

    def __init__(self, mode: str = "threshold",
                 threshold: Optional[float] = None, drift: float = 0.5,
                 h: float = 5.0, reorder_tolerance: int = 0, **kw):
        super().__init__(**kw)
        if mode not in ("threshold", "cusum"):
            raise ValueError(f"mode must be 'threshold' or 'cusum', "
                             f"got {mode!r}")
        if mode == "threshold" and threshold is None:
            raise ValueError("mode='threshold' requires a threshold")
        if reorder_tolerance < 0:
            raise ValueError("reorder_tolerance must be >= 0")
        self.mode = mode
        self.threshold = threshold
        self.drift = float(drift)
        self.h = float(h)
        self.reorder_tolerance = int(reorder_tolerance)

    def _start(self):
        return {"pending": [], "seq": 0, "events": [],
                "cusum": 0.0, "mean": 0.0, "n": 0}

    def _step(self, state, stamp: int, x: float) -> int:
        if self.mode == "threshold":
            if x > self.threshold:
                state["events"].append(stamp)
                return 1
            return 0
        state["n"] += 1
        state["mean"] += (x - state["mean"]) / state["n"]
        state["cusum"] = max(
            0.0, state["cusum"] + (x - state["mean"] - self.drift))
        if state["cusum"] > self.h:
            state["events"].append(stamp)
            state["cusum"] = 0.0
            return 1
        return 0

    def _process(self, state, bucket: Bucket) -> int:
        heapq.heappush(state["pending"],
                       (int(bucket.scale_stamp), state["seq"], len(bucket)))
        state["seq"] += 1
        fired = 0
        while len(state["pending"]) > self.reorder_tolerance:
            stamp, _, x = heapq.heappop(state["pending"])
            fired += self._step(state, stamp, float(x))
        return fired

    def _finalize(self, state, out):
        while state["pending"]:   # flush the watermark buffer, in order
            stamp, _, x = heapq.heappop(state["pending"])
            self._step(state, stamp, float(x))
        events = np.asarray(state["events"], np.int64)
        return {"detect_mode": self.mode, "detect_events": len(events),
                "detect_tolerance": self.reorder_tolerance,
                "task_events": events}


# -------------------------------------------------------------- serving task
class ServingTask(StreamTask):
    """Serving workload: :class:`repro_torch.serving.engine.ServingEngine`
    fed by :func:`repro_torch.serving.load.stream_arrivals` — the
    SPS-as-inference-job.

    Latency bins come from the engine's per-request latencies (arrival ->
    finish across ticks, on the wall clock), not per-bucket host time.
    The output stream is the requests admitted per simulated second.

    ``reuse_engine=True`` builds one engine up front and resets it between
    calls (its cache zeroed in place), so repeated replays allocate the
    slots' cache once. A reused engine is not safe for concurrent scenario
    consumers; leave the default for multi-scenario sweeps.

    The default latency bins are 1 ms wide (vs the bucket tasks' 5 us):
    request latencies span model steps plus queueing. The engine runs on
    ``device`` (default CUDA), where ``params`` must lie.
    """

    name = "serving"

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 48,
                 eos_id: int = -1, prompt_len: int = 4,
                 max_new_tokens: int = 4, max_requests_per_bucket: int = 2,
                 reuse_engine: bool = False,
                 bin_us: float = 1000.0, n_bins: int = LATENCY_BINS,
                 device=None):
        if bin_us <= 0:
            raise ValueError("bin_us must be positive")
        if n_bins < 2:
            raise ValueError("n_bins must be >= 2")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.max_requests_per_bucket = max_requests_per_bucket
        self.reuse_engine = reuse_engine
        self.bin_us = float(bin_us)
        self.n_bins = int(n_bins)
        self.device = device
        self._engine = self._make_engine() if reuse_engine else None

    def _make_engine(self):
        from repro_torch.serving.engine import ServingEngine
        return ServingEngine(self.cfg, self.params, slots=self.slots,
                             max_len=self.max_len, eos_id=self.eos_id,
                             device=self.device)

    def __call__(self, queue: StreamQueue) -> Dict:
        from repro_torch.serving.load import stream_arrivals
        if self._engine is not None:
            eng = self._engine
            eng.reset()
        else:
            eng = self._make_engine()
        stamps: List[int] = []
        admitted: List[int] = []
        records = buckets = 0
        t0 = time.perf_counter()
        for ss, reqs in stream_arrivals(
                queue, self.cfg.vocab_size, prompt_len=self.prompt_len,
                max_new_tokens=self.max_new_tokens,
                max_requests_per_bucket=self.max_requests_per_bucket):
            buckets += 1
            for req in reqs:
                # stream_arrivals stamps arrive_t with the bucket's VIRTUAL
                # emit time; the engine ticks on the wall clock. Restamp on
                # the engine's clock so request latency is wall queueing +
                # decode, not the clock-domain gap.
                req.arrive_t = time.perf_counter()
                eng.submit(req)
            records += len(reqs)
            eng.tick()
            stamps.append(int(ss))
            admitted.append(len(reqs))
        eng.drain()
        wall = time.perf_counter() - t0
        lat = np.asarray(
            [min(int(l * 1e6 / self.bin_us), self.n_bins - 1)
             for l in eng.metrics.latencies_s], np.int32)
        summary = eng.metrics.summary()
        return {
            "task": self.name,
            "task_buckets": buckets,
            "task_records": records,
            "task_wall_s": wall,
            "task_throughput_rps": records / wall if wall > 0 else 0.0,
            "task_latency_bins": lat,
            "task_output_counts": output_series(stamps, admitted),
            "serving_finished": summary["finished"],
            "serving_tokens_out": summary["tokens_out"],
            "serving_queue_peak": summary["queue_peak"],
            "serving_decode_steps": summary["decode_steps"],
        }
