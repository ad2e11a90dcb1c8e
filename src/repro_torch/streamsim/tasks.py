"""Stream tasks: the SPS workloads the paper times, as replay consumers.

Counterpart of part of ``repro/streamsim/tasks.py``: the task contract
(:class:`StreamTask`, :func:`output_series`, the latency-bin geometry) and
:class:`ServingTask`, the serving workload. Every task is a drop-in replay
consumer — ``task(queue) -> dict`` — so it plugs into
:func:`repro_torch.streamsim.engine.replay_one`/``replay_many`` and
:meth:`repro_torch.streamsim.controller.Controller.run`/``run_many``.

Each call returns, alongside task-specific metrics:

- ``task_output_counts`` — the task's own output stream as per-second
  counts indexed by scale stamp;
- ``task_latency_bins`` — latencies quantized into ``bin_us``-wide integer
  bins, the last bin absorbing everything beyond. Latency bins are
  wall-time measurements and therefore the one non-deterministic output;
  everything else is a pure function of the replayed buckets.

The host-side bucket tasks (``BucketTask``, ``ETLTask``,
``WindowedStatsTask``, ``EventDetectTask``) and the taskbench come with the
task-tier slice.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.streamsim.queue import StreamQueue

__all__ = [
    "LATENCY_BINS",
    "LATENCY_BIN_US",
    "ServingTask",
    "StreamTask",
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
