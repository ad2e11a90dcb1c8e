"""PSDA — Producing Stream Data (paper Algorithm 2).

The paper's producer loads the simulated stream from the database and emits
the records of scale-stamp second ``i`` at wall-clock second ``i``, each emit
scheduling the next via ``threading.Timer`` (a chained-timer parallel send).

Two clocks are provided:

- :class:`RealClock` — faithful to the paper: chained ``threading.Timer``
  ticks, one bucket per wall-clock second (for live demos / load tests).
- :class:`VirtualClock` — identical ordering/batching semantics but time
  advances instantly; this is what tests and CPU benchmarks use, so a
  600-second simulation does not sleep for 10 minutes. The *consumer* still
  observes the same bucket sequence with the same emit_time stamps.

Emitting a bucket means a single vectorized slice (records are pre-grouped by
scale_stamp), not a per-record loop — the beyond-paper optimization; the
per-record variant is kept for the §Perf baseline comparison.

Fault injection (chaos layer)
-----------------------------
The producer accepts a seeded fault schedule
(:mod:`repro_torch.streamsim.faults`): ``Producer(faults=<FaultInjector>)``.
Scheduled drops, duplicates, bounded reorders, delay jitter, and producer
stalls are applied at the emission point; every event is counted and
surfaced in ``stats()`` (``fault_*`` keys, present only when a schedule is
attached), so per-scenario delivery reconciles as ``delivered == emitted -
dropped + duplicated``. A no-op schedule leaves the replay **bit-identical** to the
fault-free pipeline.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.streamsim.faults import FaultInjector
from repro_torch.streamsim.preprocess import Stream
from repro_torch.streamsim.queue import Bucket, StreamQueue

STATUS_SUCCESS = 0  # paper: success:0
STATUS_FAULT = 1    # paper: fault:1


class VirtualClock:
    """Simulated time: sleep() advances a counter instantly."""

    def __init__(self):
        self.now = 0.0

    def sleep(self, s: float) -> None:
        self.now += s

    def time(self) -> float:
        return self.now


class RealClock:
    """Wall-clock time (the paper's timer-thread behaviour)."""

    def sleep(self, s: float) -> None:
        time.sleep(s)

    def time(self) -> float:
        return time.time()


def _group_by_scale_stamp(stream: Stream):
    """Pre-slice the stream into per-bucket views (sorted by construction).

    ``np.unique(ss, return_index=True)`` on the non-decreasing stamps gives
    every non-empty bucket's first offset in one vectorized pass, so host
    work is O(n + #non-empty buckets) instead of a Python loop over the full
    ``max_range`` (which dominates for sparse simulated streams).
    """
    ss = stream.scale_stamp
    if ss is None:
        raise ValueError("producer needs a simulated stream (run NSA first)")
    if len(ss) == 0:
        return {}, 0
    max_range = int(ss[-1]) + 1
    buckets, first = np.unique(ss, return_index=True)
    bounds = np.append(first, len(ss))
    slices = {int(b): slice(int(lo), int(hi))
              for b, lo, hi in zip(buckets, bounds[:-1], bounds[1:])}
    return slices, max_range


def _dup_bucket(bucket: Bucket) -> Bucket:
    """A duplicate delivery: fresh Bucket object, shared column views
    (the transport re-sent the message, it did not copy the records)."""
    return Bucket(scale_stamp=bucket.scale_stamp, t=bucket.t,
                  payload=bucket.payload, emit_time=bucket.emit_time)


class Producer:
    """Sends the simulated stream to the SPS in chronological order.

    ``run()`` returns the paper's status code (success:0 / fault:1).
    ``faults`` optionally attaches one scenario's deterministic fault
    schedule (:class:`repro_torch.streamsim.faults.FaultInjector`); the caller
    owns the schedule lifecycle (``reset()`` it before re-running the
    same stream, as the engine's retry path does)."""

    def __init__(self, stream: Stream, queue: StreamQueue,
                 clock: Optional[object] = None,
                 tick_s: float = 1.0,
                 on_emit: Optional[Callable[[Bucket], None]] = None,
                 faults: Optional[FaultInjector] = None):
        self.stream = stream
        self.queue = queue
        self.clock = clock if clock is not None else VirtualClock()
        self.tick_s = tick_s
        self.on_emit = on_emit
        self.faults = faults
        self.emitted_buckets = 0
        self.emitted_records = 0
        self.aborted_buckets = 0

    # ------------------------------------------------------------- emission
    def _emit(self, b: int, sl: slice) -> None:
        faults = self.faults
        if faults is None or faults.spec.is_noop:
            bucket = Bucket(
                scale_stamp=b,
                t=self.stream.t[sl],
                payload={k: v[sl] for k, v in self.stream.payload.items()},
                emit_time=self.clock.time(),
            )
            self.queue.put(bucket)
            self.emitted_buckets += 1
            self.emitted_records += len(bucket)
            if self.on_emit is not None:
                self.on_emit(bucket)
            return
        # chaos path: stall/jitter sleeps happen BEFORE the bucket is
        # stamped (the transport delayed the send, so emit_time moves)
        action = faults.draw()
        if action.stall_s > 0.0:
            self.clock.sleep(action.stall_s)
        if action.delay_s > 0.0:
            self.clock.sleep(action.delay_s)
        bucket = Bucket(
            scale_stamp=b,
            t=self.stream.t[sl],
            payload={k: v[sl] for k, v in self.stream.payload.items()},
            emit_time=self.clock.time(),
        )
        self.emitted_buckets += 1          # emissions count ATTEMPTS
        self.emitted_records += len(bucket)
        # earlier holds advance on EVERY emission (held ones included),
        # so a hold of n releases exactly n emissions later
        released = faults.release_due()
        if action.hold:                    # bounded reorder: park it
            faults.hold(bucket, action.hold)
        elif not action.drop:
            self.queue.put(bucket)
            if action.duplicate:
                self.queue.put(_dup_bucket(bucket))
            if self.on_emit is not None:
                self.on_emit(bucket)
        for rb in released:                # late-delivered held buckets
            self.queue.put(rb)

    def _flush_faults(self) -> None:
        """Deliver any still-held (reordered) buckets before close —
        bounded reorder never silently becomes a drop."""
        if self.faults is not None:
            for rb in self.faults.flush():
                self.queue.put(rb)

    # ------------------------------------------------------------ main loop
    def run(self) -> int:
        """Virtual-time run (default): tick per simulated second, in order.

        Under a :class:`VirtualClock` the sleeps across empty-bucket gaps
        are batched into one ``sleep(gap * tick_s)`` call, so host work is
        O(#non-empty buckets) instead of O(max_range) — sparse simulated
        streams (large ``max_range``, few records) no longer pay a Python
        tick per empty second. The consumer-observable behaviour (bucket
        sequence, per-bucket ``emit_time``, final clock value) is identical
        to per-second ticking; any other clock keeps the paper's literal
        one-``sleep``-per-second loop (:meth:`_run_per_tick`).
        """
        try:
            if isinstance(self.clock, VirtualClock):
                # max_range is the last stamp + 1, so the final emit always
                # lands on the last simulated second — no trailing gap
                slices, _ = _group_by_scale_stamp(self.stream)
                prev = -1
                for b, sl in slices.items():   # sorted: stamps non-decreasing
                    self.clock.sleep((b - prev) * self.tick_s)
                    self._emit(b, sl)          # if len(block) != 0: P(block)
                    prev = b
                self._flush_faults()
                self.queue.close()
                return STATUS_SUCCESS
            return self._run_per_tick()
        except Exception:
            self.queue.close()
            return STATUS_FAULT

    def _run_per_tick(self) -> int:
        """The per-second loop (RealClock path, and the equivalence oracle
        for the gap-batched virtual run)."""
        try:
            slices, max_range = _group_by_scale_stamp(self.stream)
            for b in range(max_range):
                self.clock.sleep(self.tick_s)  # paper: time.sleep(1)
                if b in slices:                # if len(block) != 0: P(block)
                    self._emit(b, slices[b])
            self._flush_faults()
            self.queue.close()
            return STATUS_SUCCESS
        except Exception:
            self.queue.close()
            return STATUS_FAULT

    def run_threaded(self) -> int:
        """Paper-faithful chained ``threading.Timer`` emission (RealClock).

        Each tick schedules the next (Algorithm 2's ``emit`` defining
        ``timer <- threading.Timer(1.0, emit, [ite+1])``); the main thread
        plays the watchdog loop ("Detecting lived emit thread").
        """
        slices, max_range = _group_by_scale_stamp(self.stream)
        done = threading.Event()
        status = [STATUS_SUCCESS]

        def emit(ite: int) -> None:
            try:
                if ite >= max_range:
                    done.set()
                    return
                timer = threading.Timer(self.tick_s, emit, [ite + 1])
                timer.daemon = True
                timer.start()
                if ite in slices:
                    self._emit(ite, slices[ite])
            except Exception:
                status[0] = STATUS_FAULT
                done.set()

        first = threading.Timer(self.tick_s, emit, [0])
        first.daemon = True
        first.start()
        while not done.wait(timeout=self.tick_s):  # While TRUE do / sleep(1)
            pass
        if status[0] == STATUS_SUCCESS:
            try:
                self._flush_faults()
            except Exception:
                status[0] = STATUS_FAULT
        self.queue.close()
        return status[0]

    def stats(self) -> Dict[str, int]:
        out = {
            "emitted_buckets": self.emitted_buckets,
            "emitted_records": self.emitted_records,
            "aborted_buckets": self.aborted_buckets,
        }
        if self.faults is not None:
            out.update(self.faults.stats())
        return out
