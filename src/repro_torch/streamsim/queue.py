"""StreamQueue — the Kafka analogue (paper §4).

The paper inserts a Kafka node between the user-side producer and the stream
processing system: an ordered, buffered pipe with backpressure. This
environment has no external broker, so the queue is in-process but preserves
the broker semantics the pipeline relies on:

- FIFO per-bucket ordering (Kafka partition-order guarantee),
- bounded buffering with producer backpressure (broker retention/quota),
- at-least-once handoff (a bucket is only dropped after the consumer
  acknowledges it by finishing the ``get``),
- poisoned-shutdown (producer can signal end-of-stream). ``close()``
  wakes BOTH blocked consumers (``get`` returns None once drained) and
  blocked producers — a producer stuck in ``put()`` on a full queue, or
  stuck on the group byte budget, raises ``RuntimeError("queue closed")``
  immediately instead of hanging until its timeout.

:class:`ByteBudget` adds the *broker retention* dimension: a
:class:`QueueGroup` built with ``max_bytes`` shares ONE byte budget
across its member queues, with two retention policies:

- ``"block"`` — a put that would exceed the budget blocks until
  consumers drain bytes (global backpressure; a bucket larger than the
  whole budget is admitted alone once the group is empty, so it can
  never deadlock the replay);
- ``"drop_oldest"`` — the globally-oldest buffered bucket (across ALL
  member queues) is evicted to make room, Kafka's retention-eviction
  behaviour; evictions are counted per queue (``dropped_retention`` in
  ``stats()``) and on the budget.

Thread-safe: the real-time producer emits from timer threads (paper
Algorithm 2) while the consumer drains from the main thread. Lock order
is budget → queue (the budget only ever takes a queue lock while holding
its own; queues never wait on the budget while holding their own lock),
so eviction, release, and close can never deadlock each other.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np

_EOS = object()

RETENTION_POLICIES = ("block", "drop_oldest")

#: the fields of :meth:`StreamQueue.stats` and of a chunk feed's stats
#: (:class:`~repro_torch.streamsim.producer.ChunkFeed`) that are seconds
#: waited, not counts: they differ from run to run
WAIT_FIELDS = ("put_wait_s", "get_wait_s", "feed_put_wait_s",
               "feed_get_wait_s")


def counts_only(stats: Dict[str, Any]) -> Dict[str, Any]:
    """``stats`` (a queue's, or a report's ``consumer_metrics``) without
    the seconds waited: what every replay of one sim gives alike."""
    return {k: v for k, v in stats.items() if k not in WAIT_FIELDS}


@dataclasses.dataclass
class Bucket:
    """One simulated second of stream data (what PSDA emits per tick)."""

    scale_stamp: int
    t: np.ndarray
    payload: Dict[str, np.ndarray]
    emit_time: float  # producer clock time at emission

    def __len__(self) -> int:
        return len(self.t)

    def nbytes(self) -> int:
        return self.t.nbytes + sum(v.nbytes for v in self.payload.values())


class ByteBudget:
    """A shared byte cap across a group of queues (broker retention).

    All admission control funnels through :meth:`reserve`; bytes are
    returned either by the consumer's ``get`` (:meth:`release`) or by a
    retention eviction (``drop_oldest``). The budget is the OUTER lock of
    the queue/budget pair: it may briefly take member-queue locks (head
    inspection, eviction) while held, but a queue never waits on the
    budget while holding its own lock.
    """

    def __init__(self, max_bytes: int, policy: str = "block"):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        if policy not in RETENTION_POLICIES:
            raise ValueError(
                f"policy must be one of {RETENTION_POLICIES}, got {policy!r}")
        self.max_bytes = int(max_bytes)
        self.policy = policy
        self.used = 0
        self.dropped_retention = 0
        self._seq = 0                      # global admission order
        self._queues: list = []
        self._cond = threading.Condition(threading.Lock())

    def register(self, queue: "StreamQueue") -> None:
        with self._cond:
            self._queues.append(queue)

    # ----------------------------------------------------------- admission
    def reserve(self, n: int, queue: "StreamQueue") -> int:
        """Claim ``n`` bytes for a bucket entering ``queue``; returns the
        bucket's global admission sequence number.

        ``block``: waits until the group frees bytes (or admits alone when
        the group is empty — an oversized bucket must not deadlock).
        ``drop_oldest``: evicts globally-oldest buckets until the new one
        fits (or nothing is left to evict). Raises ``RuntimeError`` if
        ``queue`` closes while blocked — close() must wake producers.
        """
        with self._cond:
            if self.policy == "drop_oldest":
                while self.used + n > self.max_bytes:
                    victim = self._pick_victim()
                    if victim is None:
                        break              # nothing buffered: admit over cap
                    freed = victim._evict_oldest()
                    if freed is None:
                        continue           # raced with a concurrent get
                    self.used -= freed
                    self.dropped_retention += 1
            elif self.used > 0 and self.used + n > self.max_bytes:
                # admit alone when empty: a bucket bigger than the whole
                # budget would otherwise block forever
                t0 = time.perf_counter()
                try:
                    while self.used > 0 and self.used + n > self.max_bytes:
                        if queue._closed:
                            raise RuntimeError("queue closed")
                        # short waits double as a missed-wakeup safety net
                        self._cond.wait(0.05)
                finally:
                    with queue._lock:      # lock order budget → queue
                        queue.put_wait_s += time.perf_counter() - t0
            if queue._closed:
                raise RuntimeError("queue closed")
            self.used += n
            seq = self._seq
            self._seq += 1
            return seq

    def release(self, n: int) -> None:
        with self._cond:
            self.used -= n
            self._cond.notify_all()

    def wake(self) -> None:
        """Wake blocked reservers (called by ``StreamQueue.close``)."""
        with self._cond:
            self._cond.notify_all()

    def _pick_victim(self) -> Optional["StreamQueue"]:
        """Member queue holding the globally-oldest buffered bucket."""
        best, best_seq = None, None
        for q in self._queues:
            s = q._head_seq()
            if s is not None and (best_seq is None or s < best_seq):
                best, best_seq = q, s
        return best

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "max_bytes": self.max_bytes,
                "policy": self.policy,
                "bytes_used": self.used,
                "dropped_retention": self.dropped_retention,
            }


class StreamQueue:
    def __init__(self, maxsize: int = 64,
                 budget: Optional[ByteBudget] = None):
        self._dq: collections.deque = collections.deque()
        self._seqs: collections.deque = collections.deque()
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._budget = budget
        if budget is not None:
            budget.register(self)
        # transport metrics (paper Fig. 6 reads network bytes; we count them)
        self.bytes_in = 0
        self.buckets_in = 0
        self.records_in = 0
        #: buckets evicted by the group byte budget (never seen by the
        #: consumer; at-least-once stops at broker retention, like Kafka)
        self.dropped_retention = 0
        #: seconds ``put`` waited for room (a full queue or the group's
        #: byte budget) and ``get`` waited for a bucket: which side of the
        #: queue sets the replay's pace; the clock is read only on a wait
        self.put_wait_s = 0.0
        self.get_wait_s = 0.0

    def put(self, bucket: Bucket, timeout: Optional[float] = None) -> None:
        if self._budget is None:
            self._put_admitted(bucket, None, timeout)
            return
        nbytes = bucket.nbytes()
        # budget admission happens OUTSIDE the queue lock (lock order:
        # budget → queue); raises RuntimeError if the queue closes while
        # the producer is parked on the byte budget
        seq = self._budget.reserve(nbytes, self)
        try:
            self._put_admitted(bucket, seq, timeout)
        except BaseException:
            self._budget.release(nbytes)   # reservation must not leak
            raise

    def _put_admitted(self, bucket: Bucket, seq: Optional[int],
                      timeout: Optional[float]) -> None:
        with self._not_full:
            if len(self._dq) >= self._maxsize and not self._closed:
                t0 = time.perf_counter()
                try:
                    while len(self._dq) >= self._maxsize and \
                            not self._closed:
                        if not self._not_full.wait(timeout):
                            raise TimeoutError(
                                "queue full (backpressure timeout)")
                finally:
                    self.put_wait_s += time.perf_counter() - t0
            if self._closed:
                raise RuntimeError("queue closed")
            self._dq.append(bucket)
            if seq is not None:
                self._seqs.append(seq)
            self.bytes_in += bucket.nbytes()
            self.buckets_in += 1
            self.records_in += len(bucket)
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Bucket]:
        """Pop the next bucket; None signals end-of-stream."""
        with self._not_empty:
            if not self._dq and not self._closed:
                t0 = time.perf_counter()
                try:
                    while not self._dq and not self._closed:
                        if not self._not_empty.wait(timeout):
                            raise TimeoutError(
                                "queue empty (consumer timeout)")
                finally:
                    self.get_wait_s += time.perf_counter() - t0
            if not self._dq:
                return None  # closed and drained
            item = self._dq.popleft()
            if self._budget is not None and self._seqs:
                self._seqs.popleft()
            self._not_full.notify()
        # byte release happens OUTSIDE the queue lock (lock order) so a
        # blocked reserver can immediately take the budget lock
        if self._budget is not None and item is not _EOS:
            self._budget.release(item.nbytes())
        return None if item is _EOS else item

    def close(self) -> None:
        """Mark end-of-stream and wake EVERY blocked party: consumers
        drain to None, producers blocked on a full queue or on the group
        byte budget raise ``RuntimeError("queue closed")``."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if self._budget is not None:
            self._budget.wake()

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------- retention internals
    def _head_seq(self) -> Optional[int]:
        """Admission seq of the oldest buffered bucket (budget use only)."""
        with self._lock:
            return self._seqs[0] if self._seqs else None

    def _evict_oldest(self) -> Optional[int]:
        """Drop the oldest buffered bucket; returns its byte size (the
        budget credits it) or None if the queue emptied concurrently."""
        with self._lock:
            if not self._dq:
                return None
            item = self._dq.popleft()
            if self._seqs:
                self._seqs.popleft()
            self.dropped_retention += 1
            self._not_full.notify()
            return item.nbytes() if item is not _EOS else 0

    def __iter__(self) -> Iterator[Bucket]:
        while True:
            b = self.get()
            if b is None:
                return
            yield b

    def qsize(self) -> int:
        with self._lock:
            return len(self._dq)

    def stats(self) -> Dict[str, Any]:
        return {
            "bytes_in": self.bytes_in,
            "buckets_in": self.buckets_in,
            "records_in": self.records_in,
            "dropped_retention": self.dropped_retention,
            "put_wait_s": self.put_wait_s,
            "get_wait_s": self.get_wait_s,
        }


class QueueGroup:
    """Named bounded :class:`StreamQueue` s for one batched replay — the
    Kafka multi-topic analogue.

    A multi-queue replay (:class:`repro_torch.streamsim.producer.
    MultiQueueProducer`) interleaves S scenarios' buckets in one
    virtual-time loop; each scenario keeps its OWN bounded queue here, so
    per-scenario ordering, stats, and at-least-once semantics are exactly
    the single-queue ones. Backpressure is *shared*: the single producer
    loop blocks on whichever member queue is full, stalling every
    scenario's emission — the broker-cluster behaviour of one producer
    feeding S topics with bounded retention. Consumers must therefore
    drain their queues concurrently (one thread per scenario;
    ``Controller.run_many`` does this) — a sequential drain can deadlock
    against a full sibling queue.

    ``max_bytes`` adds a GLOBAL byte cap across the member queues (broker
    retention): ``retention_policy="block"`` turns the
    cap into shared byte backpressure, ``"drop_oldest"`` evicts the
    globally-oldest buffered bucket instead (counted in each queue's
    ``dropped_retention`` and in :meth:`budget_stats`).
    """

    def __init__(self, keys, maxsize: int = 64,
                 max_bytes: Optional[int] = None,
                 retention_policy: str = "block"):
        self.budget = (None if max_bytes is None
                       else ByteBudget(max_bytes, retention_policy))
        self.queues: Dict[Any, StreamQueue] = {
            k: StreamQueue(maxsize=maxsize, budget=self.budget)
            for k in keys}

    def __getitem__(self, key) -> StreamQueue:
        return self.queues[key]

    def __iter__(self):
        return iter(self.queues)

    def __len__(self) -> int:
        return len(self.queues)

    def items(self):
        return self.queues.items()

    def stats(self) -> Dict[Any, Dict[str, Any]]:
        """Per-scenario transport stats, keyed like the constructor."""
        return {k: q.stats() for k, q in self.queues.items()}

    def budget_stats(self) -> Optional[Dict[str, Any]]:
        """The shared byte budget's counters (None without ``max_bytes``)."""
        return None if self.budget is None else self.budget.stats()
