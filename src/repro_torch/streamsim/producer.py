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

:class:`MultiQueueProducer` is the batched-replay form: S scenarios'
non-empty buckets interleave in ONE loop over a merged scale-stamp
timeline, each scenario feeding its own bounded queue
(:class:`repro_torch.streamsim.queue.QueueGroup`), while every scenario's
consumer observes exactly the sequence of a sequential
:meth:`Producer.run`. Under a :class:`RealClock` the same loop fires every
scenario's bucket at its due second. Fed :class:`ChunkFeed` s instead of
whole streams, it replays the chunked engine's output round by round, in
bounded host memory.

Fault injection (chaos layer)
-----------------------------
Both producers accept a seeded fault schedule
(:mod:`repro_torch.streamsim.faults`): ``Producer(faults=<FaultInjector>)``
and ``MultiQueueProducer(fault_plan=<FaultPlan>)``. Scheduled drops,
duplicates, bounded reorders, delay jitter, and producer stalls are
applied at the emission point; every event is counted and surfaced in
``stats()`` (``fault_*`` keys, present only when a schedule is attached),
so per-scenario delivery reconciles as ``delivered == emitted - dropped +
duplicated``. A no-op schedule leaves the replay **bit-identical** to the
fault-free pipeline. The multi-queue walk tolerates a member queue being
closed under them (the engine's consumer-deadline watchdog does that to
shed a wedged scenario): the dead scenario's remaining buckets count as
``aborted_buckets`` and every other scenario replays to completion.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np

from repro_torch.streamsim.faults import FaultInjector, FaultPlan
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


class ChunkFeed:
    """Bounded hand-off of time-chunk :class:`Stream` s from the chunked
    engine (:class:`~repro_torch.streamsim.engine.ChunkedSweepRunner`) to the
    replay walk — the piece that makes multi-day replay run in bounded
    host memory.

    One feed per scenario. The engine ``put()`` s chunk ``k`` as soon as
    its host gather lands; the producer ``get()`` s chunks in order and
    replays them. Both sides block on a :class:`threading.Condition` —
    a full feed stalls the engine (backpressure), an empty feed stalls
    the producer (**no busy-wait**: the producer thread sleeps in
    ``Condition.wait`` until the engine's next ``put`` or ``close``).
    ``close()`` marks the end of the scenario's timeline; ``get`` then
    drains the remaining chunks and returns ``None``.

    ``stats()`` exposes the bounded-residency proof:
    ``feed_hwm_chunks`` is the high-watermark of chunks simultaneously
    resident in the feed (≤ ``maxsize`` by construction — the acceptance
    bound "peak host buckets ≤ 2 chunks per scenario"), and
    ``feed_chunks`` the total handed through. ``feed_put_wait_s`` and
    ``feed_get_wait_s`` are the seconds the engine waited on a full feed
    and the producer on an empty one: which side sets the pace. The clock
    is read only on a wait.
    """

    def __init__(self, maxsize: int = 2):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self._items: list = []
        self._cond = threading.Condition()
        self._closed = False
        self.hwm = 0
        self.total = 0
        self.put_wait_s = 0.0
        self.get_wait_s = 0.0

    @property
    def closed(self) -> bool:
        return self._closed

    def put(self, stream: Stream, timeout: Optional[float] = None) -> None:
        with self._cond:
            if len(self._items) >= self.maxsize and not self._closed:
                t0 = time.perf_counter()
                try:
                    while len(self._items) >= self.maxsize and \
                            not self._closed:
                        if not self._cond.wait(timeout=timeout):
                            raise TimeoutError("ChunkFeed.put timed out")
                finally:
                    self.put_wait_s += time.perf_counter() - t0
            if self._closed:
                raise RuntimeError("feed closed")
            self._items.append(stream)
            self.total += 1
            self.hwm = max(self.hwm, len(self._items))
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None) -> Optional[Stream]:
        """Next chunk in timeline order; blocks (no busy-wait) while the
        feed is empty and open; ``None`` once closed and drained."""
        with self._cond:
            if not self._items and not self._closed:
                t0 = time.perf_counter()
                try:
                    while not self._items and not self._closed:
                        if not self._cond.wait(timeout=timeout):
                            raise TimeoutError("ChunkFeed.get timed out")
                finally:
                    self.get_wait_s += time.perf_counter() - t0
            if self._items:
                item = self._items.pop(0)
                self._cond.notify_all()
                return item
            return None

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def stats(self) -> Dict[str, float]:
        return {"feed_hwm_chunks": self.hwm, "feed_chunks": self.total,
                "feed_put_wait_s": self.put_wait_s,
                "feed_get_wait_s": self.get_wait_s}


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


class MultiQueueProducer:
    """Replays S simulated streams through S bounded queues in ONE loop.

    The batched counterpart of :class:`Producer`: every scenario's
    non-empty buckets are merged into a single ascending scale-stamp
    timeline, and one loop walks it. Per simulated second, every scenario
    with a bucket there emits it (in the scenarios' given order) to its
    own queue.

    Under a :class:`VirtualClock` (tests, CPU benchmarks,
    ``Controller.run_many``) each empty-second gap costs one ``sleep`` for
    the WHOLE sweep. Under any other clock (:class:`RealClock` — live demos
    driving several SPS consumers at once) each merged event is emitted at
    its due wall time, so S scenarios replay off ONE wall-clock loop
    instead of S timer threads.

    Equivalence contract (tested): for each scenario the consumer observes
    exactly what a sequential ``Producer(stream, queue).run()`` produces —
    same bucket sequence, same queue stats, same producer stats, and each
    scenario's queue closes right after its last bucket. Under the
    virtual clock the per-bucket ``emit_time`` stamps are also identical
    (bucket ``b`` emits at clock ``(b + 1) * tick_s``); under a real
    clock ``emit_time`` is the wall time the wheel fired (the sequential
    real-clock producer's semantics). Only the shared loop's *final*
    clock value differs per scenario (it runs to the sweep's last stamp).

    Backpressure is shared: one full queue stalls the loop (and therefore
    every scenario) until its consumer drains — so consumers must run
    concurrently, one per queue.

    ``fault_plan`` attaches a seeded per-scenario fault schedule
    (:class:`repro_torch.streamsim.faults.FaultPlan`); each scenario draws from
    its OWN deterministic RNG stream, so its schedule is identical to the
    one a sequential fault-injected :class:`Producer` replay would apply,
    regardless of how scenarios interleave. A member queue closed under
    the walk (the engine's consumer-deadline watchdog shedding a wedged
    scenario) only kills THAT scenario — its remaining buckets count as
    ``aborted_buckets`` and the walk continues; producer stalls, however,
    stall the whole merged walk (one transport, one loop — the
    broker-stall semantics).

    Values are whole :class:`Stream` s, or all :class:`ChunkFeed` s of
    time-chunk streams (the chunked replay); a mix raises ``ValueError``.
    :meth:`run` walks both alike.
    """

    def __init__(self, streams: Mapping, queues: Mapping,
                 clock: Optional[object] = None, tick_s: float = 1.0,
                 on_emit: Optional[Callable[[object, Bucket], None]] = None,
                 fault_plan: Optional[FaultPlan] = None):
        if set(streams) != set(queues):
            raise ValueError("streams and queues must share the same keys")
        self.streams = dict(streams)
        # chunked mode: values are ChunkFeed s of time-chunk streams
        # instead of whole Stream s — all-or-nothing
        n_feeds = sum(isinstance(v, ChunkFeed) for v in self.streams.values())
        if n_feeds and n_feeds != len(self.streams):
            raise ValueError("mix of ChunkFeed and Stream values — chunked "
                             "replay is all-or-nothing per sweep")
        self.chunked = bool(n_feeds)
        self.queues = {k: queues[k] for k in self.streams}
        self.clock = clock if clock is not None else VirtualClock()
        self.tick_s = tick_s
        self.on_emit = on_emit
        self.fault_plan = fault_plan
        self.emitted_buckets: Dict[object, int] = {k: 0 for k in self.streams}
        self.emitted_records: Dict[object, int] = {k: 0 for k in self.streams}
        self.aborted_buckets: Dict[object, int] = {k: 0 for k in self.streams}

    def _injectors(self, keys):
        """Per-scenario injectors (None where the schedule is a no-op —
        the hot loop keeps its fault-free fast path for those rows)."""
        if self.fault_plan is None:
            return [None] * len(keys)
        return [None if self.fault_plan.is_noop_for(k)
                else self.fault_plan.injector(k) for k in keys]

    def _emit_one(self, i, b, t, payload, queue, inj, n_buckets,
                  n_records, key) -> bool:
        """Apply one scenario's next bucket through its fault schedule (the
        sequential :meth:`Producer._emit` chaos discipline); returns False
        when the scenario's queue was closed under us (scenario dead)."""
        clock = self.clock
        try:
            action = inj.draw()
            if action.stall_s > 0.0:
                clock.sleep(action.stall_s)
            if action.delay_s > 0.0:
                clock.sleep(action.delay_s)
            bucket = Bucket(scale_stamp=b, t=t, payload=payload,
                            emit_time=clock.time())
            n_buckets[i] += 1                  # emissions count ATTEMPTS
            n_records[i] += len(bucket)
            # earlier holds advance on EVERY emission (held ones included)
            released = inj.release_due()
            if action.hold:
                inj.hold(bucket, action.hold)
            elif not action.drop:
                queue.put(bucket)
                if action.duplicate:
                    queue.put(_dup_bucket(bucket))
                if self.on_emit is not None:
                    self.on_emit(key, bucket)
            for rb in released:
                queue.put(rb)
            return True
        except RuntimeError:
            if not queue.closed:
                raise
            return False                    # shed scenario, walk continues

    def _close_scenario(self, i, queues, injectors) -> None:
        """Flush the scenario's held (reordered) buckets, then close."""
        inj = injectors[i]
        if inj is not None and not queues[i].closed:
            try:
                for rb in inj.flush():
                    queues[i].put(rb)
            except RuntimeError:
                if not queues[i].closed:
                    raise
        queues[i].close()

    def run(self) -> int:
        """Walk the merged timeline once; returns the paper status code.

        The walk proceeds in *rounds*, one chunk per live scenario a round:
        a whole :class:`Stream` is a source of one chunk, and a
        :class:`ChunkFeed` yields chunks until it is closed (the engine
        pushes every scenario's chunk ``k`` before any chunk ``k+1``, so the
        sweep stays on one aligned chunk grid). A round's non-empty buckets
        are merged by one ``np.lexsort`` into ascending stamp, then scenario
        order, and the clock's gap state carries across rounds, so a
        scenario's consumer observes the same bucket sequence (and, under a
        :class:`VirtualClock`, the same ``emit_time`` stamps) whether its
        stream came whole or in chunks. Replay of chunk 0 starts as soon as
        it lands: nothing waits for the full timeline.

        Under a :class:`VirtualClock` each empty-second gap costs one
        ``sleep`` for the WHOLE sweep. Under any other clock each bucket
        fires at its absolute due time ``t0 + (b + 1) * tick_s`` (the
        sequential :class:`Producer`'s schedule), so S live consumers ride
        one wall-clock loop; a stalled feed can only make buckets late,
        never reordered. Host work is O(total #non-empty buckets), and
        fault-free scenarios emit inline, as cheaply per event as the
        sequential :class:`Producer` hot path.

        A feed with no chunk ready blocks the walk in ``ChunkFeed.get`` on
        a condition variable until the engine's ``put``/``close`` (no
        busy-wait), and fault injectors persist across rounds (one draw per
        emission attempt), so ``delivered == emitted - dropped +
        duplicated`` holds per scenario however the engine paces chunks.
        A whole stream's queue closes right after its last bucket (an empty
        one at once); a feed's once the feed is closed and drained. A
        scenario whose queue is closed under the walk goes dead, but its
        source keeps draining (counting ``aborted_buckets``), so the engine
        never blocks on a full feed of a shed scenario.
        """
        try:
            keys = list(self.streams)
            sources = [self.streams[k] for k in keys]
            queues = [self.queues[k] for k in keys]
            injectors = self._injectors(keys)
            on_emit = self.on_emit
            clock, tick_s = self.clock, self.tick_s
            virtual = isinstance(clock, VirtualClock)
            whole = not self.chunked
            n = len(keys)
            n_buckets = [0] * n
            n_records = [0] * n
            dead = [False] * n
            live = [True] * n
            last = [-1] * n                # a whole stream's last bucket
            slices, t_cols, payloads = [None] * n, [None] * n, [None] * n
            prev = -1                      # gap state carried across rounds
            t0 = clock.time()              # wall-clock schedule origin
            while any(live):
                # ---- fetch this round's chunks (a feed blocks, no busy-wait)
                events_b, events_s = [], []
                for i in range(n):
                    if not live[i]:
                        continue
                    chunk = sources[i] if whole else sources[i].get()
                    live[i] = not whole and chunk is not None
                    sl = {} if chunk is None else \
                        _group_by_scale_stamp(chunk)[0]
                    if not sl:
                        if not live[i]:    # timeline over: nothing to emit
                            self._close_scenario(i, queues, injectors)
                        continue
                    bs = np.fromiter(sl, np.int64, len(sl))
                    if whole:
                        last[i] = int(bs[-1])
                    slices[i], t_cols[i] = sl, chunk.t
                    payloads[i] = list(chunk.payload.items())
                    events_b.append(bs)
                    events_s.append(np.full(len(bs), i, np.int64))
                if not events_b:
                    continue
                bs = np.concatenate(events_b)
                si = np.concatenate(events_s)
                # ascending simulated second; scenario order within a second
                order = np.lexsort((si, bs))
                # .tolist() up front: the loop then touches only native
                # ints (per-event numpy scalar unboxing would dominate)
                for b, i in zip(bs[order].tolist(), si[order].tolist()):
                    if virtual:
                        if b != prev:
                            clock.sleep((b - prev) * tick_s)
                            prev = b
                    else:
                        delay = t0 + (b + 1) * tick_s - clock.time()
                        if delay > 0:
                            clock.sleep(delay)
                    if dead[i]:
                        self.aborted_buckets[keys[i]] += 1
                        continue
                    sl = slices[i][b]
                    inj = injectors[i]
                    if inj is None:
                        # fault-free fast path
                        bucket = Bucket(
                            scale_stamp=b,
                            t=t_cols[i][sl],
                            payload={k: v[sl] for k, v in payloads[i]},
                            emit_time=clock.time(),
                        )
                        try:
                            queues[i].put(bucket)
                        except RuntimeError:
                            if not queues[i].closed:
                                raise
                            dead[i] = True
                            self.aborted_buckets[keys[i]] += 1
                            continue
                        n_buckets[i] += 1
                        n_records[i] += len(bucket)
                        if on_emit is not None:
                            on_emit(keys[i], bucket)
                    elif not self._emit_one(
                            i, b, t_cols[i][sl],
                            {k: v[sl] for k, v in payloads[i]}, queues[i],
                            inj, n_buckets, n_records, keys[i]):
                        dead[i] = True
                        self.aborted_buckets[keys[i]] += 1
                        continue
                    if b == last[i]:
                        # scenario done: close so its consumer can finish
                        # without waiting for the rest of the sweep
                        self._close_scenario(i, queues, injectors)
            for i, key in enumerate(keys):
                self.emitted_buckets[key] = n_buckets[i]
                self.emitted_records[key] = n_records[i]
            return STATUS_SUCCESS
        except Exception:
            for q in self.queues.values():
                q.close()
            if self.chunked:
                for f in self.streams.values():
                    f.close()   # unblock the engine side: no orphaned put()
            return STATUS_FAULT

    def stats(self, key=None) -> Dict:
        """Per-scenario producer stats (matching :meth:`Producer.stats`),
        or the whole mapping when ``key`` is omitted. Chunked replays add
        the feed's bounded-residency stats (``feed_hwm_chunks`` /
        ``feed_chunks``) and its waits (``feed_put_wait_s`` /
        ``feed_get_wait_s``)."""
        if key is not None:
            out = {"emitted_buckets": self.emitted_buckets[key],
                   "emitted_records": self.emitted_records[key],
                   "aborted_buckets": self.aborted_buckets[key]}
            if self.fault_plan is not None and \
                    not self.fault_plan.is_noop_for(key):
                out.update(self.fault_plan.injector(key).stats())
            if self.chunked:
                out.update(self.streams[key].stats())
            return out
        return {k: self.stats(k) for k in self.streams}
