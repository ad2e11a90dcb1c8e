"""The stream path's tracer (``repro_torch.tracing``) on the CPU: off it
keeps nothing and changes no result; under ``torch.profiler`` every span
of the stream path appears at its boundary, in its call, inside its
parent and on the profiler's clock; the store counts the bytes it writes
and the queue the seconds each side waited."""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.streamsim import Controller
from repro_torch.streamsim.queue import (Bucket, QueueGroup, StreamQueue,
                                         counts_only)

SCALE = 0.01
DATASETS = ("traffic", "sogouq")
RANGES = (600, 1200)

#: the spans of a monolithic ``run_many`` and of a ``run``
SWEEP_SPANS = {"call", "prepare", "store.read", "nsa", "nsa.host_tables",
               "nsa.upload", "nsa.kernels", "fidelity", "materialize",
               "materialize.gather", "store.write", "replay",
               "replay.produce", "replay.consume", "report.stats",
               "report.build"}
RUN_SPANS = SWEEP_SPANS - {"fidelity", "replay.consume"}
CHUNK_SPANS = {"chunk.dispatch", "chunk.host_leg", "chunk.event_wait"}


class Recorder:
    """Keeps what each queue delivered: every bucket's stamp and count and
    a CRC of its records. Thread-safe (one thread a queue)."""

    def __init__(self):
        self.got = []
        self.lock = threading.Lock()

    def __call__(self, queue):
        stamps, counts, crc = [], [], 0
        for b in queue:
            stamps.append(b.scale_stamp)
            counts.append(len(b))
            crc = zlib.crc32(np.ascontiguousarray(b.t).tobytes(), crc)
            for k in sorted(b.payload):
                crc = zlib.crc32(np.ascontiguousarray(
                    b.payload[k]).tobytes(), crc)
        with self.lock:
            self.got.append((tuple(stamps), tuple(counts), crc))
        return {"records_seen": sum(counts)}


def _report(r) -> dict:
    """A report's results: every field but the host-clock timings."""
    d = r.to_json()
    for k in ("preprocess_s", "nsa_s", "produce_s"):
        d.pop(k)
    d["consumer_metrics"] = counts_only(d["consumer_metrics"])
    return d


def _sims(store_dir: Path) -> dict:
    """Every stored sim's columns."""
    out = {}
    for p in sorted(store_dir.glob("*__sim*/columns.npz")):
        with np.load(p) as z:
            out[p.parent.name] = {k: z[k] for k in z.files}
    return out


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _calls(store_dir: Path, during=contextlib.nullcontext):
    """``run_many`` over the grid, then ``run``, inside ``during()``, on a
    store that holds the originals; returns the reports, the stored sims,
    what the consumers got, and what ``during()`` gave."""
    ctl = Controller(str(store_dir), device="cpu")
    for d in DATASETS + ("userbehavior",):
        ctl.prepare(d, scale=SCALE, seed=3)
    rec = Recorder()
    with during() as ctx:
        reps = ctl.run_many(DATASETS, RANGES, rec, scale=SCALE, seed=3,
                            backend="torch")
        reps.append(ctl.run("userbehavior", 600, rec, scale=SCALE, seed=3,
                            backend="torch"))
    return ([_report(r) for r in reps], _sims(store_dir), sorted(rec.got),
            ctx)


@pytest.fixture(autouse=True)
def _clean_tracer():
    tracing.enable(False)
    tracing.drain()
    yield
    tracing.enable(False)
    tracing.drain()


def test_off_keeps_nothing_and_changes_no_result(tmp_path):
    assert tracing.span("nsa") is tracing.span("replay")
    assert not tracing.span("nsa") and tracing.context() is None
    off = _calls(tmp_path / "off")
    assert tracing.drain() == []
    on = _calls(tmp_path / "on", _profile)
    assert tracing.drain()
    assert off[0] == on[0]
    assert off[1].keys() == on[1].keys() and len(off[1]) == 5
    for key, cols in off[1].items():
        assert cols.keys() == on[1][key].keys()
        for c in cols:
            np.testing.assert_array_equal(cols[c], on[1][key][c])
    assert off[2] == on[2] and len(off[2]) == 5


def test_enable_is_the_switch_outside_a_profile(tmp_path):
    tracing.enable()
    Controller(str(tmp_path), device="cpu").run(
        "traffic", 600, Recorder(), scale=SCALE, backend="torch")
    # a fresh store: the original is made and written, not read
    assert {r.name for r in tracing.drain()} == RUN_SPANS - {"store.read"}
    tracing.enable(False)
    with tracing.span("nsa") as sp:
        assert not sp
    assert tracing.records() == []


def test_spans_from_many_threads_are_all_kept():
    tracing.enable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with tracing.call(worker=i):
                for _ in range(100):
                    with tracing.span("inner"):
                        pass

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(switch)
    recs = tracing.drain()
    assert len(recs) == 16 * 101
    assert len({r.id for r in recs}) == len(recs)
    calls = {r.id: r for r in recs if r.name == "call"}
    assert len({r.call for r in calls.values()}) == 16
    for r in recs:
        if r.name == "inner":
            assert calls[r.parent].call == r.call
            assert calls[r.parent].thread == r.thread


def _check_tree(recs, want, main):
    """Every span of ``want`` is there; the spans of each call share its
    id, nest inside their parents, and lead up to its root ``call``; the
    replay's threads are others than the caller's."""
    assert {r.name for r in recs} == want
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.name == "call"]
    assert all(r.parent == 0 and r.thread == main for r in roots)
    for r in recs:
        if r.name == "call":
            continue
        parent = by_id[r.parent]
        assert r.call == parent.call
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        top = parent
        while top.name != "call":
            top = by_id[top.parent]
        assert top.call == r.call
        on_thread = r.name in ("replay.produce", "replay.consume")
        assert (r.thread != main) == on_thread, r.name
        if on_thread:
            assert parent.name == "replay"


def test_spans_under_the_profiler(tmp_path):
    main = threading.get_ident()
    prof = _calls(tmp_path, _profile)[-1]
    recs = tracing.drain()
    calls = sorted({r.call for r in recs})
    assert len(calls) == 2
    sweep = [r for r in recs if r.call == calls[0]]
    run = [r for r in recs if r.call == calls[1]]
    _check_tree(sweep, SWEEP_SPANS, main)
    _check_tree(run, RUN_SPANS, main)
    root = next(r for r in sweep if r.name == "call")
    assert root.counts == {"entry": "run_many", "scenarios": 4}
    assert sum(r.name == "replay.consume" for r in sweep) == 4
    nsa = next(r for r in sweep if r.name == "nsa")
    assert nsa.counts["kept"] < nsa.counts["records_in"]
    tables = next(r for r in sweep if r.name == "nsa.host_tables")
    assert tables.counts["rows"] == 4 and tables.counts["width"] % 512 == 0
    gather = next(r for r in sweep if r.name == "materialize.gather")
    assert gather.counts["records"] == nsa.counts["kept"]
    replay = next(r for r in sweep if r.name == "replay")
    produce = next(r for r in sweep if r.name == "replay.produce")
    assert replay.counts["buckets"] == produce.counts["buckets"] > 0

    # the clock: each span of the profiler's thread inside the profile's
    # range of the same name, in order, to within 1 ms on either side. The
    # range opens before the span reads its start and closes after it reads
    # its end, so the thread's waits between the two (a busy machine, the
    # interpreter handing the replay's threads its lock for up to its 5 ms
    # switch interval) only widen the range. A clock of the tracer's own,
    # off the profiler's by 1 ms or more either way, puts outside it every
    # span whose range no wait widened, and those are most: the median
    # slack stays under 1 ms
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in SWEEP_SPANS:
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    mine = {}
    for r in recs:
        if r.thread == main:
            mine.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    assert set(ranges) == set(mine)
    slack = []
    for name, spans in mine.items():
        assert len(spans) == len(ranges[name])
        for (a, b), (c, d) in zip(sorted(spans), sorted(ranges[name])):
            assert c - 1_000_000 < a <= b < d + 1_000_000, name
            slack += [a - c, d - b]
    assert sorted(slack)[len(slack) // 2] < 1_000_000


def test_chunked_run_many_spans(tmp_path):
    main = threading.get_ident()
    ctl = Controller(str(tmp_path), device="cpu")
    with _profile():
        ctl.run_many(DATASETS, RANGES, Recorder(), scale=SCALE, seed=3,
                     backend="torch", chunk_s=400)
    recs = tracing.drain()
    names = {r.name for r in recs}
    assert CHUNK_SPANS <= names
    by_id = {r.id: r for r in recs}
    n_chunks = 3          # ceil(1200 / 400)
    for name in CHUNK_SPANS - {"chunk.event_wait"}:
        got = sorted(r.counts["chunk"] for r in recs if r.name == name)
        assert got == list(range(n_chunks)), name
    for r in recs:
        if r.name == "chunk.event_wait":
            assert by_id[r.parent].name == "chunk.host_leg"
        if r.name in ("chunk.dispatch", "chunk.host_leg"):
            assert r.thread == main and by_id[r.parent].name == "replay"
        if r.name == "store.write":
            assert by_id[r.parent].name in ("chunk.host_leg", "prepare")


def test_store_write_counts_the_bytes_of_the_files(tmp_path):
    _calls(tmp_path, lambda: contextlib.nullcontext(tracing.enable()))
    written = sum(r.counts["bytes"] for r in tracing.drain()
                  if r.name == "store.write")
    files = sum(p.stat().st_size
                for p in tmp_path.glob("*__sim*/columns.npz"))
    assert written == files > 0


def test_store_read_counts_the_bytes_read(tmp_path):
    ctl = Controller(str(tmp_path), device="cpu")
    ctl.run("traffic", 600, Recorder(), scale=SCALE, backend="torch")
    tracing.enable()
    ctl.store.get("traffic__sim600")
    (r,) = tracing.drain()
    assert r.name == "store.read" and r.counts["bytes"] == (
        tmp_path / "traffic__sim600" / "columns.npz").stat().st_size


def test_put_wait_when_a_slow_consumer_drains_a_queue_of_two(tmp_path):
    def slow(queue):
        n = 0
        for b in queue:
            if n < 20:
                time.sleep(0.002)
            n += len(b)
        return {"records_seen": n}

    rep = Controller(str(tmp_path), device="cpu").run(
        "traffic", 600, slow, scale=SCALE, queue_size=2, backend="torch")
    m = rep.consumer_metrics
    assert 0 < m["put_wait_s"] <= rep.produce_s
    assert m["get_wait_s"] >= 0


def _bucket(n: int) -> Bucket:
    return Bucket(0, np.zeros(n), {}, 0.0)


def test_get_waits_for_a_slow_producer():
    q = StreamQueue(maxsize=4)

    def late():
        time.sleep(0.05)
        q.put(_bucket(1))
        q.close()

    th = threading.Thread(target=late)
    th.start()
    assert len(q.get()) == 1
    th.join()
    s = q.stats()
    assert s["get_wait_s"] >= 0.03 and s["put_wait_s"] == 0.0


def test_byte_budget_wait_adds_to_put_wait():
    group = QueueGroup(["a", "b"], maxsize=8, max_bytes=100)
    group["a"].put(_bucket(10))            # 80 bytes of the budget's 100

    def drain():
        time.sleep(0.05)
        group["a"].get()

    th = threading.Thread(target=drain)
    th.start()
    group["b"].put(_bucket(5))             # 40 more: waits for the drain
    th.join()
    assert group["b"].stats()["put_wait_s"] >= 0.03
    assert group["a"].stats()["put_wait_s"] == 0.0
