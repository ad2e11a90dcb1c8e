"""The chunked pipeline's own counts on the CPU: the multi-day original's
span ``prepare.multiday`` (its days, its records, whether the store had
it), and the chunk feed's waits on each side (``feed_put_wait_s``: the
runner blocked on a full feed; ``feed_get_wait_s``: the replay waiting for
the next chunk), which every chunked report carries and no monolithic one
does."""

from __future__ import annotations

import threading

import numpy as np
import pytest

from repro_torch import tracing
from repro_torch.streamsim import ChunkFeed, Controller, Stream
from repro_torch.streamsim.plan import DAY_S

SCALE, SEED = 0.002, 5
FEED_WAITS = {"feed_put_wait_s", "feed_get_wait_s"}


def _drain(queue):
    return {"records_seen": sum(len(b) for b in queue)}


@pytest.fixture(autouse=True)
def _clean_tracer():
    tracing.enable(False)
    tracing.drain()
    yield
    tracing.enable(False)
    tracing.drain()


def test_prepare_multiday_span_counts_days_records_and_the_cache(tmp_path):
    ctl = Controller(str(tmp_path), device="cpu")
    kw = dict(scale=SCALE, seed=SEED, backend="torch", chunk_s=10,
              duration_s=2 * DAY_S)
    tracing.enable()
    for cached in (0, 1):
        ctl.run_many(["traffic"], [30], _drain, **kw)
        recs = tracing.drain()
        by_id = {r.id: r for r in recs}
        (span,) = [r for r in recs if r.name == "prepare.multiday"]
        original = ctl.store.get(f"traffic__orig__d{2 * DAY_S}")
        assert span.counts == {"days": 2, "records": len(original),
                               "cached": cached}
        assert len(original) > 0
        assert by_id[span.parent].name == "prepare"
        # the store writes the original it built inside the span, and
        # reads it back inside it once it has it
        inside = {r.name for r in recs if r.parent == span.id}
        assert inside == ({"store.read"} if cached else {"store.write"})


class _Flagged(threading.Condition):
    """A condition that says when a thread has begun to wait on it."""

    def __init__(self):
        super().__init__()
        self.waiting = threading.Event()

    def wait(self, timeout=None):
        self.waiting.set()
        return super().wait(timeout)


def _chunk(n=4):
    t = np.arange(float(n))
    return Stream(name="c", t=t, payload={"x": t.copy()},
                  scale_stamp=np.arange(n, dtype=np.int64))


def _feed():
    feed = ChunkFeed(maxsize=1)
    feed._cond = _Flagged()
    return feed


def test_runner_held_on_a_full_feed_counts_its_put_wait():
    feed = _feed()
    feed.put(_chunk())                       # full
    runner = threading.Thread(target=feed.put, args=(_chunk(),))
    runner.start()
    # the replay takes a chunk only once the runner waits on the full feed
    assert feed._cond.waiting.wait(30)
    assert feed.get() is not None
    runner.join(30)
    assert not runner.is_alive()
    stats = feed.stats()
    assert stats["feed_put_wait_s"] > 0
    assert stats["feed_get_wait_s"] == 0
    assert stats["feed_chunks"] == 2 and stats["feed_hwm_chunks"] == 1


def test_replay_held_on_an_empty_feed_counts_its_get_wait():
    feed = _feed()
    got = []
    replay = threading.Thread(target=lambda: got.append(feed.get()))
    replay.start()
    # the runner hands a chunk over only once the replay waits for it
    assert feed._cond.waiting.wait(30)
    feed.put(_chunk())
    replay.join(30)
    assert not replay.is_alive() and got[0] is not None
    stats = feed.stats()
    assert stats["feed_get_wait_s"] > 0
    assert stats["feed_put_wait_s"] == 0


def test_a_feed_that_never_waits_counts_nothing():
    feed = ChunkFeed(maxsize=2)
    feed.put(_chunk())
    feed.close()
    assert feed.get() is not None and feed.get() is None
    stats = feed.stats()
    assert stats["feed_put_wait_s"] == stats["feed_get_wait_s"] == 0.0


@pytest.mark.parametrize("chunk_s", [0, 10])
def test_every_chunked_report_carries_the_feed_waits(tmp_path, chunk_s):
    ctl = Controller(str(tmp_path), device="cpu")
    reps = ctl.run_many(["traffic", "sogouq"], [20, 40], _drain,
                        scale=SCALE, seed=SEED, backend="torch",
                        chunk_s=chunk_s)
    if not chunk_s:
        reps.append(ctl.run("traffic", 30, _drain, scale=SCALE, seed=SEED,
                            backend="torch"))
    for r in reps:
        m = r.consumer_metrics
        if chunk_s:
            assert FEED_WAITS <= set(m)
            assert all(isinstance(m[k], float) and m[k] >= 0
                       for k in FEED_WAITS)
        else:
            assert not FEED_WAITS & set(m)
