"""Parity of the port's chunked, multi-day pipeline (``run_many(chunk_s=,
duration_s=, checkpoint=)``) and its carry kernels B6 and B7 with the JAX
package, on the CPU at small scale.

The port runs ``device="cpu"`` (the kernels' plain PyTorch versions); the
reference's Pallas kernels run in interpret mode. Contracts: counts, kept
indices, scale stamps, prefix sums and stored sims exact; Kahan moments
within 1e-5 relative; trend correlations and fidelity matrices within 1e-3
of the numpy backend (1e-4 of the JAX pallas run); every chunked report
proves bounded residency (``feed_hwm_chunks <= 2``).
"""

import dataclasses
import threading
import time

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.streamsim as J
import repro_torch.streamsim as T
from repro.kernels import ops as jops
from repro.kernels.metrics_fused import stream_metrics_carry_pallas
from repro.kernels.trend_scan import trend_scan_carry_pallas
from repro.streamsim.nsa import ChunkedNSA as JChunkedNSA
from repro_torch.kernels import ops as tops
from repro_torch.kernels.metrics_fused import (stream_metrics_carry,
                                               stream_metrics_carry_plain,
                                               stream_metrics_plain)
from repro_torch.kernels.stream_sample import stream_sample_plain
from repro_torch.kernels.trend_scan import (trend_scan_carry,
                                            trend_scan_carry_plain,
                                            trend_scan_plain)
from repro_torch.streamsim import engine as tengine
from repro_torch.streamsim.nsa import nsa_sweep_device
from repro_torch.streamsim.plan import DAY_S
from repro_torch.streamsim.queue import counts_only

CPU = "cpu"
DATASETS, RANGES = ["sogouq", "traffic"], [20, 45]   # 45 % 7: ragged chunk
SCALE, SEED = 0.002, 9
CHAOS = dict(drop_rate=0.2, duplicate_rate=0.15, reorder_rate=0.25,
             reorder_window=3, delay_jitter_s=0.01)


def _consumer(queue):
    return {"records_seen": sum(len(b) for b in queue)}


def _mini(name="traffic", scale=SCALE, seed=SEED):
    return T.preprocess(T.make_stream(name, scale=scale, seed=seed))


def _same_stored(a_store, b_store, key):
    a, b = a_store.get(key), b_store.get(key)
    assert (a.scale_stamp is None) == (b.scale_stamp is None)
    cols_a = {"t": a.t, **a.payload}
    cols_b = {"t": b.t, **b.payload}
    if a.scale_stamp is not None:
        cols_a["ss"], cols_b["ss"] = a.scale_stamp, b.scale_stamp
    assert list(cols_a) == list(cols_b)
    for k in cols_a:
        assert cols_a[k].dtype == cols_b[k].dtype, k
        assert cols_a[k].tobytes() == cols_b[k].tobytes(), k


def _sorted_rows(rng, S, n, width):
    return np.sort(rng.integers(0, width, (S, n)), axis=1).astype(np.int32)


# ------------------------------------------------------------------ B6
class TestStreamMetricsCarryKernel:
    @pytest.mark.parametrize("cw,base,lengths,carry", [
        (600, 1200, [5000, 3100, 0], "random"),   # buckets pad to 1024
        (512, 0, [4096, 1], "zero"),
        (1300, 7, [2048, 2047, 4000], "random"),
    ])
    def test_plain_matches_pallas(self, cw, base, lengths, carry):
        rng = np.random.default_rng(cw)
        S, N = len(lengths), 8192
        buckets = tops._padded_buckets(cw)
        local = _sorted_rows(rng, S, N, cw)
        mcar = (rng.normal(0.0, 1e4, (S, 4)) if carry == "random"
                else np.zeros((S, 4))).astype(np.float32)
        mcar[:, 1::2] *= 1e-4                      # small compensations
        j_in = local.copy()
        absolute = local + base
        for s, n in enumerate(lengths):
            j_in[s, n:] = buckets                  # the reference's padding
            absolute[s, n:] = rng.integers(-9, 10 ** 6, N - n)   # garbage
        h_j, m_j = stream_metrics_carry_pallas(
            jnp.asarray(j_in), jnp.asarray(mcar), buckets, interpret=True)
        h_t, m_t = stream_metrics_carry_plain(
            torch.from_numpy(absolute), torch.tensor(lengths), buckets,
            torch.from_numpy(mcar), base)
        assert h_t.dtype == torch.int32 and m_t.shape == (S, 4)
        assert np.array_equal(h_t.numpy(), np.asarray(h_j))
        for c in (0, 2):                           # the running Σq, Σq²
            np.testing.assert_allclose(m_t[:, c].double().numpy(),
                                       np.asarray(m_j, np.float64)[:, c],
                                       rtol=1e-5, atol=1e-3)
        q = h_t.numpy().astype(np.float64)
        # Kahan: the state's compensation is taken off the next partial
        want = np.stack([q.sum(1), (q * q).sum(1)], 1) + mcar[:, ::2] - \
            mcar[:, 1::2]
        np.testing.assert_allclose(m_t[:, ::2].double().numpy(), want,
                                   rtol=1e-5, atol=1e-3)

    @pytest.mark.parametrize("carry", ["zero", "random"])
    def test_unsorted_stamps_around_the_chunk_match_pallas(self, carry):
        """Unsorted stamps, some below the chunk's base and some past
        base + buckets, ragged lengths with an empty row: the plain version
        (the CUDA kernel's yardstick) against the Pallas kernel in
        interpret mode, which sees the reference's padding id there."""
        rng = np.random.default_rng(17)
        S, N, base, buckets = 4, 3000, 1800, 1024
        ss = rng.integers(base - 300, base + buckets + 400, (S, N)).astype(
            np.int32)
        lengths = np.array([N, 5, 0, N - 1])
        mcar = (np.zeros((S, 4)) if carry == "zero" else np.stack(
            [rng.uniform(0, 5e5, S), rng.uniform(-1, 1, S),
             rng.uniform(0, 5e8, S), rng.uniform(-64, 64, S)], axis=1)
                ).astype(np.float32)
        local = ss - base
        valid = (np.arange(N)[None, :] < lengths[:, None]) & (local >= 0) & \
            (local < buckets)
        j_in = np.full((S, 3072), buckets, np.int32)
        j_in[:, :N] = np.where(valid, local, buckets)
        h_j, m_j = stream_metrics_carry_pallas(
            jnp.asarray(j_in), jnp.asarray(mcar), buckets, interpret=True)
        h_t, m_t = stream_metrics_carry_plain(
            torch.from_numpy(ss), torch.from_numpy(lengths.astype(np.int32)),
            buckets, torch.from_numpy(mcar), base)
        assert np.array_equal(h_t.numpy(), np.asarray(h_j))
        assert int(h_t.sum()) == int(valid.sum())
        np.testing.assert_allclose(m_t[:, ::2].double().numpy(),
                                   np.asarray(m_j, np.float64)[:, ::2],
                                   rtol=1e-5, atol=0)

    def test_zero_carry_is_b3_bit_for_bit(self):
        rng = np.random.default_rng(3)
        ss = torch.from_numpy(rng.integers(0, 1536, (3, 6000)).astype(
            np.int32))
        lengths = torch.tensor([6000, 700, 0], dtype=torch.int32)
        h3, m3 = stream_metrics_plain(ss, lengths, 1536)
        h6, m6 = stream_metrics_carry_plain(ss, lengths, 1536,
                                            torch.zeros(3, 4))
        assert torch.equal(h3, h6) and torch.equal(m3, m6[:, ::2])

    def test_rebase_ignores_stamps_outside_the_chunk(self):
        ss = torch.tensor([[99, 100, 100, 611, 612, 2000, -5]],
                          dtype=torch.int32)
        hist, mom = stream_metrics_carry_plain(ss, torch.tensor([7]), 512,
                                               torch.zeros(1, 4), base=100)
        assert hist[0, :1].tolist() == [2] and hist[0, 511] == 1
        assert int(hist.sum()) == 3 and mom[0, ::2].tolist() == [3.0, 5.0]

    def test_cpu_dispatch_counts_nothing_and_meta_is_refused(self):
        ss = torch.zeros((2, 8), dtype=torch.int32)
        before = stream_metrics_carry.launches
        stream_metrics_carry(ss, torch.tensor([8, 3], dtype=torch.int32), 512,
                             torch.zeros(2, 4))
        assert stream_metrics_carry.launches == before
        meta = torch.empty((1, 8), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            stream_metrics_carry(meta, torch.ones(1, dtype=torch.int32,
                                                  device="meta"), 512,
                                 torch.zeros((1, 4), device="meta"))


# ------------------------------------------------------------------ B7
class TestTrendScanCarryKernel:
    @pytest.mark.parametrize("S,n", [(1, 1024), (3, 2048), (5, 4096)])
    def test_plain_matches_pallas(self, S, n):
        rng = np.random.default_rng(S * n)
        q = rng.poisson(40.0, (S, n)).astype(np.int32)
        init = rng.integers(0, 10 ** 6, S).astype(np.int32)
        p_j, t_j = trend_scan_carry_pallas(jnp.asarray(q), jnp.asarray(init),
                                           interpret=True)
        p_t, t_t = trend_scan_carry_plain(torch.from_numpy(q),
                                          torch.from_numpy(init))
        assert np.array_equal(p_t.numpy(), np.asarray(p_j))
        assert np.array_equal(t_t.numpy(), np.asarray(t_j))

    def test_zero_init_is_b4_and_tail_is_the_total(self):
        q = torch.from_numpy(np.random.default_rng(1).poisson(
            9.0, (3, 1025)).astype(np.int32))
        psum, tail = trend_scan_carry_plain(q, torch.zeros(3,
                                                           dtype=torch.int32))
        assert torch.equal(psum, trend_scan_plain(q))
        assert torch.equal(tail, q.sum(1, dtype=torch.int32))

    def test_total_just_under_int32_limit_exact(self):
        q = torch.full((1, 4096), 3550, dtype=torch.int32)
        init = torch.tensor([2 ** 31 - 1 - 4096 * 3550 - 7],
                            dtype=torch.int32)
        psum, tail = trend_scan_carry_plain(q, init)
        want = int(init) + 3550 * np.arange(1, 4097, dtype=np.int64)
        assert np.array_equal(psum[0].numpy().astype(np.int64), want)
        assert int(tail) == 2 ** 31 - 8

    def test_empty_chunk_and_cpu_dispatch(self):
        init = torch.tensor([4, 5], dtype=torch.int32)
        before = trend_scan_carry.launches
        psum, tail = trend_scan_carry(torch.zeros((2, 0), dtype=torch.int32),
                                      init)
        assert psum.shape == (2, 0) and torch.equal(tail, init)
        assert trend_scan_carry.launches == before
        with pytest.raises(ValueError, match="cuda or cpu"):
            trend_scan_carry(torch.empty((1, 4), dtype=torch.int32,
                                         device="meta"), init[:1])


# ------------------------------------------------------------ chunk ops
def _chunk_inputs(stamps, lo, hi, rng):
    """One chunk's kept stamps per row, packed to a matrix with garbage
    past each row's count (as ``ChunkedNSA`` leaves it)."""
    rows = [r[(r >= lo) & (r < hi)] for r in stamps]
    width = max(max(len(r) for r in rows), 1) + 9
    mat = rng.integers(-3, 10 ** 5, (len(rows), width)).astype(np.int32)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = r
    return mat, np.array([len(r) for r in rows])


class TestChunkOps:
    @pytest.mark.parametrize("width,cs", [(60, 17), (1300, 600), (45, 45)])
    def test_metrics_chunks_match_jax_and_monolithic(self, width, cs):
        rng = np.random.default_rng(width + cs)
        stamps = _sorted_rows(rng, 3, 900, width)
        stamps[2, :] = width - 1                   # one row in its last bucket
        c = tops.chunk_carry_init(3, width, window=60, device=CPU)
        jc = jops.chunk_carry_init(3, width, window=60)
        for lo in range(0, width, cs):
            hi = min(lo + cs, width)
            mat, counts = _chunk_inputs(stamps, lo, hi, rng)
            c = tops.stream_metrics_chunk(c, torch.from_numpy(mat),
                                          torch.from_numpy(counts), lo, hi)
            jc = jops.stream_metrics_chunk(jc, jnp.asarray(mat),
                                           jnp.asarray(counts), lo, hi)
            for name in ("psum_tail", "trend_tail"):
                assert np.array_equal(getattr(c, name).numpy(),
                                      np.asarray(getattr(jc, name))), name
        h, mom = tops.chunk_carry_finalize(c)
        jh, jmom = jops.chunk_carry_finalize(jc)
        assert np.array_equal(h.numpy(), np.asarray(jh))
        np.testing.assert_allclose(mom.double().numpy(),
                                   np.asarray(jmom, np.float64), rtol=1e-5)
        h_m, m_m = tops.stream_metrics_batched_device(
            torch.from_numpy(stamps), [900] * 3, width)
        assert torch.equal(h, h_m)
        np.testing.assert_allclose(mom.double().numpy(),
                                   m_m.double().numpy(), rtol=1e-5)

    def test_fresh_carry_gives_identical_second_run(self):
        # the port writes each chunk into carry.hist in place: a second run
        # from a fresh carry must not see the first run's state
        rng = np.random.default_rng(8)
        stamps = _sorted_rows(rng, 2, 500, 40)
        runs = []
        for _ in range(2):
            c = tops.chunk_carry_init(2, 40, window=5, device=CPU)
            first = c.hist
            for lo in range(0, 40, 9):
                mat, counts = _chunk_inputs(stamps, lo, min(lo + 9, 40), rng)
                c = tops.stream_metrics_chunk(c, torch.from_numpy(mat),
                                              torch.from_numpy(counts), lo,
                                              min(lo + 9, 40))
            assert c.hist is first                 # the in-place update
            runs.append((c.hist.clone(), c.mom.clone(), c.psum_tail.clone(),
                         c.trend_tail.clone()))
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    def test_guards(self):
        c = tops.chunk_carry_init(1, 20, device=CPU)
        ss, n = torch.zeros((1, 4), dtype=torch.int32), torch.tensor([0])
        with pytest.raises(ValueError, match="out of order"):
            tops.stream_metrics_chunk(c, ss, n, 5, 10)
        with pytest.raises(ValueError, match="exceeds"):
            tops.stream_metrics_chunk(c, ss, n, 0, 21)
        with pytest.raises(ValueError, match="empty chunk"):
            tops.stream_metrics_chunk(c, ss, n, 0, 0)
        with pytest.raises(ValueError):
            tops.stream_metrics_chunk(c, torch.zeros(4), n, 0, 5)
        with pytest.raises(ValueError):
            tops.chunk_carry_init(0, 5, device=CPU)
        big = torch.empty((1, 2 ** 31), dtype=torch.int32, device="meta")
        with pytest.raises(tops.PallasDomainError):
            tops.stream_metrics_chunk(c, big, [1], 0, 5)
        with pytest.raises(ValueError, match="window"):
            tops.trend_scan_chunk(ss, 0)
        with pytest.raises(ValueError, match="tail"):
            tops.trend_scan_chunk(ss, 5, tail=torch.zeros((1, 3)))

    @pytest.mark.parametrize("n,w,cs", [
        (100, 7, 13),        # ragged last chunk
        (61, 60, 1),         # one-bucket chunks: the first emit m = 0
        (60, 60, 25),        # the window edge: series length == window
        (200, 1, 50),
        (90, 5, 200),        # one chunk longer than the series
    ])
    def test_trend_chunks_match_jax_and_monolithic(self, n, w, cs):
        q = np.random.default_rng(n * w).poisson(5.0, (3, n)).astype(
            np.int32)
        mono, _ = tops.trend_scan_batched_device(torch.from_numpy(q),
                                                 [n] * 3, w)
        segs, tail, tot, jtail, jtot = [], None, None, None, None
        sizes = []
        for lo in range(0, n, cs):
            hi = min(lo + cs, n)
            seg, start, tail, tot = tops.trend_scan_chunk(
                torch.from_numpy(q[:, lo:hi]), w, tail=tail, psum_carry=tot,
                lo=lo, is_last=hi == n)
            jseg, jstart, jtail, jtot = jops.trend_scan_chunk(
                jnp.asarray(q[:, lo:hi]), w, tail=jtail, psum_carry=jtot,
                lo=lo, is_last=hi == n)
            assert start == jstart == sum(sizes)
            assert np.array_equal(seg.numpy(), np.asarray(jseg))
            assert np.array_equal(tot.numpy(), np.asarray(jtot))
            segs.append(seg.numpy())
            sizes.append(seg.shape[1])
        if cs == 1 and w > 2:
            assert sizes[0] == 0
        assert np.array_equal(np.concatenate(segs, axis=1),
                              mono[:, :n].numpy())


# ------------------------------------------------------------ chunked NSA
class TestChunkedNSA:
    @pytest.mark.parametrize("cs", [20, 100])
    def test_chunks_match_jax_and_concatenate_to_the_sweep(self, cs):
        streams = {d: _mini(d) for d in DATASETS}
        pairs = [(d, r) for d in DATASETS for r in RANGES]
        cn = T.ChunkedNSA(streams, pairs, device=CPU)
        jcn = JChunkedNSA(
            {d: J.Stream(s.name, s.t, s.payload) for d, s in streams.items()},
            pairs)
        assert cn.width == jcn.width == max(RANGES)
        got_idx = [[] for _ in pairs]
        got_ss = [[] for _ in pairs]
        for lo in range(0, cn.width, cs):
            hi = min(lo + cs, cn.width)
            h, jh = cn.chunk(lo, hi), jcn.chunk(lo, hi)
            totals = h.totals.numpy()
            assert np.array_equal(totals, np.asarray(jh.totals))
            assert np.array_equal(totals, h.kept)  # the tables' prediction
            assert np.array_equal(h.rec_off, jh.rec_off)
            assert h.to_host() is h and h.wait() == 0.0   # CPU handles
            j_ss, j_idx = np.asarray(jh.ss_kept), np.asarray(jh.idx)
            for r, tot in enumerate(totals):
                assert np.array_equal(h.idx[r, :tot].numpy(), j_idx[r, :tot])
                assert np.array_equal(h.ss_kept[r, :tot].numpy(),
                                      j_ss[r, :tot])
                got_idx[r].append(h.idx[r, :tot].numpy() + h.rec_off[r])
                got_ss[r].append(h.ss_kept[r, :tot].numpy())
        ss_m, idx_m, tot_m, _ = nsa_sweep_device(
            streams, [(d, r) for d, r in pairs], device=CPU)
        for r, tot in enumerate(tot_m):
            assert np.array_equal(np.concatenate(got_idx[r]),
                                  idx_m[r, :tot].numpy())
            assert np.array_equal(np.concatenate(got_ss[r]),
                                  ss_m[r, :tot].numpy())

    @pytest.mark.parametrize("cs", [20, 100])
    def test_sample_inputs_slice_the_whole_launch(self, cs):
        """B1 on ``sample_inputs(lo, hi)`` gives, on each row's slice, the
        stamps and keep bits of one launch over the whole rows."""
        from repro_torch.kernels.stream_sample import stream_sample_plain

        streams = {d: _mini(d) for d in DATASETS}
        pairs = [(d, r) for d in DATASETS for r in RANGES]
        cn = T.ChunkedNSA(streams, pairs, device=CPU)
        ss_w, keep_w = stream_sample_plain(*cn._args)
        for lo in range(0, cn.width, cs):
            hi = min(lo + cs, cn.width)
            b1_in, a = cn.sample_inputs(lo, hi)
            assert np.array_equal(a, cn._starts_np[:, lo])
            assert b1_in.n % tops.TILE == 0
            ss, keep = stream_sample_plain(*b1_in)
            for r, (off, m) in enumerate(zip(a, b1_in.lengths.tolist())):
                assert np.array_equal(ss[r, :m], ss_w[r, off:off + m])
                assert np.array_equal(keep[r, :m], keep_w[r, off:off + m])
                assert not keep[r, m:].any()
            h = cn.chunk(lo, hi)
            assert np.array_equal(h.totals.numpy(),
                                  keep.sum(dim=1, dtype=torch.int32).numpy())

    def test_bad_ranges_and_empty_streams(self):
        s = _mini()
        cn = T.ChunkedNSA({"traffic": s}, [("traffic", 30)], device=CPU)
        for lo, hi in ((0, 0), (5, 31), (-1, 3)):
            with pytest.raises(ValueError):
                cn.chunk(lo, hi)
        empty = T.Stream("e", np.zeros(0), {})
        with pytest.raises(ValueError):
            T.ChunkedNSA({"e": empty}, [("e", 10)], device=CPU)


# ------------------------------------------------------------- chunk feed
class TestChunkFeed:
    def _chunk(self, n=4):
        t = np.arange(float(n))
        return T.Stream(name="c", t=t, payload={"x": t.copy()},
                        scale_stamp=np.arange(n, dtype=np.int64))

    def test_bounded_put_blocks_until_get(self):
        feed = T.ChunkFeed(maxsize=2)
        feed.put(self._chunk())
        feed.put(self._chunk())
        with pytest.raises(TimeoutError):
            feed.put(self._chunk(), timeout=0.05)
        th = threading.Thread(target=lambda: feed.put(self._chunk()),
                              daemon=True)
        th.start()
        assert feed.get() is not None
        th.join(timeout=5)
        assert not th.is_alive()                  # put unblocked by the get
        stats = feed.stats()
        assert counts_only(stats) == {"feed_hwm_chunks": 2, "feed_chunks": 3}
        # the puts that found the feed full waited; the get found a chunk
        assert stats["feed_put_wait_s"] > 0
        assert stats["feed_get_wait_s"] == 0.0

    def test_empty_get_blocks_then_drains_after_close(self):
        feed = T.ChunkFeed(maxsize=2)
        with pytest.raises(TimeoutError):
            feed.get(timeout=0.05)                # blocking wait, no spin
        feed.put(self._chunk())
        feed.close()
        assert feed.closed and feed.get() is not None
        assert feed.get() is None                 # end of the timeline
        with pytest.raises(RuntimeError):
            feed.put(self._chunk())

    def test_maxsize_validated(self):
        with pytest.raises(ValueError):
            T.ChunkFeed(maxsize=0)


# ---------------------------------------------------------- chunked walk
def _slice(sim, lo, hi):
    a, b = np.searchsorted(sim.scale_stamp, [lo, hi])
    return T.Stream(name=sim.name, t=sim.t[a:b],
                    payload={k: v[a:b] for k, v in sim.payload.items()},
                    scale_stamp=sim.scale_stamp[a:b])


#: the walk's clocks: the virtual one, and a real one of 1 ms ticks whose
#: emit times are wall times (so the logs leave them out)
CLOCKS = {"virtual": lambda: (T.VirtualClock(), 1.0),
          "real": lambda: (T.RealClock(), 0.001)}


def _walk(sources, chunked, cs=7, fault_plan=None, clock="virtual"):
    """Replay ``sources`` through one MultiQueueProducer, whole or fed in
    ``cs``-second chunks from another thread; returns each scenario's
    bucket log ``(stamp, emit_time, rows)`` (``emit_time`` None on the real
    clock) and the producer stats."""
    if chunked:
        feeds = {k: T.ChunkFeed(maxsize=2) for k in sources}
        streams = feeds
    else:
        streams = sources
    group = T.QueueGroup(streams, maxsize=4)
    clk, tick_s = CLOCKS[clock]()
    virtual = clock == "virtual"
    producer = T.MultiQueueProducer(streams, group.queues, clock=clk,
                                    tick_s=tick_s, fault_plan=fault_plan)
    logs = {k: [] for k in sources}

    def drain(k):
        for b in group[k]:
            logs[k].append((b.scale_stamp, b.emit_time if virtual else None,
                            len(b)))

    threads = [threading.Thread(target=drain, args=(k,), daemon=True)
               for k in sources]
    threads.append(threading.Thread(target=producer.run, daemon=True))
    for th in threads:
        th.start()
    if chunked:
        span = max(int(s.scale_stamp[-1]) + 1 for s in sources.values())
        for lo in range(0, span, cs):
            for k, s in sources.items():
                feeds[k].put(_slice(s, lo, lo + cs))
        for f in feeds.values():
            f.close()
    for th in threads:
        th.join(timeout=30)
    return logs, producer.stats()


class TestChunkedWalk:
    @pytest.mark.parametrize("clock", sorted(CLOCKS))
    def test_chunked_walk_equals_whole_stream_walk(self, clock):
        s = _mini()
        sources = {("traffic", 20): T.nsa(s, 20),
                   ("traffic", 45): T.nsa(s, 45)}
        whole, st_w = _walk(sources, chunked=False, clock=clock)
        fed, st_c = _walk(sources, chunked=True, clock=clock)
        assert fed == whole and all(len(v) for v in whole.values())
        for k in sources:
            # the feed's waits depend on the threads' timing
            fstats = counts_only(st_c[k])
            assert fstats.pop("feed_hwm_chunks") <= 2
            assert fstats.pop("feed_chunks") == -(-45 // 7)
            assert fstats == st_w[k]

    @pytest.mark.parametrize("clock", sorted(CLOCKS))
    def test_faults_walk_the_chunks_as_the_whole_stream(self, clock):
        s = _mini()
        sources = {("traffic", 40): T.nsa(s, 40)}
        def plan():                    # injectors are memoized per plan
            return T.FaultPlan(5, default=T.FaultSpec(**CHAOS))

        whole, st_w = _walk(sources, chunked=False, fault_plan=plan(),
                            clock=clock)
        fed, st_c = _walk(sources, chunked=True, fault_plan=plan(),
                          clock=clock)
        k = ("traffic", 40)
        assert fed == whole
        for name in ("fault_dropped", "fault_duplicated", "emitted_buckets"):
            assert st_c[k][name] == st_w[k][name]

    def test_mixed_values_raise(self):
        s = T.nsa(_mini(), 20)
        with pytest.raises(ValueError, match="mix"):
            T.MultiQueueProducer({"a": s, "b": T.ChunkFeed()},
                                 {"a": None, "b": None})

    def test_stalled_feed_blocks_walk_without_busy_wait(self):
        sim = T.nsa(_mini(), 20)
        chunks = [_slice(sim, 0, 10), _slice(sim, 10, 20)]
        feeds = {"a": T.ChunkFeed(maxsize=2), "b": T.ChunkFeed(maxsize=2)}
        group = T.QueueGroup(feeds, maxsize=1_000_000)
        producer = T.MultiQueueProducer(feeds, group.queues,
                                        clock=T.VirtualClock())
        assert producer.chunked
        status = []
        th = threading.Thread(target=lambda: status.append(producer.run()),
                              daemon=True)
        th.start()
        for ch in chunks:
            feeds["a"].put(ch)
        feeds["a"].close()
        cpu0 = time.process_time()
        time.sleep(0.3)                           # feed "b" is stalled
        cpu_burn = time.process_time() - cpu0
        assert th.is_alive()
        assert group["a"].stats()["buckets_in"] == 0   # the round lock
        assert cpu_burn < 0.2, f"stalled walk burned {cpu_burn:.2f}s CPU"
        for ch in chunks:
            feeds["b"].put(ch)
        feeds["b"].close()
        th.join(timeout=10)
        assert not th.is_alive() and status == [0]
        for k in ("a", "b"):
            assert group[k].stats()["records_in"] == len(sim)


# ------------------------------------------------------- chunked run_many
@pytest.fixture(scope="module")
def jax_pallas_chunked(tmp_path_factory):
    """The reference's device-mode chunked sweep at chunk_s=7 (interpret
    mode), run once for the module."""
    root = tmp_path_factory.mktemp("jax_pallas_chunked")
    ctl = J.Controller(str(root))
    reps = ctl.run_many(["traffic"], RANGES, _consumer, scale=SCALE,
                        seed=SEED, backend="pallas", chunk_s=7, n_devices=1,
                        host_index=0, n_hosts=1)
    return ctl, reps


def _reports_equal(got, exp, vol_rtol, corr_atol):
    assert [(r.dataset, r.max_range) for r in got] == \
        [(r.dataset, r.max_range) for r in exp]
    for a, b in zip(got, exp):
        assert (a.original_rows, a.simulated_rows, a.compression) == \
            (b.original_rows, b.simulated_rows, b.compression)
        # the feed's high-watermark depends on thread timing: bounded only
        ma, mb = counts_only(a.consumer_metrics), dict(b.consumer_metrics)
        assert ma.pop("feed_hwm_chunks") <= 2 and mb.pop("feed_hwm_chunks") <= 2
        assert ma == mb
        assert abs(a.trend_corr - b.trend_corr) <= corr_atol
        for which in ("original_volatility", "simulated_volatility"):
            for f in ("average", "variance", "std_variance"):
                assert getattr(getattr(a, which), f) == pytest.approx(
                    getattr(getattr(b, which), f), rel=vol_rtol, abs=1e-12)


class TestChunkedRunMany:
    @pytest.mark.parametrize("backend", ["torch", "numpy"])
    @pytest.mark.parametrize("chunk_s", [1, 7, 3600, 86400])
    def test_matches_jax_chunked_run_many(self, tmp_path, backend, chunk_s):
        port = T.Controller(str(tmp_path / "port"), device=CPU)
        rep = port.run_many(DATASETS, RANGES, _consumer, scale=SCALE,
                            seed=SEED, backend=backend, chunk_s=chunk_s)
        assert port.last_result.mode == ("device" if backend == "torch"
                                         else "host")
        ref_ctl = J.Controller(str(tmp_path / "jax"))
        ref = ref_ctl.run_many(DATASETS, RANGES, _consumer, scale=SCALE,
                               seed=SEED, backend="numpy", chunk_s=chunk_s)
        if backend == "numpy":
            _reports_equal(rep, ref, vol_rtol=1e-12, corr_atol=1e-12)
        else:
            _reports_equal(rep, ref, vol_rtol=1e-3, corr_atol=1e-3)
        for r in rep:
            assert r.consumer_metrics["feed_hwm_chunks"] <= 2
            assert r.consumer_metrics["records_seen"] == r.simulated_rows
            _same_stored(port.store, ref_ctl.store,
                         f"{r.dataset}__sim{r.max_range}")
        for fa, fb in zip(port.last_fidelity, ref_ctl.last_fidelity):
            a, b = np.asarray(fa.trend_corr), np.asarray(fb.trend_corr)
            assert fa.labels == fb.labels
            assert np.array_equal(np.isnan(a), np.isnan(b))
            assert np.nanmax(np.abs(a - b)) <= 1e-3

    def test_device_mode_matches_jax_pallas_chunked(self, tmp_path,
                                                    jax_pallas_chunked):
        ref_ctl, ref = jax_pallas_chunked
        port = T.Controller(str(tmp_path / "port"), device=CPU)
        rep = port.run_many(["traffic"], RANGES, _consumer, scale=SCALE,
                            seed=SEED, backend="torch", chunk_s=7)
        _reports_equal(rep, ref, vol_rtol=1e-5, corr_atol=1e-4)
        for r in rep:
            _same_stored(port.store, ref_ctl.store,
                         f"{r.dataset}__sim{r.max_range}")
        for fa, fb in zip(port.last_fidelity, ref_ctl.last_fidelity):
            np.testing.assert_allclose(np.asarray(fa.trend_corr),
                                       np.asarray(fb.trend_corr), atol=1e-4)

    def test_chunked_stores_read_across_packages(self, tmp_path):
        port = T.Controller(str(tmp_path / "port"), device=CPU)
        port.run_many(["traffic"], [45], _consumer, scale=SCALE, seed=SEED,
                      backend="torch", chunk_s=7)
        jax_ctl = J.Controller(str(tmp_path / "jax"))
        jax_ctl.run_many(["traffic"], [45], _consumer, scale=SCALE, seed=SEED,
                         backend="numpy", chunk_s=7)
        key = "traffic__sim45"
        for writer, reader in (("port", J), ("jax", T)):
            store = reader.StreamStore(str(tmp_path / writer))
            assert store.manifest(key)["chunks"] == 7
        _same_stored(T.StreamStore(str(tmp_path / "port")),
                     J.StreamStore(str(tmp_path / "jax")), key)
        _same_stored(J.StreamStore(str(tmp_path / "port")),
                     T.StreamStore(str(tmp_path / "jax")), key)
        # the reference's sweep over the port's store is a cache hit
        again = J.Controller(str(tmp_path / "port")).run_many(
            ["traffic"], [45], _consumer, scale=SCALE, seed=SEED,
            backend="numpy", chunk_s=7)
        assert again[0].nsa_s == 0.0

    def test_faults_keep_the_reconciliation_identity(self, tmp_path):
        c = T.Controller(str(tmp_path / "s"), device=CPU)
        reports = c.run_many(["traffic"], [20, 40, 60], _consumer,
                             scale=SCALE, seed=SEED, chunk_s=7,
                             backend="torch",
                             fault_plan=T.FaultPlan(5, default=T.FaultSpec(
                                 **CHAOS)))
        dropped = 0
        for r in reports:
            m = r.consumer_metrics
            assert m["buckets_in"] == (m["emitted_buckets"]
                                       - m.get("fault_dropped", 0)
                                       + m.get("fault_duplicated", 0))
            assert m["records_seen"] == m["records_in"]
            dropped += m.get("fault_dropped", 0)
        assert dropped > 0

    @pytest.mark.parametrize("on_failure", ["raise", "degrade"])
    def test_consumer_failures_match_jax_chunked_run_many(self, tmp_path,
                                                         on_failure):
        def consumer(queue):
            buckets = list(queue)
            n = sum(len(b) for b in buckets)
            if buckets[-1].scale_stamp + 1 == 20:
                raise ValueError(f"range 20, {n} records")
            return {"records_seen": n}

        got = {}
        for mod, name, kw in ((T, "port", dict(backend="torch")),
                              (J, "jax", dict(backend="numpy"))):
            ctl = mod.Controller(str(tmp_path / name), **(
                {"device": CPU} if mod is T else {}))
            call = lambda: ctl.run_many(   # noqa: E731
                DATASETS, RANGES, consumer, scale=SCALE, seed=SEED,
                chunk_s=7, on_failure=on_failure, **kw)
            if on_failure == "raise":
                with pytest.raises(RuntimeError) as ei:
                    call()
                got[name] = ei.value
            else:
                got[name] = call()
        port, ref = got["port"], got["jax"]
        if on_failure == "raise":
            assert str(port) == str(ref)
            assert str(port).startswith("2 of 4 chunked sweep consumer(s)")
            assert repr(port.__cause__) == repr(ref.__cause__)
            return
        _reports_equal(port, ref, vol_rtol=1e-3, corr_atol=1e-3)
        for a, b in zip(port, ref):
            for f in ("status", "failure", "attempts", "simulated_rows"):
                assert getattr(a, f) == getattr(b, f), f
            assert a.status == ("partial" if a.max_range == 20 else "ok")
        bad = [r for r in port if r.status == "partial"]
        assert len(bad) == 2 and all("range 20" in r.failure for r in bad)
        for r in bad:
            m = r.consumer_metrics
            assert m["degraded"] and m["attempts"] == 1
            assert m["records_in"] == r.simulated_rows

    def test_reference_value_errors(self, tmp_path):
        c = T.Controller(str(tmp_path / "s"), device=CPU)
        kw = dict(scale=SCALE, backend="torch")
        with pytest.raises(ValueError, match="chunk_s"):
            c.run_many(["traffic"], [20], _consumer, duration_s=DAY_S, **kw)
        with pytest.raises(ValueError):
            c.run_many(["traffic"], [20], _consumer, chunk_s=10,
                       retry_policy=T.RetryPolicy(max_attempts=2), **kw)
        with pytest.raises(ValueError):
            c.run_many(["traffic"], [20], _consumer, chunk_s=10,
                       consumer_deadline_s=5.0, **kw)
        for extra in (dict(chunk_s=10), dict(checkpoint=True)):
            with pytest.raises(ValueError, match="service"):
                c.run_many(["traffic"], [20], _consumer, service=True,
                           **extra, **kw)
        # without chunk_s or checkpoint the service runs (it raised
        # NotImplementedError before the sweep-service slice)
        (rep,) = c.run_many(["traffic"], [20], _consumer, service=True,
                            **kw)
        assert rep.status == "ok" and rep.simulated_rows > 0
        with pytest.raises(ValueError, match="chunk axis"):
            plan = T.plan_sweep(c.store, ["traffic"], [20], {"traffic": 5},
                                n_devices=1, host_index=0, n_hosts=1)
            T.ChunkedSweepRunner(plan, {"traffic": _mini()}, c.store,
                                 device=CPU)


# ------------------------------------------------------------- multi-day
class TestMultiDay:
    def test_7day_8sc_bounded_and_chunk_size_invariant(self, tmp_path):
        ranges = [15, 30, 45, 60]
        dur = 7 * DAY_S
        reps, ctrls = {}, {}
        for cs in (45, 150):
            c = T.Controller(str(tmp_path / f"c{cs}"), device=CPU)
            reps[cs] = c.run_many(DATASETS, ranges, _consumer, scale=0.001,
                                  seed=5, chunk_s=cs, duration_s=dur,
                                  backend="torch")
            assert c.last_result.mode == "device"
            ctrls[cs] = c
        ref_ctl = J.Controller(str(tmp_path / "jax"))
        ref = ref_ctl.run_many(DATASETS, ranges, _consumer, scale=0.001,
                               seed=5, chunk_s=45, duration_s=dur,
                               backend="numpy")
        for a, b, r in zip(reps[45], reps[150], ref):
            assert a.simulated_rows == b.simulated_rows == r.simulated_rows
            assert a.consumer_metrics["records_seen"] == \
                b.consumer_metrics["records_seen"]
            assert a.consumer_metrics["feed_hwm_chunks"] <= 2
            assert b.consumer_metrics["feed_hwm_chunks"] <= 2
            assert abs(a.trend_corr - r.trend_corr) <= 1e-3
        for r in reps[45]:
            key = f"{r.dataset}__sim{r.max_range}__d{dur}"
            _same_stored(ctrls[45].store, ctrls[150].store, key)
            _same_stored(ctrls[45].store, ref_ctl.store, key)
            sim = ctrls[45].store.get(key)
            assert sim.scale_stamp[-1] >= 6 * r.max_range   # all 7 days
        for d in DATASETS:
            _same_stored(ctrls[45].store, ref_ctl.store,
                         f"{d}__orig__d{dur}")

    def test_multiday_b7_chunks_equal_the_b4_trend(self, tmp_path):
        c = T.Controller(str(tmp_path / "s"), device=CPU)
        c.run_many(["traffic"], [30], _consumer, scale=0.001, seed=5,
                   chunk_s=45, duration_s=3 * DAY_S, backend="torch")
        q = c.last_result.shard_results[0].hist           # (1, 90)
        n = q.shape[1]
        mono, _ = tops.trend_scan_batched_device(q, [n], 60)
        segs, tail, tot = [], None, None
        for lo in range(0, n, 45):
            seg, _, tail, tot = tops.trend_scan_chunk(
                q[:, lo:lo + 45], 60, tail=tail, psum_carry=tot, lo=lo,
                is_last=lo + 45 >= n)
            segs.append(seg)
        assert torch.equal(torch.cat(segs, 1), mono[:, :n])
        assert int(tot) == int(q.sum())


# --------------------------------------------------------- the pipeline
class TestPipeline:
    def test_double_buffered_and_device_tensors(self, tmp_path,
                                                monkeypatch):
        # (a) the metrics carry takes tensors straight from the chunk's
        # launches, never numpy; (b) chunk k+1's B1 launch is queued BEFORE
        # chunk k's host gather
        import repro_torch.kernels.ops as ops_mod
        import repro_torch.kernels.stream_sample as b1_mod

        events = []
        real_sample = b1_mod.stream_sample
        real_metrics = ops_mod.stream_metrics_chunk
        real_mat = tengine.materialize_sweep

        def counting_sample(*args, **kwargs):
            events.append("sample")
            return real_sample(*args, **kwargs)

        def checking_metrics(carry, ss, totals, lo, hi):
            assert isinstance(ss, torch.Tensor), type(ss)
            assert isinstance(totals, torch.Tensor), type(totals)
            events.append("metrics")
            return real_metrics(carry, ss, totals, lo, hi)

        def tracking_mat(*args, **kwargs):
            events.append("mat")
            return real_mat(*args, **kwargs)

        monkeypatch.setattr(b1_mod, "stream_sample", counting_sample)
        monkeypatch.setattr(ops_mod, "stream_metrics_chunk", checking_metrics)
        monkeypatch.setattr(tengine, "materialize_sweep", tracking_mat)
        originals = {"traffic": _mini()}
        store = T.StreamStore(str(tmp_path / "store"))
        plan = T.plan_sweep(store, ["traffic"], [30],
                            {"traffic": len(originals["traffic"])},
                            scale=SCALE, seed=SEED, n_devices=1,
                            host_index=0, n_hosts=1, chunk_s=10)
        runner = T.ChunkedSweepRunner(plan, originals, store,
                                      backend="torch", device=CPU)
        assert runner.mode == "device"
        result = runner.run()
        n = plan.n_chunks
        assert events.count("sample") == n == events.count("metrics")
        assert events.count("mat") == n
        mat_seen = 0
        for j, e in enumerate(events):
            if e != "mat":
                continue
            samples_before = sum(x == "sample" for x in events[:j])
            if mat_seen < n - 1:
                assert samples_before >= mat_seen + 2, events
            mat_seen += 1
        assert set(result.pipeline_s) == {"dispatch_s", "host_leg_s",
                                          "event_wait_s"}
        assert result.pipeline_s["event_wait_s"] == 0.0   # CPU: no events

    def test_carry_resets_per_run_and_resume_skips_chunks(self, tmp_path):
        originals = {"traffic": _mini()}
        store = T.StreamStore(str(tmp_path / "store"))
        plan = T.plan_sweep(store, ["traffic"], [20, 45],
                            {"traffic": len(originals["traffic"])},
                            scale=SCALE, seed=SEED, n_devices=1,
                            host_index=0, n_hosts=1, chunk_s=7)
        r1 = T.ChunkedSweepRunner(plan, originals, store, backend="torch",
                                  device=CPU).run()
        key = plan.scenarios[0].store_key
        mtimes = {i: store._chunk_file(store._dir(key), i).stat().st_mtime_ns
                  for i in store.list_chunks(key)}
        r2 = T.ChunkedSweepRunner(plan, originals, store, backend="torch",
                                  device=CPU).run()
        for a, b in zip(r1.shard_results, r2.shard_results):
            assert np.array_equal(a.totals, b.totals)
            assert torch.equal(a.hist, b.hist)
            assert np.array_equal(a.mom, b.mom)
        for i, m in mtimes.items():
            assert store._chunk_file(store._dir(key), i).stat() \
                .st_mtime_ns == m, f"chunk {i} was rewritten on resume"


# ------------------------------------------------------------ checkpoint
def _key_fields(r):
    """A report without its wall times and without the feed's
    high-watermark and the queues' waits, which depend on thread timing
    (the high-watermark is bounded)."""
    d = dataclasses.asdict(r)
    for f in ("preprocess_s", "nsa_s", "produce_s"):
        d.pop(f)
    d["consumer_metrics"] = counts_only(d["consumer_metrics"])
    assert d["consumer_metrics"].pop("feed_hwm_chunks", 0) <= 2
    return d


class TestCheckpoint:
    @pytest.mark.parametrize("chunk_s", [0, 7])
    def test_kill_after_k_reports_resumes_equal(self, tmp_path, monkeypatch,
                                                chunk_s):
        grid = dict(datasets=["traffic"], max_ranges=[20, 40, 60])
        kw = dict(scale=SCALE, seed=SEED, backend="torch", chunk_s=chunk_s)
        ref = T.Controller(str(tmp_path / "ref"), device=CPU).run_many(
            consumer=_consumer, **grid, **kw)

        class SimulatedKill(BaseException):
            pass

        real_build = tengine.build_report
        built = []

        def dying_build(*args, **kwargs):
            if len(built) == 2:        # kill after k = 2 completed reports
                raise SimulatedKill()
            built.append(real_build(*args, **kwargs))
            return built[-1]

        c = T.Controller(str(tmp_path / "store"), device=CPU)
        monkeypatch.setattr(tengine, "build_report", dying_build)
        with pytest.raises(SimulatedKill):
            c.run_many(consumer=_consumer, checkpoint=True, **grid, **kw)
        monkeypatch.setattr(tengine, "build_report", real_build)
        markers = tmp_path / "store" / "_markers"
        (sweep_dir,) = list(markers.iterdir())
        assert sorted(p.name.split("__")[0] for p in sweep_dir.iterdir()) \
            .count("report") == 2
        resumed = c.run_many(consumer=_consumer, checkpoint=True, **grid,
                             **kw)
        assert [_key_fields(r) for r in resumed] == \
            [_key_fields(r) for r in ref]
        assert not any(markers.iterdir())         # cleared once complete

    def test_uninterrupted_checkpoint_run_equals_plain(self, tmp_path):
        kw = dict(scale=SCALE, seed=SEED, backend="torch")
        a = T.Controller(str(tmp_path / "plain"), device=CPU).run_many(
            ["traffic"], [20, 40], _consumer, **kw)
        c = T.Controller(str(tmp_path / "ckpt"), device=CPU)
        b = c.run_many(["traffic"], [20, 40], _consumer, checkpoint=True,
                       **kw)
        assert [_key_fields(r) for r in b] == [_key_fields(r) for r in a]
        assert not any((tmp_path / "ckpt" / "_markers").iterdir())
