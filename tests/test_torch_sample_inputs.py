"""B1's inputs (``ops.stream_sample_inputs``, ``ops.stream_sample_args``)
on the CPU, against the JAX package and numpy.

The bucket tables come from binary searches on the float64 timestamps, not
from the normalized array: ``starts`` must be bit-equal to
``np.searchsorted((t - t_min) / span * R, arange(R))`` wherever the
formula can round against a guess, and the keep-rule guard must refuse
exactly what it refused. Rows given one array share one source: their
outputs equal those of the same rows given as distinct copies, the sweep's
plain path equals the reference's ``stream_sample_batched`` lane for lane,
and the chunked runner's chunks over shared sources equal the reference's.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import repro.streamsim as J
import repro_torch.streamsim as T
from repro.kernels import ops as jops
from repro.streamsim.nsa import ChunkedNSA as JChunkedNSA
from repro_torch import tracing
from repro_torch.kernels import ops as tops
from repro_torch.kernels.stream_sample import (MAX_RANGE_LIMIT,
                                               stream_sample_plain)
from repro_torch.streamsim.nsa import _multiple

CPU = "cpu"
T0 = 1.7e9


def _edge_ties():
    # runs of 7 equal timestamps, each run exactly on a bucket edge
    return T0 + np.repeat(np.arange(601.0), 7), 600


def _sub_ms():
    rng = np.random.default_rng(11)
    return T0 + np.cumsum(rng.uniform(0.0, 1e-3, 20_000)), 3600


def _edge_ulps():
    # the float64 neighbours of every bucket edge, and the edges
    span, R = 86_399.0, 3600
    edges = T0 + np.arange(R + 1) * (span / R)
    t = np.concatenate([edges, np.nextafter(edges, 0.0),
                        np.nextafter(edges, np.inf)])
    t = np.sort(t[(t >= T0) & (t <= T0 + span)])
    return t, R


def _empty_buckets():
    rng = np.random.default_rng(12)
    return T0 + np.sort(rng.uniform(0.0, 86_400.0, 50)), 3600


def _two_records():
    return np.array([T0, T0 + 5.0]), 600


def _one_bucket():
    rng = np.random.default_rng(13)
    return T0 + np.sort(rng.uniform(0.0, 3600.0, 1000)), 1


def _at_the_limit():
    rng = np.random.default_rng(14)
    return T0 + np.sort(rng.uniform(0.0, 86_400.0, 300_000)), MAX_RANGE_LIMIT


def _integer_seconds():
    rng = np.random.default_rng(15)
    return T0 + np.floor(np.sort(rng.uniform(0.0, 86_400.0, 50_000))), 1800


STARTS_CASES = {"edge_ties": _edge_ties, "sub_ms": _sub_ms,
                "edge_ulps": _edge_ulps, "empty_buckets": _empty_buckets,
                "two_records": _two_records, "one_bucket": _one_bucket,
                "at_the_limit": _at_the_limit,
                "integer_seconds": _integer_seconds}


@pytest.mark.parametrize("case", sorted(STARTS_CASES))
def test_starts_bit_equal_to_searchsorted_over_v(case):
    t, R = STARTS_CASES[case]()
    span = float(t[-1]) - float(t[0])
    v = (t - float(t[0])) / span * R
    want = np.searchsorted(v, np.arange(R))
    starts, counts, ktab, (t_min, inv_span, nb) = tops._nsa_tables(
        t, R, 7.0)
    assert starts.dtype == np.int32
    np.testing.assert_array_equal(starts, want)
    assert (t_min, inv_span, nb) == (float(t[0]), 1.0 / span, float(R))
    ref = jops._nsa_tables(t, R, 7.0)
    for x, y in zip(ref[1:4], (starts, counts, ktab)):
        np.testing.assert_array_equal(x, y)


def test_zero_span_stream_tables():
    t = np.full(700, T0)
    starts, counts, ktab, (t_min, inv_span, nb) = tops._nsa_tables(
        t, 600, 3.0, 640)
    want = np.full(640, 700, np.int32)
    want[0] = 0
    np.testing.assert_array_equal(starts, want)
    assert counts[0] == 700 and not counts[1:].any()
    assert (t_min, inv_span, nb) == (T0, 0.0, 600.0)
    ref = jops._nsa_tables(t, 600, 3.0, 640)
    for x, y in zip(ref[1:4], (starts, counts, ktab)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,raises", [(46_341, False), (46_342, True)])
def test_keep_rule_overflow_where_it_was(n, raises):
    # one bucket of n records kept at k = n: (n - 1) * k crosses 2**31
    # between 46,341 and 46,342 records
    t = T0 + np.arange(float(n))
    for mod in (jops, tops):
        if raises:
            with pytest.raises(mod.KeepRuleOverflow):
                mod._nsa_tables(t, 1, 1.0)
        else:
            mod._nsa_tables(t, 1, 1.0)


# ------------------------------------------------------- shared sources
def _grid(scale=0.002, seed=4):
    streams = {d: T.preprocess(T.make_stream(d, scale=scale, seed=seed))
               for d in ("sogouq", "traffic", "userbehavior")}
    ranges = (600, 1200, 1800, 2400, 3000, 3600)
    pairs = [(d, r) for d in streams for r in ranges]
    ts = [streams[d].t for d, _ in pairs]
    mults = [_multiple(len(streams[d]), streams[d].time_range, r, "time")
             for d, r in pairs]
    return streams, pairs, ts, [r for _, r in pairs], mults


def test_rows_sharing_an_array_equal_distinct_copies():
    _, _, ts, ranges, mults = _grid()
    inputs = tops.stream_sample_inputs(ts, ranges, mults)
    sources, src = inputs[:2]
    assert len(sources) == 3 and src.tolist() == [0] * 6 + [1] * 6 + [2] * 6
    copies = [t.copy() for t in ts]
    assert len(tops.stream_sample_inputs(copies, ranges, mults)[0]) == 18
    shared = tops.stream_sample_batched(ts, ranges, mults, device=CPU)
    apart = tops.stream_sample_batched(copies, ranges, mults, device=CPU)
    for a, b in zip(shared[:2], apart[:2]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(shared[2], apart[2])


def test_grid_plain_path_equals_the_reference_lane_for_lane():
    # ragged rows (three lengths), each source read by six rows, and the
    # lanes past each row's length: ss and keep on every lane
    _, _, ts, ranges, mults = _grid()
    ss_j, keep_j, len_j = jops.stream_sample_batched(ts, ranges, mults)
    ss_t, keep_t, len_t = tops.stream_sample_batched(ts, ranges, mults,
                                                     device=CPU)
    assert len(set(len_t.tolist())) == 3
    assert ss_t.shape[1] > len_t.min()
    np.testing.assert_array_equal(len_t, np.asarray(len_j))
    np.testing.assert_array_equal(ss_t.numpy(), np.asarray(ss_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


def test_args_lay_each_source_once():
    _, _, ts, ranges, mults = _grid()
    inputs = tops.stream_sample_inputs(ts, ranges, mults)
    args = tops.stream_sample_args(inputs, CPU)
    sources, src = inputs[:2]
    base = args.base.numpy()
    assert args.t.dtype == torch.float64
    assert args.t.numel() < sum(len(x) for x in sources) + 3 * 32
    for s, k in enumerate(src):
        assert base[s] % 32 == 0
        np.testing.assert_array_equal(
            args.t[base[s]:base[s] + len(sources[k])].numpy(), sources[k])
    assert args.n % tops.TILE == 0 and args.n >= max(map(len, sources))


def test_chunks_over_shared_sources_equal_the_reference():
    streams, pairs, _, _, _ = _grid(seed=5)
    cn = T.ChunkedNSA(streams, pairs, device=CPU)
    assert cn._args.t.numel() < sum(len(s) for s in streams.values()) + 96
    jcn = JChunkedNSA({d: J.Stream(s.name, s.t, s.payload)
                       for d, s in streams.items()}, pairs)
    for lo in range(0, cn.width, 700):
        hi = min(lo + 700, cn.width)
        h, jh = cn.chunk(lo, hi), jcn.chunk(lo, hi)
        totals = h.totals.numpy()
        np.testing.assert_array_equal(totals, np.asarray(jh.totals))
        np.testing.assert_array_equal(h.rec_off, jh.rec_off)
        j_ss, j_idx = np.asarray(jh.ss_kept), np.asarray(jh.idx)
        for r, tot in enumerate(totals):
            np.testing.assert_array_equal(h.idx[r, :tot].numpy(),
                                          j_idx[r, :tot])
            np.testing.assert_array_equal(h.ss_kept[r, :tot].numpy(),
                                          j_ss[r, :tot])


def test_chunk_rows_past_their_range_read_inside_the_source():
    # a row whose range ends before the chunk: an empty slice, no keep bit
    streams, _, _, _, _ = _grid(seed=6)
    cn = T.ChunkedNSA(streams, [("traffic", 600), ("userbehavior", 3600)],
                      device=CPU)
    args, a = cn.sample_inputs(1200, 1800)
    assert args.lengths[0] == 0 and a[0] == len(streams["traffic"])
    base = args.base.numpy()
    assert base[0] == cn._args.base[0] + len(streams["traffic"]) - 1
    _, keep = stream_sample_plain(*args)
    assert not keep[0].any() and keep[1].any()


def test_host_tables_span_counts_rows_and_sources():
    _, _, ts, ranges, mults = _grid()
    tracing.drain()
    tracing.enable()
    try:
        tops.stream_sample_inputs(ts, ranges, mults)
        tops.stream_sample_inputs(ts[:1], ranges[:1], mults[:1])
    finally:
        tracing.enable(False)
    grid, one = [r for r in tracing.drain() if r.name == "nsa.host_tables"]
    assert (grid.counts["rows"], grid.counts["sources"]) == (18, 3)
    assert (one.counts["rows"], one.counts["sources"]) == (1, 1)
    assert grid.counts["width"] % tops.TILE == 0
