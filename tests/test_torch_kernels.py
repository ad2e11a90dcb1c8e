"""Kernel-level parity of the PyTorch port against the JAX package.

The port's kernel wrappers run their plain PyTorch versions on CPU
tensors; the JAX side runs through ``repro.kernels.ops``, whose Pallas
kernels execute in interpret mode off the TPU. Inputs come from numpy
seeds and go to both packages as numpy arrays.

Contracts: scale stamps, keep bits, kept indices, totals and counts are
bit-exact; the moments ``[Σq, Σq²]`` agree within 1e-5 relative (f32
block partials + Kahan fold, summed in another order than the TPU's);
trend correlations within 1e-5 of JAX's f32 chain and 1e-3 of f64.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.compact import compact, compact_plain
from repro_torch.kernels.metrics_fused import (_kahan_moments,
                                               stream_metrics,
                                               stream_metrics_plain)
from repro_torch.kernels.stream_sample import (stream_sample,
                                               stream_sample_plain)

CPU = "cpu"


def _stream(rng, n, span=86_400.0, integer=False, t0=1.5e9):
    """A sorted timestamp array; ``integer`` makes ties (UserBehavior-like
    integer seconds)."""
    t = np.sort(rng.uniform(0.0, span, n))
    if integer:
        t = np.floor(t)
    return t0 + t


def _ragged_batch(seed):
    rng = np.random.default_rng(seed)
    return [_stream(rng, 3000), _stream(rng, 1500, integer=True),
            np.full(700, 1.6e9),                       # zero span
            np.array([1.7e9]),                         # single record
            _stream(rng, 2100, span=3600.0)]


RANGES = [60, 600, 1800, 3600, 37]


def _mults(ts, ranges):
    from repro.streamsim.nsa import _multiple
    return [_multiple(len(t), float(t[-1] - t[0]), mr, "time")
            for t, mr in zip(ts, ranges)]


# ------------------------------------------------------------------ B1
class TestStreamSample:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_ragged_mixed_range_batch_bit_identical(self, seed):
        ts = _ragged_batch(seed)
        mults = _mults(ts, RANGES)
        ss_j, keep_j, len_j = jops.stream_sample_batched(ts, RANGES, mults)
        ss_t, keep_t, len_t = tops.stream_sample_batched(
            ts, RANGES, mults, device=CPU)
        assert np.array_equal(len_t, np.asarray(len_j))
        assert ss_t.dtype == torch.int32 and keep_t.dtype == torch.bool
        assert np.array_equal(ss_t.numpy(), np.asarray(ss_j))
        assert np.array_equal(keep_t.numpy(), np.asarray(keep_j))

    @pytest.mark.parametrize("max_range", [1, 600, 3600])
    def test_single_stream_each_range(self, max_range):
        rng = np.random.default_rng(max_range)
        t = _stream(rng, 5000, integer=True)
        (m,) = _mults([t], [max_range])
        ss_j, keep_j, _ = jops.stream_sample_batched([t], max_range, m)
        ss_t, keep_t, _ = tops.stream_sample_batched([t], max_range, m,
                                                     device=CPU)
        assert np.array_equal(ss_t.numpy(), np.asarray(ss_j))
        assert np.array_equal(keep_t.numpy(), np.asarray(keep_j))

    def test_tables_match_reference(self):
        # the reference's tables bit for bit; its rebased f32 timestamps
        # are what B1 makes of the stream and the port's float64 t_min
        rng = np.random.default_rng(3)
        t = _stream(rng, 4000, integer=True)
        for width in (None, 5000):
            a = jops._nsa_tables(t, 3600, 24.0, width)
            b = tops._nsa_tables(t, 3600, 24.0, width)
            for x, y in zip(a[1:4], b[:3]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            t_min, inv_span, nb = b[3]
            assert a[4] == (0.0, inv_span, nb) and t_min == t[0]
            assert np.array_equal(a[0], (t - t_min).astype(np.float32))

    def test_plain_version_is_the_cpu_dispatch(self):
        ts = _ragged_batch(5)
        inputs = tops.stream_sample_args(
            tops.stream_sample_inputs(ts, RANGES, _mults(ts, RANGES)), CPU)
        before = stream_sample.launches
        a = stream_sample(*inputs)
        b = stream_sample_plain(*inputs)
        assert stream_sample.launches == before, "no kernel ran on the CPU"
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_keep_false_past_each_length(self):
        ts = _ragged_batch(2)
        _, keep, lengths = tops.stream_sample_batched(
            ts, RANGES, _mults(ts, RANGES), device=CPU)
        for r, n in enumerate(lengths):
            assert not keep[r, n:].any()


# ------------------------------------------------------------------ B2
class TestCompact:
    @pytest.mark.parametrize("shape,p", [((1, 5000), 0.3), ((4, 1024), 0.5),
                                         ((3, 777), 0.05), ((2, 3), 1.0),
                                         ((5, 2000), 0.0)])
    def test_matches_reference(self, shape, p):
        rng = np.random.default_rng(shape[1])
        mask = rng.random(shape) < p
        idx_j, tot_j = jops.compact_mask_batched(jnp.asarray(mask))
        idx_t, tot_t = tops.compact_mask_batched(torch.from_numpy(mask))
        assert idx_t.dtype == torch.int32
        assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
        assert tot_t.dtype == np.int64 and np.array_equal(tot_t, tot_j)

    def test_int_mask_and_sentinel(self):
        mask = np.array([[0, 1, 1, 0, 1], [0, 0, 0, 0, 0]], np.int32)
        idx, tot = tops.compact_mask_batched_device(torch.from_numpy(mask))
        assert tot.dtype == torch.int32 and tot.tolist() == [3, 0]
        assert idx.tolist() == [[1, 2, 4, 5, 5], [5, 5, 5, 5, 5]]

    def test_wrapper_cpu_dispatch_counts_nothing(self):
        mask = torch.from_numpy(np.random.default_rng(0).random((2, 999))
                                < 0.4)
        before = compact.launches
        a, b = compact(mask), compact_plain(mask)
        assert compact.launches == before
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# --------------------------------- B2's one-launch order of work, modelled
# The CUDA kernel cannot run here; its order of work can. The model runs
# ``grid`` blocks of csrc/compact.cu as generators, advanced one step at a
# time in a random order (the card runs them in parallel and in no order):
# each block draws tickets until none is left; for each tile it publishes
# its aggregate, walks back over the row's earlier tiles summing aggregates
# down to the nearest published inclusive prefix (waiting where a tile has
# published nothing yet), publishes its own inclusive prefix and writes its
# kept indices at that offset; the row's last tile writes the total. Only
# once it finds no ticket left does a block fill its share of the
# tile-sized spans of idx, each after waiting for its row's total (the
# kernel's tiles are 4096 or 16384 records; the model's are smaller, so
# that a row has many). The answer must not depend
# on the order, every idx slot must be written exactly once, no block may
# wait forever, and the last draw must leave the counter at 0.
def _compact_lookback_model(mask, tile, grid, seed):
    rng = np.random.default_rng(seed)
    R, n = mask.shape
    n_tiles = -(-n // tile)
    n_work = R * n_tiles
    grid = min(grid, n_work)
    status = {}                        # (r, j) -> (flag, value)
    state = {"counter": 0, "writes": np.zeros((R, n), np.int64)}
    idx = np.full((R, n), -1, np.int64)
    totals = np.full(R, -1, np.int64)

    def write(r, lo, values):
        idx[r, lo:lo + len(values)] = values
        state["writes"][r, lo:lo + len(values)] += 1

    def block(b):
        while True:
            t = state["counter"]
            state["counter"] += 1
            if t == n_work + grid - 1:
                state["counter"] = 0   # the last draw of this call
            yield
            if t >= n_work:
                break
            r, j = divmod(t, n_tiles)
            kept = j * tile + np.flatnonzero(mask[r, j * tile:(j + 1) * tile])
            prefix = 0
            if j > 0:
                status[(r, j)] = ("aggregate", len(kept))
                yield
                k = j - 1
                while True:
                    if (r, k) not in status:
                        yield              # tile k has published nothing
                        continue
                    flag, value = status[(r, k)]
                    prefix += value
                    if flag == "inclusive":
                        break
                    k -= 1
                    yield
            status[(r, j)] = ("inclusive", prefix + len(kept))
            if j == n_tiles - 1:
                totals[r] = prefix + len(kept)
            yield
            write(r, prefix, kept)
            yield
        for w in range(b, n_work, grid):
            r, j = divmod(w, n_tiles)
            while status.get((r, n_tiles - 1), ("",))[0] != "inclusive":
                yield
            total = status[(r, n_tiles - 1)][1]
            lo, hi = max(j * tile, total), min((j + 1) * tile, n)
            if lo < hi:
                write(r, lo, np.full(hi - lo, n))
            yield

    running = [block(b) for b in range(grid)]
    steps, limit = 0, 200 * (n_work * n_tiles + R * n + grid) + 10_000
    while running:
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
        steps += 1
        assert steps < limit, "a block waited forever"
    assert state["counter"] == 0, "the last draw did not reset the counter"
    assert (state["writes"] == 1).all(), "an idx slot written != once"
    return idx.astype(np.int32), totals.astype(np.int32)


@pytest.mark.parametrize("p", [0.0, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("R,n,tile,grid", [
    (1, 5000, 64, 7),          # one row, more tiles than blocks
    (3, 777, 32, 100),         # a ragged last tile, more blocks than tiles
    (18, 1000, 16, 5),         # the sweep's 18 rows, few blocks
    (2, 40, 64, 3)])           # N under one tile
def test_compact_lookback_model_matches_plain_and_pallas(R, n, tile, grid,
                                                         p):
    """B2's one-launch scan and fill, modelled, against the plain version
    and the JAX Pallas kernel plus its scatter (interpret mode), bit for
    bit: idx with its sentinel tail, and totals."""
    rng = np.random.default_rng(R * 1000 + n)
    mask = rng.random((R, n)) < p
    idx, totals = _compact_lookback_model(mask, tile, grid,
                                          seed=int(p * 100) + n)
    idx_p, tot_p = compact_plain(torch.from_numpy(mask))
    np.testing.assert_array_equal(idx, idx_p.numpy())
    np.testing.assert_array_equal(totals, tot_p.numpy())
    idx_j, tot_j = jops.compact_mask_batched(jnp.asarray(mask))
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    np.testing.assert_array_equal(totals, tot_j)


# ------------------------------------ B1's eight records per thread, modelled
# csrc/stream_sample.cu gives each thread 8 consecutive records and keeps
# the last snapped bucket's (start, count, k) in registers, reading the
# tables only when the f32 guess or the snapped bucket moves. The model
# below is that loop in numpy float32 (rounded after every op, as the _rn
# intrinsics are), group by group, with the row's last group cut short
# where N is not a multiple of 8 (the kernel's scalar path). It must equal
# the plain version bit for bit, and read the tables far less often than
# five times a record.
_B1_ITEMS = 8


def _stream_sample_model(t, base, t_min, starts, counts, ktab, scalars,
                         lengths, n):
    S = len(base)
    ss = np.zeros((S, n), np.int32)
    keep = np.zeros((S, n), bool)
    reads = 0
    for s in range(S):
        inv_span, nb_f = (np.float32(x) for x in scalars[s])
        nb = int(nb_f)
        st, ct, kt = starts[s], counts[s], ktab[s]
        last = max(int(lengths[s]) - 1, 0)
        for i0 in range(0, n, _B1_ITEMS):
            cb = -1
            c_start = c_count = c_k = 0
            for i in range(i0, min(i0 + _B1_ITEMS, n)):
                # the rebase: f32 of the float64 difference
                t32 = np.float32(t[base[s] + min(i, last)] - t_min[s])
                x = np.float32(np.float32(t32 * inv_span) * nb_f)
                g = int(min(max(np.floor(x), np.float32(0)),
                            np.float32(nb - 1)))
                s_g, c_g = c_start, c_count
                if g != cb:
                    s_g, c_g = int(st[g]), int(ct[g])
                    reads += 2
                b = g + int(i >= s_g + c_g) - int(i < s_g)
                b = min(max(b, 0), nb - 1)
                if b != cb:
                    if b == g:
                        c_start, c_count = s_g, c_g
                    else:
                        c_start, c_count = int(st[b]), int(ct[b])
                        reads += 2
                    c_k = int(kt[b])
                    reads += 1
                    cb = b
                ss[s, i] = b
                keep[s, i] = i < lengths[s] and \
                    ((i - c_start) * c_k) % max(c_count, 1) < c_k
    return ss, keep, reads


def _b1_args(ts, ranges):
    """B1's arguments on the CPU for rows ``ts`` at ``ranges``."""
    return tops.stream_sample_args(
        tops.stream_sample_inputs(ts, ranges, _mults(ts, ranges)), CPU)


def _model(args):
    return _stream_sample_model(*(x.numpy() if isinstance(x, torch.Tensor)
                                  else x for x in args))


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_sample_group_model_matches_plain(seed):
    args = _b1_args(_ragged_batch(seed), RANGES)
    ss, keep, reads = _model(args)
    ss_p, keep_p = stream_sample_plain(*args)
    np.testing.assert_array_equal(ss, ss_p.numpy())
    np.testing.assert_array_equal(keep, keep_p.numpy())
    assert reads < 5 * ss.size / 2


def test_stream_sample_group_model_short_rows():
    """Rows of 1003 records, not a multiple of 8 (the kernel's scalar
    path, the last group cut short): the model equals the plain version."""
    ts = [t[:1003] for t in _ragged_batch(4)[:2]]
    args = _b1_args(ts, [600, 3600])._replace(n=1003)
    assert args.n % _B1_ITEMS and (args.lengths == 1003).all()
    ss, keep, _ = _model(args)
    ss_p, keep_p = stream_sample_plain(*args)
    np.testing.assert_array_equal(ss, ss_p.numpy())
    np.testing.assert_array_equal(keep, keep_p.numpy())


# ------------------------------------------------------------------ B3
def _assert_moments(got, want, rtol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


class TestMetricsFused:
    def test_host_input_ragged_unsorted(self):
        rng = np.random.default_rng(11)
        max_range = 1300
        rows = [rng.integers(0, max_range, 5000),       # unsorted
                np.sort(rng.integers(0, 700, 2500)),
                np.zeros(0, np.int64),                 # empty row
                np.full(40, max_range - 1)]
        h_j, m_j, l_j = jops.stream_metrics_batched(rows, max_range)
        h_t, m_t, l_t = tops.stream_metrics_batched(rows, max_range,
                                                    device=CPU)
        assert np.array_equal(l_t, l_j)
        assert h_t.dtype == torch.int32
        assert np.array_equal(h_t.numpy(), np.asarray(h_j))
        _assert_moments(m_t.numpy(), m_j)
        q = h_t.numpy().astype(np.float64)
        _assert_moments(m_t.numpy(), np.stack([q.sum(1), (q * q).sum(1)], 1))

    def test_device_input_masks_garbage_tail(self):
        rng = np.random.default_rng(12)
        max_range = 600
        ss = rng.integers(0, max_range, (3, 4096)).astype(np.int32)
        ss[:, 3000:] = rng.integers(-5, 10 ** 6, (3, 1096))   # garbage
        valid = np.array([3000, 17, 0])
        h_j, m_j = jops.stream_metrics_batched_device(
            jnp.asarray(ss), valid, max_range)
        h_t, m_t = tops.stream_metrics_batched_device(
            torch.from_numpy(ss), valid, max_range)
        assert np.array_equal(h_t.numpy(), np.asarray(h_j))
        _assert_moments(m_t.numpy(), m_j)

    def test_single_stream_form(self):
        ss = np.random.default_rng(1).integers(0, 3600, 9000)
        h_j, m_j = jops.stream_metrics(ss, 3600)
        h_t, m_t = tops.stream_metrics(ss, 3600, device=CPU)
        assert np.array_equal(h_t.numpy(), np.asarray(h_j))
        _assert_moments(m_t.numpy(), m_j)

    def test_kahan_fold_over_a_day_of_buckets(self):
        # the original stream's report launch: 86 528 buckets at ~122/s
        q = np.random.default_rng(4).poisson(122.0, (2, 86_528))
        mom = _kahan_moments(torch.from_numpy(q.astype(np.int32)))
        qf = q.astype(np.float64)
        _assert_moments(mom.numpy(), np.stack([qf.sum(1), (qf * qf).sum(1)],
                                              1))

    def test_plain_ignores_out_of_range_and_past_length(self):
        ss = torch.tensor([[0, 1, 1, 512, -1, 3, 3]], dtype=torch.int32)
        hist, mom = stream_metrics_plain(ss, torch.tensor([6]), 512)
        assert hist[0, :4].tolist() == [1, 2, 0, 1] and int(hist.sum()) == 4
        assert mom[0].tolist() == [4.0, 6.0]

    def test_wrapper_cpu_dispatch_counts_nothing(self):
        ss = torch.from_numpy(np.random.default_rng(2).integers(
            0, 1024, (2, 3000)).astype(np.int32))
        lengths = torch.tensor([3000, 1200], dtype=torch.int32)
        before = stream_metrics.launches
        a = stream_metrics(ss, lengths, 1024)
        b = stream_metrics_plain(ss, lengths, 1024)
        assert stream_metrics.launches == before
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_buckets_must_be_block_aligned(self):
        with pytest.raises(ValueError):
            stream_metrics_plain(torch.zeros((1, 4), dtype=torch.int32),
                                 torch.tensor([4]), 600)


# ------------------------------ B3/B6's one-launch order of work, modelled
# csrc/metrics_fused.cu zeroes the histogram, counts and folds the moments
# in one launch. The model runs its blocks as generators, each started at a
# random moment (at most ``slots`` run at once, picked in no particular
# order) and advanced one step at a time in a random order. Each block
# first draws a ticket: the first tickets zero a span of ``span`` buckets
# of a row's histogram and publish an epoch-stamped word; the next take
# ``group`` tiles of ``tile`` records of a row in turn, find each tile's
# bucket range, count it privately when it fits in ``smem`` buckets (else
# record by record) and, before the first add, wait for the words of the
# spans that range covers (spans it already saw zeroed are skipped); every
# span and every tile group within the row's length then takes the row's
# count ticket. When the row has at most ``piece`` 512-bucket blocks, the
# last one computes the partials and folds them; else the last tickets are
# pieces of ``piece`` blocks each, which wait for the row's count, write
# their partials and take the row's piece ticket, and the last piece folds
# them all. Partials are f32 sums over each 512-bucket block, a per-lane
# running sum over j * 32 + lane and then the xor butterfly, folded in
# block order with Kahan compensation, all in numpy float32 (rounded
# after every operation, as the _rn intrinsics are). The histogram starts
# as garbage, as the wrapper's torch.empty leaves it. Every bin must be
# zeroed exactly once and before any add to it, no block may wait
# forever, and every counter must end at 0.
_B3_BLOCK = 512


def _partials_model(hist):
    """``(p1, p2)`` float32 (S, B / 512): each block's partials, as the
    kernel's warps sum them."""
    S, B = hist.shape
    q = hist.astype(np.float32).reshape(S, B // _B3_BLOCK, 16, 32)
    a = np.zeros((S, B // _B3_BLOCK, 32), np.float32)
    b = np.zeros_like(a)
    for j in range(16):                # lane's running sum over j * 32 + lane
        a = a + q[:, :, j, :]
        b = b + q[:, :, j, :] * q[:, :, j, :]
    for o in (16, 8, 4, 2, 1):         # the xor butterfly
        partner = np.arange(32) ^ o
        a = a + a[..., partner]
        b = b + b[..., partner]
    return a[..., 0], b[..., 0]


def _kahan_model(p1, p2, state):
    """``state`` (S, 4) float32 ``[s1, c1, s2, c2]`` with the partials
    folded in, in block order."""
    s1, c1, s2, c2 = (state[:, k].astype(np.float32) for k in range(4))
    for blk in range(p1.shape[1]):
        y1 = p1[:, blk] - c1
        t1 = s1 + y1
        c1 = (t1 - s1) - y1
        s1 = t1
        y2 = p2[:, blk] - c2
        t2 = s2 + y2
        c2 = (t2 - s2) - y2
        s2 = t2
    return np.stack([s1, c1, s2, c2], axis=1)


class _MetricsWorkspace:
    """The per-stream scratch: span words (the epoch that zeroed them),
    the ticket counter and two counters a row, zero when allocated, kept
    across calls."""

    def __init__(self):
        self.words = {}
        self.counters = {}
        self.epoch = 0


def _metrics_fused_model(ss, lengths, buckets, mcar, base, *, ws, seed,
                         tile=64, group=2, span=192, smem=256, piece=1,
                         slots=32):
    rng = np.random.default_rng(seed)
    S, n = ss.shape
    ws.epoch += 1
    epoch, ctr = ws.epoch, ws.counters
    n_spans = -(-buckets // span)
    n_groups = -(-(-(-n // tile)) // group)
    n_blocks = buckets // _B3_BLOCK
    n_pieces = 0 if n_blocks <= piece else -(-n_blocks // piece)
    n_work = S * (n_spans + n_groups + n_pieces)
    hist = rng.integers(-10 ** 6, 10 ** 6, (S, buckets))   # torch.empty
    zero_writes = np.zeros((S, buckets), np.int64)
    partials = np.full((S, n_blocks, 2), np.nan, np.float32)
    folds = np.zeros(S, np.int64)
    mom = np.full((S, 4), np.nan, np.float32)

    def add(s, b, c):
        assert zero_writes[s, b] == 1 and \
            ws.words.get((s, b // span), 0) == epoch, \
            "an add before its bin's zeroing was published"
        hist[s, b] += c

    def take(key):
        prev = ctr.get(key, 0)
        ctr[key] = prev + 1
        return prev

    def parts(s):
        length = max(0, min(int(lengths[s]), n))
        return n_spans + min(n_groups, -(-length // tile))

    def fold(s, p1, p2):
        assert (zero_writes[s] == 1).all(), "folded before every zero"
        mom[s] = _kahan_model(p1[None], p2[None], mcar[s:s + 1])[0]
        folds[s] += 1

    def block():
        t = take("ticket")
        if t == n_work - 1:
            ctr["ticket"] = 0              # the last draw
        yield
        if t >= S * (n_spans + n_groups):  # a piece
            s, p = divmod(t - S * (n_spans + n_groups), n_pieces)
            while ctr.get(("count", s), 0) != parts(s):
                yield                      # parts hold lower tickets
            b0, b1 = p * piece, min(n_blocks, (p + 1) * piece)
            p1, p2 = _partials_model(hist[s:s + 1, b0 * _B3_BLOCK:
                                          b1 * _B3_BLOCK])
            partials[s, b0:b1] = np.stack([p1[0], p2[0]], axis=1)
            yield
            if take(("piece", s)) == n_pieces - 1:
                ctr[("piece", s)] = ctr[("count", s)] = 0
                fold(s, partials[s, :, 0], partials[s, :, 1])
            return
        if t < S * n_spans:                # a span
            s, z = divmod(t, n_spans)
            for lo in range(z * span, min((z + 1) * span, buckets), 32):
                hi = min(lo + 32, (z + 1) * span, buckets)
                hist[s, lo:hi] = 0
                zero_writes[s, lo:hi] += 1
                yield
            ws.words[(s, z)] = epoch
        else:                              # a tile group
            s, g = divmod(t - S * n_spans, n_groups)
            length = max(0, min(int(lengths[s]), n))
            tiles = -(-length // tile)
            if g >= tiles:
                return                     # past the row's length
            seen = {z for z in range(n_spans)
                    if ws.words.get((s, z), 0) == epoch}
            yield
            for tl in range(g, tiles, n_groups):
                raw = ss[s, tl * tile:min((tl + 1) * tile, length)]
                r = (raw.astype(np.int64) - base) % 2 ** 32   # unsigned
                v = r[r < buckets]
                yield
                if not len(v):
                    continue
                lo, hi = int(v.min()), int(v.max())
                for z in range(lo // span, hi // span + 1):
                    while z not in seen and ws.words.get((s, z), 0) != epoch:
                        yield              # held by a lower ticket
                    seen.add(z)
                if hi - lo + 1 <= smem:
                    counts = np.bincount(v - lo, minlength=hi - lo + 1)
                    for b in np.flatnonzero(counts):
                        add(s, lo + b, counts[b])
                        yield
                else:
                    for b in v:
                        add(s, b, 1)
                        yield
        yield
        if take(("count", s)) == parts(s) - 1 and not n_pieces:
            ctr[("count", s)] = 0
            p1, p2 = _partials_model(hist[s:s + 1])
            fold(s, p1[0], p2[0])

    pending = n_work
    running, steps = [], 0
    limit = 100 * (S * (n + buckets) + n_work) + 10_000
    while pending or running:
        if pending and (len(running) < slots and rng.random() < 0.5
                        or not running):
            running.append(block())
            pending -= 1
            continue
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
        steps += 1
        assert steps < limit, "a block waited forever"
    assert (zero_writes == 1).all(), "a bin zeroed != once"
    assert (folds == 1).all(), "a row folded != once"
    assert all(v == 0 for v in ctr.values()), "a counter left non-zero"
    return hist.astype(np.int32), mom


def _metrics_case(case, rng):
    """(ss, lengths, buckets) of one model case; stamps are chunk-local
    (0-based): B6 adds its base."""
    if case == "n0":
        return np.zeros((3, 0), np.int32), np.array([0, 5, 0]), 1024
    buckets = 512 if case == "buckets512" else 1024
    S, n = 4, 700
    ss = rng.integers(0, buckets, (S, n))
    lengths = np.full(S, n)
    if case in ("sorted", "ragged", "all_padding", "buckets512"):
        ss = np.sort(ss, axis=1)
    if case == "outside":                 # below the chunk and past it
        ss[:, ::3] = rng.integers(-300, 0, ss[:, ::3].shape)
        ss[:, 1::5] = rng.integers(buckets, buckets + 400, ss[:, 1::5].shape)
    if case == "ragged":
        lengths = np.array([700, 663, 1, 65])
    if case == "all_padding":
        lengths[2] = 0
        ss[2] = rng.integers(-10 ** 6, 10 ** 6, n)      # garbage
    return ss.astype(np.int32), lengths, buckets


def _pallas_metrics(local, lengths, buckets, mcar):
    """The JAX Pallas kernel (interpret mode) on chunk-local stamps: the
    reference's padding id (buckets) past each length, outside
    [0, buckets) and past N up to its tile."""
    from repro.kernels.metrics_fused import (stream_metrics_carry_pallas,
                                             stream_metrics_pallas)
    S, n = local.shape
    i = np.arange(n)[None, :]
    valid = (i < lengths[:, None]) & (local >= 0) & (local < buckets)
    j_in = np.full((S, max(-(-n // 1024), 1) * 1024), buckets, np.int32)
    j_in[:, :n] = np.where(valid, local, buckets)
    if mcar is None:
        h, m = stream_metrics_pallas(jnp.asarray(j_in), buckets,
                                     interpret=True)
    else:
        h, m = stream_metrics_carry_pallas(jnp.asarray(j_in),
                                           jnp.asarray(mcar), buckets,
                                           interpret=True)
    return np.asarray(h), np.asarray(m)


@pytest.mark.parametrize("case", ["sorted", "unsorted", "outside", "ragged",
                                  "all_padding", "n0", "buckets512"])
@pytest.mark.parametrize("kind", ["b3", "b6_zero", "b6_random"])
def test_metrics_fused_model_matches_plain_and_pallas(kind, case):
    """B3's and B6's one-launch zeroing, counting and fold, modelled,
    against the plain versions and the JAX Pallas kernels (interpret mode):
    hist bit for bit, moments within 1e-5 relative; B6 with a zero carry
    equal to B3 bit for bit; a second call on the same workspace (the next
    epoch) gives the same result."""
    from repro_torch.kernels.metrics_fused import stream_metrics_carry_plain
    seed = sum(map(ord, kind + case))
    rng = np.random.default_rng(seed)
    local, lengths, buckets = _metrics_case(case, rng)
    S = local.shape[0]
    base = 0 if kind == "b3" else 300
    ss = local + base
    zero = np.zeros((S, 4), np.float32)
    mcar = zero if kind != "b6_random" else np.stack(
        [rng.uniform(0, 5e5, S), rng.uniform(-1, 1, S),
         rng.uniform(0, 5e8, S), rng.uniform(-64, 64, S)],
        axis=1).astype(np.float32)
    ws = _MetricsWorkspace()
    # few blocks resident at once (2), or most of the launch (32)
    slots = 2 if kind == "b6_random" else 32
    hist, mom = _metrics_fused_model(ss, lengths, buckets, mcar, base,
                                     ws=ws, seed=seed, slots=slots)
    hist2, mom2 = _metrics_fused_model(ss, lengths, buckets, mcar, base,
                                       ws=ws, seed=seed + 1, slots=slots)
    np.testing.assert_array_equal(hist2, hist)
    np.testing.assert_array_equal(mom2, mom)

    t_ss, t_len = torch.from_numpy(ss), torch.from_numpy(
        lengths.astype(np.int32))
    if kind == "b3":
        hist_p, mom_p = stream_metrics_plain(t_ss, t_len, buckets)
        got, want = mom[:, ::2], mom_p.numpy()
        h_j, m_j = _pallas_metrics(local, lengths, buckets, None)
    else:
        hist_p, mom_p = stream_metrics_carry_plain(
            t_ss, t_len, buckets, torch.from_numpy(mcar), base)
        got, want = mom, mom_p.numpy()
        h_j, m_j = _pallas_metrics(local, lengths, buckets, mcar)
    np.testing.assert_array_equal(hist, hist_p.numpy())
    np.testing.assert_array_equal(hist, h_j)
    for ref in (want, m_j):
        _assert_moments(np.asarray(got)[:, ::2] if got.shape[1] == 4
                        else got, np.asarray(ref)[:, ::2]
                        if np.asarray(ref).shape[1] == 4 else ref)
    if kind == "b6_zero":                 # B3 on the rebased stamps
        h3, m3 = _metrics_fused_model(local, lengths, buckets, zero, 0,
                                      ws=_MetricsWorkspace(), seed=seed + 2)
        np.testing.assert_array_equal(hist, h3)
        np.testing.assert_array_equal(mom[:, ::2], m3[:, ::2])


def test_workspace_grows_counters_zeroed_and_keeps_the_epoch():
    """The per-stream workspace B3/B6 share with the look-back kernels:
    more counters than it holds are allocated zeroed, and the epoch moves
    on by one a call whatever grows."""
    from repro_torch.kernels._build import LookbackWorkspace
    ws = LookbackWorkspace(torch.device("cpu"), max_epoch=3)
    words, counters, e1 = ws.take(4)
    assert counters.numel() == 1 and words.numel() == 4
    counters[0] = 7                       # a kernel left it non-zero
    words, counters, e2 = ws.take(2, n_counters=5)
    assert counters.numel() >= 5 and int(counters.abs().sum()) == 0
    assert words.numel() == 4 and (e1, e2) == (1, 2)
    words[:] = 9
    ws.take(2)
    _, _, e4 = ws.take(1)                 # past max_epoch: words cleared
    assert e4 == 1 and int(ws.words.abs().sum()) == 0


# ----------------------------------------------------- domain guards
class TestDomainGuards:
    def test_keep_rule_overflow_refused_by_both(self):
        t = np.full(100_000, 1.5e9)                   # one huge bucket
        for mod in (jops, tops):
            with pytest.raises(mod.KeepRuleOverflow):
                mod._nsa_tables(t, 10, 1.0)
        with pytest.raises(tops.KeepRuleOverflow):
            tops.stream_sample_batched([t], 10, 1.0, device=CPU)
        assert issubclass(tops.KeepRuleOverflow, tops.PallasDomainError)
        assert issubclass(tops.PallasDomainError, ValueError)

    def test_max_range_past_snap_limit_refused_by_both(self):
        t = _stream(np.random.default_rng(0), 100)
        for mod in (jops, tops):
            with pytest.raises(mod.PallasDomainError):
                mod._nsa_tables(t, 2 ** 20 + 1, 1.0)

    def test_histogram_domain_refused_by_both(self):
        for mod in (jops, tops):
            mod._check_metrics_domain(2 ** 31 - 1)
            with pytest.raises(mod.PallasDomainError):
                mod._check_metrics_domain(2 ** 31)
        big = torch.empty((1, 2 ** 31), dtype=torch.int32, device="meta")
        with pytest.raises(tops.PallasDomainError):
            tops.stream_metrics_batched_device(big, [1], 10)

    def test_trend_total_refused_by_both(self):
        q = np.ones((1, 8), np.int32)
        for mod, arr in ((jops, jnp.asarray), (tops, torch.from_numpy)):
            with pytest.raises(mod.PallasDomainError):
                mod.trend_corr_pairwise(arr(q), [8], arr(q), [8], 3,
                                        totals=[2 ** 31, 8])


# ------------------------------------------------- devices and options
class TestDeviceRules:
    def test_meta_tensors_are_refused(self):
        t = torch.empty(8, dtype=torch.float64, device="meta")
        i = torch.empty((1, 4), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            stream_sample(t, torch.zeros(1, dtype=torch.int64, device="meta"),
                          t[:1], i, i, i, torch.empty((1, 2), device="meta"),
                          torch.empty(1, dtype=torch.int32, device="meta"), 8)
        with pytest.raises(ValueError):
            compact(torch.empty((1, 8), dtype=torch.bool, device="meta"))

    def test_cuda_without_runtime_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for dev in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="is_available"):
                tops.resolve_device(dev)
        assert tops.resolve_device("cpu") == torch.device("cpu")
        assert tops.device_kind("cpu") == "cpu"
        assert not tops.on_cuda(torch.zeros(1)) and tops.on_cuda("cuda:1")

    @pytest.mark.parametrize("mode", ["cached", "force"])
    def test_autotune_is_not_ported(self, mode, tmp_path):
        # (the name is kept from when tile tuning was not ported): the ops
        # wrappers under a "cached" or "force" tuner give the "off"
        # outputs -- integers exact, moments within 1e-5 -- and an
        # unknown mode raises ValueError at the knob
        from repro_torch.kernels import tuning
        from repro_torch.streamsim.store import StreamStore
        assert not hasattr(tops, "check_autotune")
        rng = np.random.default_rng(5)
        ts = [np.sort(rng.uniform(0.0, 900.0, n)) for n in (700, 2500)]
        q = [rng.integers(0, 9, n) for n in (300, 1800)]

        def run():
            ss, keep, lens = tops.stream_sample_batched(ts, [60, 300], 2.0,
                                                        device=CPU)
            idx, tot = tops.compact_mask_batched(keep)
            hist, mom, _ = tops.stream_metrics_batched(
                [s[k] for s, k in zip(ss, keep)], 300, device=CPU)
            trend, _ = tops.trend_scan_batched(q, 7, device=CPU)
            corr = tops.trend_correlation_batched(q, 7, device=CPU)
            return (ss, keep, idx, tot, hist, trend), mom, corr

        want, mom0, corr0 = run()
        store = StreamStore(tmp_path / "store")
        with tuning.tuner_context(mode, store=store, device=CPU):
            got, mom, corr = run()
        for g, w in zip(got, want):
            assert torch.equal(torch.as_tensor(g), torch.as_tensor(w))
        torch.testing.assert_close(mom, mom0, rtol=1e-5, atol=0.0)
        np.testing.assert_allclose(corr, corr0, rtol=1e-5, atol=1e-6)
        assert store.get_marker(tuning.TUNE_NAMESPACE,
                                tuning.CPU_KIND)["entries"]
        with pytest.raises(ValueError, match="autotune"):
            with tuning.tuner_context("fastest", device=CPU):
                pass  # pragma: no cover


# ------------------------------------------------ pairwise trend corr
class TestTrendCorrPairwise:
    def test_matches_reference_and_f64(self):
        from repro.streamsim.metrics import trend_correlation_from_counts
        rng = np.random.default_rng(8)
        la = np.array([5000, 4000])
        qa = np.zeros((2, 5000), np.int32)
        for i, n in enumerate(la):
            base = 50 + 30 * np.sin(np.linspace(0, 6, n))
            qa[i, :n] = rng.poisson(base)
        lb = np.array([600, 3600, 60, 1])
        qb = np.zeros((4, 3600), np.int32)
        for i, n in enumerate(lb):
            qb[i, :n] = rng.poisson(2 + np.cos(np.linspace(0, 6, n)) ** 2,
                                    n)
        ai = np.array([0, 1, 0, 1])
        r_j = jops.trend_corr_pairwise(jnp.asarray(qa), la, jnp.asarray(qb),
                                       lb, 60, a_index=ai)
        r_t = tops.trend_corr_pairwise(torch.from_numpy(qa), la,
                                       torch.from_numpy(qb), lb, 60,
                                       a_index=ai)
        assert r_t.dtype == np.float64 and r_t.shape == (4,)
        np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-5,
                                   equal_nan=True)
        for p in range(4):
            want = trend_correlation_from_counts(
                qa[ai[p], :la[ai[p]]], qb[p, :lb[p]], 60)
            if np.isnan(want):
                assert np.isnan(r_t[p])
            else:
                assert abs(r_t[p] - want) <= 1e-3

    def test_trend_from_prefix_matches_reference(self):
        rng = np.random.default_rng(9)
        q = rng.integers(0, 50, (3, 300)).astype(np.int32)
        lengths = np.array([300, 120, 7])
        q[1, 120:] = 0
        q[2, 7:] = 0
        w, h = tops._window_tables(lengths, 25)
        ref = jops._trend_from_prefix(
            jnp.cumsum(jnp.asarray(q), axis=1, dtype=jnp.int32),
            jnp.asarray(lengths), jnp.asarray(w), jnp.asarray(h))
        got = tops._trend_from_prefix(
            torch.cumsum(torch.from_numpy(q), 1, dtype=torch.int32),
            torch.from_numpy(lengths), torch.from_numpy(w),
            torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
