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
        rng = np.random.default_rng(3)
        t = _stream(rng, 4000, integer=True)
        for width in (None, 5000):
            a = jops._nsa_tables(t, 3600, 24.0, width)
            b = tops._nsa_tables(t, 3600, 24.0, width)
            for x, y in zip(a[:4], b[:4]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            assert a[4] == b[4]

    def test_plain_version_is_the_cpu_dispatch(self):
        ts = _ragged_batch(5)
        inputs = [torch.from_numpy(x) for x in
                  tops.stream_sample_inputs(ts, RANGES, _mults(ts, RANGES))]
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
        t = torch.empty((1, 8), device="meta")
        i = torch.empty((1, 4), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            stream_sample(t, i, i, i, torch.empty((1, 3), device="meta"),
                          torch.empty(1, dtype=torch.int32, device="meta"))
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
    def test_autotune_is_not_ported(self, mode):
        tops.check_autotune(None)
        tops.check_autotune("off")
        with pytest.raises(NotImplementedError):
            tops.check_autotune(mode)


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
