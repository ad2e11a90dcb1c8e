"""Parity of the port's trend chain (kernels B4 ``trend_scan`` and B5
``pair_stats``, the trend ops and the S×S correlation metrics) with the JAX
package, on the CPU.

The port's wrappers run their plain PyTorch versions on CPU tensors; the
JAX side runs ``repro.kernels.ops``, whose Pallas kernels execute in
interpret mode off the TPU. Inputs come from numpy seeds and reach both
packages as numpy arrays.

Contracts: prefix sums exact; trends exact or within 1 ulp (int32 window
sums, one f32 divide); Gram matrices within 1e-4 relative of JAX's f32
product (the port's oracle is float64); correlation matrices within 1e-4
of JAX and 1e-3 of the float64 numpy mirror; the same NaN rows; the same
``PallasDomainError`` and ``ValueError`` on the same inputs.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.streamsim.metrics as jmetrics
import repro_torch.streamsim.metrics as tmetrics
from repro.kernels import ops as jops
from repro.kernels.trend_scan import (pair_stats_pallas,
                                     trend_scan_carry_pallas,
                                     trend_scan_pallas)
from repro_torch.kernels import ops as tops
from repro_torch.kernels.trend_scan import (pair_plan, pair_stats,
                                            pair_stats_plain,
                                            trend_scan,
                                            trend_scan_carry_plain,
                                            trend_scan_plain)

CPU = "cpu"


def _counts(n, seed=0, lam=25.0):
    return np.random.default_rng(seed).poisson(lam, n).astype(np.int64)


def _ragged(seed=0):
    return [_counts(n, seed=seed + n) for n in (3600, 0, 1, 1023, 1025,
                                                 2048, 600)]


def _nan_equal(a, b):
    return np.array_equal(np.isnan(a), np.isnan(b))


# ------------------------------------------------------------------ B4
class TestTrendScanKernel:
    @pytest.mark.parametrize("S,n", [(1, 1024), (3, 2048), (6, 5120),
                                     (2, 1000)])
    def test_plain_matches_pallas_and_cumsum(self, S, n):
        q = np.random.default_rng(S * 7 + n).integers(
            0, 5000, (S, n)).astype(np.int32)
        got = trend_scan(torch.from_numpy(q))
        assert got.dtype == torch.int32 and tuple(got.shape) == (S, n)
        np.testing.assert_array_equal(got.numpy(), np.cumsum(q, axis=1))
        if n % 1024 == 0:
            want = trend_scan_pallas(jnp.asarray(q), interpret=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_near_int32_limit_exact(self):
        # a week of seconds at 3550 records/s: the total sits just under
        # 2**31 - 1, every partial sum must stay exact
        q = np.full((1, 604_800), 3550, np.int32)
        got = trend_scan_plain(torch.from_numpy(q)).numpy()
        assert int(got[0, -1]) == 604_800 * 3550 < 2 ** 31 - 1
        np.testing.assert_array_equal(got[0], np.cumsum(q[0],
                                                        dtype=np.int64))

    def test_carry_resets_between_rows(self):
        q = torch.ones((2, 2048), dtype=torch.int32)
        np.testing.assert_array_equal(trend_scan(q)[1].numpy(),
                                      np.arange(1, 2049))

    def test_cpu_tensor_counts_no_launch(self):
        before = trend_scan.launches
        trend_scan(torch.zeros((2, 1024), dtype=torch.int32))
        assert trend_scan.launches == before

    def test_other_device_raises(self):
        with pytest.raises(ValueError, match="cuda or cpu"):
            trend_scan(torch.zeros((1, 1024), dtype=torch.int32,
                                   device="meta"))


# ------------------------------------------------------------------ B5
class TestPairStatsKernel:
    @pytest.mark.parametrize("S,k", [(1, 512), (2, 1024), (6, 1536),
                                     (5, 100)])
    def test_plain_matches_pallas(self, S, k):
        x = np.random.default_rng(S + k).normal(0, 3, (S, k)) \
            .astype(np.float32)
        sums, gram = pair_stats(torch.from_numpy(x))
        assert sums.dtype == gram.dtype == torch.float32
        assert tuple(sums.shape) == (S, 1) and tuple(gram.shape) == (S, S)
        x64 = x.astype(np.float64)
        np.testing.assert_array_equal(
            gram.numpy(), (x64 @ x64.T).astype(np.float32))
        np.testing.assert_array_equal(
            sums.numpy(), x64.sum(1, keepdims=True).astype(np.float32))
        if k % 512 == 0:
            s_j, g_j = pair_stats_pallas(jnp.asarray(x), interpret=True)
            scale = np.sqrt(np.outer(np.diag(x64 @ x64.T),
                                     np.diag(x64 @ x64.T)))
            assert (np.abs(gram.numpy() - np.asarray(g_j))
                    <= 1e-4 * scale + 1e-6).all()
            np.testing.assert_allclose(sums.numpy(), np.asarray(s_j),
                                       rtol=1e-4, atol=1e-3)

    def test_plain_is_float64_oracle(self):
        # cancellation that f32 accumulation would get wrong
        x = torch.tensor([[1e4, 1.0, -1e4]], dtype=torch.float32)
        sums, gram = pair_stats_plain(x)
        assert float(sums[0, 0]) == 1.0
        assert float(gram[0, 0]) == np.float32(2e8 + 1.0)

    def test_other_device_raises(self):
        with pytest.raises(ValueError, match="cuda or cpu"):
            pair_stats(torch.zeros((2, 512), device="meta"))


# --------------------------------------------------------------- trend ops
class TestTrendOps:
    def test_batched_trends_match_jax(self):
        qs = _ragged(1)
        got, lens = tops.trend_scan_batched(qs, 60, device=CPU)
        want, lens_j = jops.trend_scan_batched(qs, 60)
        assert np.array_equal(lens, lens_j)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=1)

    @pytest.mark.parametrize("n,w", [(0, 5), (1, 1), (1, 600), (10, 4),
                                     (7, 7), (5000, 60)])
    def test_single_series_matches_jax_and_host(self, n, w):
        q = _counts(n, seed=n * 100 + w)
        got = tops.trend_scan(q, w, device=CPU).numpy()
        want = np.asarray(jops.trend_scan(q, w))
        assert got.shape == want.shape
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        np.testing.assert_allclose(
            got, tmetrics.sliding_mean(q.astype(np.float64), w),
            rtol=1e-3, atol=1e-5)

    @pytest.mark.parametrize("width", [0, 1000, 2048, 3601])
    def test_device_form_matches_jax(self, width):
        rng = np.random.default_rng(width)
        lens = np.minimum([width, width // 2, 1], width)
        q = np.zeros((3, width), np.int32)
        for s, n in enumerate(lens):
            q[s, :n] = rng.poisson(9, n)
        totals = q.sum(1)
        got, lg = tops.trend_scan_batched_device(torch.from_numpy(q), lens,
                                                 30, totals=totals)
        want, lw = jops.trend_scan_batched_device(jnp.asarray(q), lens, 30,
                                                  totals=totals)
        assert np.array_equal(lg, lw)
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=1)

    def test_pair_stats_op_pads_like_jax(self):
        x = np.random.default_rng(3).normal(0, 1, (4, 700)).astype(np.float32)
        s_t, g_t = tops.trend_pair_stats(x)
        s_j, g_j = jops.trend_pair_stats(jnp.asarray(x))
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4,
                                   atol=1e-3)
        with pytest.raises(ValueError):
            tops.trend_pair_stats(np.zeros((0, 5), np.float32))

    @pytest.mark.parametrize("K", [1, 2, 17, 600])
    def test_resample_uniform_matches_reference_formula(self, K):
        # op for op in f32 the port IS the reference formula (numpy below);
        # XLA's CPU compile rewrites the divide into a reciprocal multiply
        # and fuses the lerp, so JAX itself lands a few ulp away
        rng = np.random.default_rng(K)
        x = rng.normal(5, 2, (4, 1024)).astype(np.float32)
        lens = np.array([1024, 600, 2, 1])
        got = tops._resample_uniform(torch.from_numpy(x),
                                     torch.from_numpy(lens), K).numpy()
        f32 = np.float32
        pos = np.arange(K, dtype=f32)[None, :] * (
            (lens.astype(f32)[:, None] - f32(1.0)) / f32(max(K - 1, 1)))
        j = np.clip(np.floor(pos).astype(np.int32), 0,
                    np.maximum(lens[:, None] - 2, 0))
        frac = pos - j.astype(f32)
        j1 = np.minimum(j + 1, np.maximum(lens[:, None] - 1, 0))
        want = np.take_along_axis(x, j, 1) * (f32(1.0) - frac) + \
            np.take_along_axis(x, j1, 1) * frac
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(
            got, np.asarray(jops._resample_uniform(
                jnp.asarray(x), jnp.asarray(lens), K)), rtol=1e-6)


# ------------------------------------------------------- S×S correlation
class TestCorrelationMatrix:
    def _qs(self):
        base = _counts(3600, seed=1)
        return [base, np.roll(base, 600), _counts(1200, seed=2),
                _counts(2400, seed=3)]

    @pytest.mark.parametrize("n_points", [None, 256])
    def test_host_form_matches_jax_and_numpy(self, n_points):
        qs = self._qs()
        got = tops.trend_correlation_batched(qs, 60, n_points, device=CPU)
        want = jops.trend_correlation_batched(qs, 60, n_points)
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_allclose(
            got, tmetrics._corr_matrix_numpy(qs, 60, n_points), atol=1e-3)
        np.testing.assert_array_equal(got, got.T)
        np.testing.assert_array_equal(np.diag(got), np.ones(len(qs)))

    def test_device_form_matches_jax(self):
        qs = self._qs()
        lens = np.array([len(q) for q in qs])
        q = np.zeros((len(qs), lens.max()), np.int32)
        for s, row in enumerate(qs):
            q[s, :len(row)] = row
        totals = q.sum(1)
        got = tops.trend_correlation_batched_device(
            torch.from_numpy(q), lens, 60, totals=totals)
        want = jops.trend_correlation_batched_device(
            jnp.asarray(q), lens, 60, totals=totals)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_empty_and_zero_variance_rows_are_nan(self):
        qs = [_counts(600, seed=5), np.zeros(0, np.int64),
              np.zeros(300, np.int64), _counts(900, seed=6)]
        got = tops.trend_correlation_batched(qs, 60, device=CPU)
        want = np.asarray(jops.trend_correlation_batched(qs, 60))
        host = tmetrics._corr_matrix_numpy(qs, 60, None)
        assert _nan_equal(got, want) and _nan_equal(got, host)
        assert np.isnan(got[1]).all() and np.isnan(got[:, 2]).all()
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert np.isnan(tops.trend_correlation_batched(
            [np.zeros(0, np.int64)] * 2, 5, device=CPU)).all()

    def test_numpy_mirror_equals_reference_mirror(self):
        qs = self._qs() + [np.zeros(0, np.int64)]
        a = tmetrics._corr_matrix_numpy(qs, 60, None)
        b = jmetrics._corr_matrix_numpy(qs, 60, None)
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- guards
_BAD = {
    "negative": ([np.array([1, -2, 3])], 2, None),
    "total": ([np.array([2 ** 31 - 1, 5], np.int64)], 3, None),
    "window": ([np.arange(10)], 0, None),
    "n_points": ([np.arange(10)], 3, 0),
    "no_series": ([], 3, None),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_same_errors_as_reference(case):
    qs, w, n_points = _BAD[case]

    def raised(fn):
        try:
            fn()
        except (ValueError, jops.PallasDomainError,
                tops.PallasDomainError) as e:
            return ("domain" if type(e).__name__ == "PallasDomainError"
                    else type(e).__name__)
        return None

    got = raised(lambda: tops.trend_correlation_batched(qs, w, n_points,
                                                        device=CPU))
    want = raised(lambda: jops.trend_correlation_batched(qs, w, n_points))
    assert got is not None and got == want
    if case != "n_points":
        assert raised(lambda: tops.trend_scan_batched(qs, w, device=CPU)) \
            == raised(lambda: jops.trend_scan_batched(qs, w))


def test_device_form_totals_guard():
    q = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(tops.PallasDomainError):
        tops.trend_scan_batched_device(q, [8], 2, totals=[2 ** 31])
    with pytest.raises(ValueError):
        tops.trend_scan_batched_device(q, [8, 8], 2)
    with pytest.raises(ValueError):
        tops.trend_scan_batched_device(q[0], [8], 2)


# ------------------------------------------------------------ metrics layer
class TestMetricsLayer:
    def test_trend_matches_jax_and_numpy(self, small_stream):
        got = tmetrics.trend(small_stream, 60, backend="torch", device=CPU)
        want = jmetrics.trend(small_stream, 60, backend="pallas")
        host = tmetrics.trend(small_stream, 60, backend="numpy")
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_max_ulp(got.astype(np.float32),
                                        want.astype(np.float32), maxulp=1)
        np.testing.assert_allclose(got, host, rtol=1e-3, atol=1e-5)
        np.testing.assert_array_equal(
            host, jmetrics.trend(small_stream, 60, backend="numpy"))

    def test_trend_correlation_matches_jax(self, small_stream):
        from repro_torch.streamsim import nsa
        sim = nsa(small_stream, 600, backend="numpy")
        got = tmetrics.trend_correlation(small_stream, sim, 60,
                                         backend="torch", device=CPU)
        want = jmetrics.trend_correlation(small_stream, sim, 60,
                                          backend="pallas")
        assert got == pytest.approx(want, abs=1e-4)
        assert got == pytest.approx(tmetrics.trend_correlation(
            small_stream, sim, 60, backend="numpy"), abs=1e-3)

    def test_matrix_falls_back_where_reference_does(self):
        # the domain guard raises in the ops layer; the metrics layer then
        # gives the numpy answer on both backends
        for qs in ([np.array([2 ** 31 - 1, 5, 9], np.int64),
                    _counts(3, seed=8)],
                   [np.array([5, -3, 2, 1]), np.array([1, 2, 3, 4])]):
            got = tmetrics.trend_correlation_matrix(qs, 2, backend="torch",
                                                    device=CPU)
            np.testing.assert_array_equal(
                got, tmetrics.trend_correlation_matrix(qs, 2,
                                                       backend="numpy"))
            np.testing.assert_array_equal(
                got, jmetrics.trend_correlation_matrix(qs, 2,
                                                       backend="pallas"))
        with pytest.raises(ValueError):
            tmetrics.trend_correlation_matrix([_counts(10)], 0, device=CPU)
        with pytest.raises(ValueError, match="autotune"):
            tmetrics.trend_correlation_matrix([_counts(10)], 3, device=CPU,
                                              autotune="fastest")

    def test_torch_path_never_runs_host_cumsum(self, monkeypatch):
        def _boom(*a, **k):
            raise AssertionError("host sliding_mean on the torch path")

        monkeypatch.setattr(tmetrics, "sliding_mean", _boom)
        qs = [_counts(3600, seed=1), _counts(1800, seed=2)]
        m = tmetrics.trend_correlation_matrix(qs, 60, backend="torch",
                                              device=CPU)
        assert np.isfinite(m).all()
        with pytest.raises(AssertionError):
            tmetrics.trend_correlation_matrix(qs, 60, backend="numpy")

    def test_trend_falls_back_when_ops_rejects(self, monkeypatch,
                                               small_stream):
        def _reject(*a, **k):
            raise tops.PallasDomainError("forced for test")

        monkeypatch.setattr(tops, "trend_scan", _reject)
        np.testing.assert_array_equal(
            tmetrics.trend(small_stream, 60, backend="torch", device=CPU),
            tmetrics.trend(small_stream, 60, backend="numpy"))


# ---------------------------------- B4 / B7's look-back scan, on the CPU
# The CUDA kernel cannot run here; its algorithm can. The model below is
# the kernel's single pass: every 2048-entry tile sums its counts (its
# aggregate); tile 0 of a row publishes its inclusive prefix seeded by
# init; every later tile walks back over its predecessors, summing
# aggregates until it meets a published inclusive prefix, and publishes
# its own; the row's last tile gives the tail. Which predecessors have
# published their inclusive prefix when a tile looks back depends on
# timing on the card, so the model draws it at random: the answer must
# not depend on it. All adds in uint32, as in the kernel.
_SCAN_TILE = 2048


def _lookback_model(q, init, seed):
    rng = np.random.default_rng(seed)
    S, n = q.shape
    n_tiles = -(-n // _SCAN_TILE)
    psum = np.zeros((S, n), np.uint32)
    tail = init.astype(np.uint32).copy()
    for r in range(S):
        agg = [q[r, j * _SCAN_TILE:(j + 1) * _SCAN_TILE].astype(
            np.uint32).sum(dtype=np.uint32) for j in range(n_tiles)]
        inclusive = {}
        for j in range(n_tiles):
            prefix = np.uint32(init[r]) if j == 0 else np.uint32(0)
            k = j - 1
            while j > 0:
                if k in inclusive and (k == 0 or rng.random() < 0.5):
                    prefix += inclusive[k]
                    break
                prefix += agg[k]
                k -= 1
            inclusive[j] = prefix + agg[j]
            lo = j * _SCAN_TILE
            block = q[r, lo:lo + _SCAN_TILE].astype(np.uint32)
            psum[r, lo:lo + _SCAN_TILE] = prefix + np.cumsum(block,
                                                             dtype=np.uint32)
        if n_tiles:
            tail[r] = inclusive[n_tiles - 1]
    return psum.view(np.int32), tail.view(np.int32)


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 87_040])
def test_lookback_model_matches_plain_and_pallas(n):
    """The look-back scan, modelled, against B7's plain version and the
    JAX Pallas kernel (interpret mode, the width padded with zeros to its
    1024-entry tiles) bit for bit: seeds 0, random, and one just below
    2^31 minus the row's total; tails included."""
    rng = np.random.default_rng(n)
    q = rng.poisson(9.0, (3, n)).astype(np.int32)
    total = int(q[2].sum())
    init = np.array([0, rng.integers(0, 10 ** 6), 2 ** 31 - 1 - total - 3],
                    np.int32)
    psum, tail = _lookback_model(q, init, seed=n)
    p_t, t_t = trend_scan_carry_plain(torch.from_numpy(q),
                                      torch.from_numpy(init))
    np.testing.assert_array_equal(psum, p_t.numpy())
    np.testing.assert_array_equal(tail, t_t.numpy())
    assert tail[2] == 2 ** 31 - 4
    width = max(-(-n // 1024) * 1024, 1024)
    qj = np.zeros((3, width), np.int32)
    qj[:, :n] = q
    p_j, t_j = trend_scan_carry_pallas(jnp.asarray(qj), jnp.asarray(init),
                                       interpret=True)
    np.testing.assert_array_equal(psum, np.asarray(p_j)[:, :n])
    np.testing.assert_array_equal(tail, np.asarray(t_j))


# ------------------------------------------- B5's tile and split mapping
# The CUDA kernel cannot run here; its index math can. The model below
# follows csrc/pair_stats.cu block by block and thread by thread: the
# (tile, split) grid of pair_plan, each block's staged rows (zero past S)
# and its stages of W columns (zero past the split), each thread's 4 x 4
# micro-tile and k-lane, the butterfly over a micro-tile's lanes and the
# warp-order sum, the partial's layout (16 values a micro-tile, then a
# diagonal tile's row sums), the fold in each cluster of splits (rank
# order) and across the clusters (cluster order), and the tile's write
# (its square or its rectangle and the mirrored one, a lower-half cell
# from the upper micro-tile entry). It computes in float64, so a column
# taken twice or missed shows as an error far above rounding; every cell
# of the Gram matrix and every row sum must be written exactly once.
_PAIR_OUT_TILE = 64       # kTile
_PAIR_STAGE_FLOATS = 8192  # kStageFloats
_PAIR_THREADS = 256       # kThreads
_PAIR_CLUSTER = 8         # kCluster


def _tri_decode(m, n):
    i = 0
    while m >= n - i:
        m -= n - i
        i += 1
    return i, i + m


def _pair_block(x, tile, nt, split, kc):
    """One block's partial: ``(plan, part float64 (psize,))``."""
    S, K = x.shape
    T = _PAIR_OUT_TILE
    ti, tj = _tri_decode(tile, nt)
    diag = ti == tj
    ra = min(T, S - ti * T)
    rb = ra if diag else min(T, S - tj * T)
    ga, gb = -(-ra // 4), -(-rb // 4)
    rows_a = 4 * ga
    n_micro = ga * (ga + 1) // 2 if diag else ga * gb
    n_kl = 1
    while 2 * n_kl * n_micro <= _PAIR_THREADS:
        n_kl *= 2
    R = rows_a if diag else rows_a + 4 * gb
    micros = [_tri_decode(m, ga) if diag else divmod(m, gb)
              for m in range(n_micro)]
    plan = dict(ti=ti, tj=tj, diag=diag, ga=ga, n_micro=n_micro)
    # the staged slab, zero past S (padding rows) and past the split
    lo, hi = split * kc, min(K, split * kc + kc)
    length = max(hi - lo, 0)
    slab = np.zeros((R, length))
    for r in range(R):
        row = (ti * T + r if r < ra else -1) if r < rows_a else \
            (tj * T + r - rows_a if r - rows_a < rb else -1)
        if row >= 0:
            slab[r] = x[row, lo:hi]
    # the columns each k-lane takes, stage by stage
    quantum = 4 * n_kl
    w_max = max(1, _PAIR_STAGE_FLOATS // (R * quantum)) * quantum
    assert R * (w_max + 4) <= _PAIR_STAGE_FLOATS + 4 * 2 * T
    n_st = -(-length // w_max)
    W = -(-(-(-length // n_st)) // quantum) * quantum if n_st else quantum
    assert W <= w_max and W % quantum == 0
    take = np.zeros((n_kl, length))
    for t in range(n_st):
        for kl in range(n_kl):
            for i in range(W // quantum):
                c = t * W + 4 * (kl + n_kl * i)
                take[kl, c:min(c + 4, length)] += 1
    # each thread's 16 products and 4 row sums
    v = np.zeros((_PAIR_THREADS, 20))
    for t in range(_PAIR_THREADS):
        m, kl = divmod(t, n_kl)
        if m >= n_micro:
            continue
        ma, mb = micros[m]
        rb0 = 4 * mb if diag else rows_a + 4 * mb
        a = slab[4 * ma:4 * ma + 4] * take[kl]
        v[t, :16] = (a @ slab[rb0:rb0 + 4].T).reshape(16)
        if diag and ma == mb:
            v[t, 16:] = a.sum(axis=1)
    # butterfly within the warp, then the warps of a micro-tile in order
    lanes = np.arange(_PAIR_THREADS)
    o = 1
    while o < min(n_kl, 32):
        v = v + v[lanes ^ o]
        o *= 2
    nw = max(1, n_kl // 32)
    red = {}
    for t in range(_PAIR_THREADS):
        m, kl = divmod(t, n_kl)
        if m < n_micro and kl % 32 == 0:
            red[m, kl // 32] = v[t]
    part = []
    for m in range(n_micro):
        tot = red[m, 0].copy()
        for w in range(1, nw):
            tot += red[m, w]
        part.append(tot)
    vals = [part[m][i] for m in range(n_micro) for i in range(16)]
    if diag:
        vals += [part[ga * g - g * (g - 1) // 2][16 + r]
                 for g in range(ga) for r in range(4)]
    plan["micros"] = micros
    return plan, np.array(vals)


def _pair_model(x, max_clusters):
    """Every block of one call, folded and written as the kernel does:
    ``(sums, gram, writes per cell, writes per row sum)``."""
    S, K = x.shape
    T = _PAIR_OUT_TILE
    kc, n, pstride, tiles = pair_plan(S, K, max_clusters, T, _PAIR_CLUSTER)
    nt = -(-S // T)
    assert tiles == nt * (nt + 1) // 2
    assert n % _PAIR_CLUSTER == 0 and kc % 4 == 0 and kc * n >= K
    sums = np.full(S, np.nan)
    gram = np.full((S, S), np.nan)
    cell_writes = np.zeros((S, S), int)
    sum_writes = np.zeros(S, int)

    def write_tile(pl, part):
        ti, tj, ga = pl["ti"], pl["tj"], pl["ga"]
        ra = min(T, S - ti * T)
        cols = ra if pl["diag"] else min(T, S - tj * T)
        gb = -(-cols // 4)
        index = {mm: m for m, mm in enumerate(pl["micros"])}
        for a in range(ra):
            for b in range(cols):
                g0, g1, r, s = a // 4, b // 4, a % 4, b % 4
                if pl["diag"] and (g0 > g1 or (g0 == g1 and r > s)):
                    g0, g1, r, s = g1, g0, s, r
                m = index[g0, g1] if pl["diag"] else g0 * gb + g1
                assert m == index[g0, g1]
                v = part[16 * m + 4 * r + s]
                cells = [(ti * T + a, tj * T + b)]
                if not pl["diag"]:
                    cells.append((tj * T + b, ti * T + a))
                for cell in cells:
                    gram[cell] = v
                    cell_writes[cell] += 1
        if pl["diag"]:
            for a in range(ra):
                sums[ti * T + a] = part[16 * pl["n_micro"] + a]
                sum_writes[ti * T + a] += 1

    for tile in range(tiles):
        blocks = [_pair_block(x, tile, nt, s, kc) for s in range(n)]
        pl = blocks[0][0]
        psize = len(blocks[0][1])
        assert psize <= pstride
        cluster_sums = []
        for c in range(0, n, _PAIR_CLUSTER):
            tot = blocks[c][1].copy()
            for r in range(1, _PAIR_CLUSTER):
                tot += blocks[c + r][1]
            cluster_sums.append(tot)
        tot = cluster_sums[0].copy()
        for other in cluster_sums[1:]:
            tot += other
        write_tile(pl, tot)
    return sums, gram, cell_writes, sum_writes


@pytest.mark.parametrize("S,K,max_clusters", [
    (1, 0, 32), (1, 1, 32), (2, 1024, 32), (2, 4096, 32), (2, 87_040, 32),
    (6, 4096, 32), (6, 87_040, 32), (37, 1025, 32), (37, 4096, 32),
    (37, 86_528, 32), (64, 4096, 32), (65, 4096, 32), (130, 1025, 4),
    (130, 4096, 32)])
def test_pair_stats_model_matches_plain_and_pallas(S, K, max_clusters):
    """B5's one-launch mapping, modelled: every (a, b) with a <= b gets
    every column exactly once, every cell of the Gram matrix and every row
    sum is written once;
    the result equals the float64 product and, within B5's tolerance,
    the plain version and the JAX Pallas kernel (interpret mode, where K
    is a multiple of its 512-wide tile)."""
    x = np.random.default_rng(S * 1000 + K).normal(0.0, 2.0, (S, K))
    x = x.astype(np.float32)
    sums, gram, cell_writes, sum_writes = _pair_model(
        x.astype(np.float64), max_clusters)
    np.testing.assert_array_equal(cell_writes, np.ones((S, S), int))
    np.testing.assert_array_equal(sum_writes, np.ones(S, int))
    x64 = x.astype(np.float64)
    g64 = x64 @ x64.T
    scale = np.sqrt(np.outer(np.diag(g64), np.diag(g64))) + 1e-30
    assert (np.abs(gram - g64) <= 1e-12 * scale).all()
    np.testing.assert_allclose(sums, x64.sum(1), rtol=0,
                               atol=1e-9 * max(1.0, np.sqrt(K)))
    s_p, g_p = pair_stats(torch.from_numpy(x))
    assert (np.abs(g_p.numpy() - gram) <= 1e-4 * scale).all()
    if K and K % 512 == 0:
        s_j, g_j = pair_stats_pallas(jnp.asarray(x), interpret=True)
        assert (np.abs(np.asarray(g_j) - gram) <= 1e-4 * scale).all()
        np.testing.assert_allclose(np.asarray(s_j)[:, 0], sums, rtol=1e-4,
                                   atol=1e-3 * max(1.0, np.sqrt(K)))
