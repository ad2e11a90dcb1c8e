"""The port's public API beside the kernels' batched paths, against the
JAX package's: the 1-D ``ops`` wrappers (``stream_sample``,
``stream_sample_ref``, ``compact_mask``, ``bucket_hist``,
``volatility_moments``, ``volatility_stats``), the device predicates, and
``nsa_batched`` / ``nsa_sweep``.

The port runs on ``device="cpu"`` (the kernels' plain PyTorch versions);
the reference's ``ops`` run their Pallas kernels in interpret mode. Inputs
are numpy arrays from seeds. Contracts: stamps, keep bits, kept indices,
totals and histograms bit-equal; moments and the statistics built from
them within 1e-5 relative; simulated streams bit-equal column for column.
"""

import importlib

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import repro.streamsim as J
import repro_torch.streamsim as T
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

jnsa = importlib.import_module("repro.streamsim.nsa")
tnsa = importlib.import_module("repro_torch.streamsim.nsa")

CPU = "cpu"
MOMENT_RTOL = 1e-5


def _stream(rng, n, span=86_400.0, integer=False, t0=1.5e9):
    t = np.sort(rng.uniform(0.0, span, n))
    return t0 + (np.floor(t) if integer else t)


#: 1-D timestamp cases: name -> builder(rng)
STREAMS = {
    "uniform_40k": lambda rng: _stream(rng, 40_000),
    "integer_ties": lambda rng: _stream(rng, 25_000, integer=True),
    "hour_span": lambda rng: _stream(rng, 9_000, span=3600.0),
    "zero_span": lambda rng: np.full(3000, 1.6e9),
    "one_record": lambda rng: np.array([1.7e9]),
    "empty": lambda rng: np.zeros(0),
}


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ stream_sample
@pytest.mark.parametrize("max_range", [60, 600, 3600])
@pytest.mark.parametrize("case", sorted(STREAMS))
@pytest.mark.parametrize("fn", ["stream_sample", "stream_sample_ref"])
def test_stream_sample_bit_equal(fn, case, max_range):
    t = STREAMS[case](np.random.default_rng(3))
    multiple = max(float(t[-1] - t[0]) / max_range, 1.0) if len(t) else 1.0
    ss, keep = getattr(tops, fn)(t, max_range, multiple, device=CPU)
    jss, jkeep = getattr(jops, fn)(t, max_range, multiple)
    assert ss.dtype == torch.int32 and keep.dtype == torch.bool
    assert ss.shape == keep.shape == (len(t),)
    np.testing.assert_array_equal(_host(ss), np.asarray(jss))
    np.testing.assert_array_equal(_host(keep), np.asarray(jkeep))
    if len(t):
        # and the numpy NSA path's stamps
        np.testing.assert_array_equal(_host(ss),
                                      jnsa.scale_stamps(t, max_range))


def test_stream_sample_takes_a_tensor():
    t = _stream(np.random.default_rng(1), 5000)
    a = tops.stream_sample(torch.from_numpy(t), 600, 10.0, device=CPU)
    b = tops.stream_sample(t, 600, 10.0, device=CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("fn", ["stream_sample", "stream_sample_ref"])
def test_stream_sample_domain_guards_are_the_references(fn):
    # max_range past the +-1 snap's limit, and an int32 keep-rule overflow
    # (one bucket of 100k records kept at a third)
    t = _stream(np.random.default_rng(0), 2000)
    with pytest.raises(jops.PallasDomainError):
        getattr(jops, fn)(t, (1 << 20) + 1, 1.0)
    with pytest.raises(tops.PallasDomainError):
        getattr(tops, fn)(t, (1 << 20) + 1, 1.0, device=CPU)
    flat = np.full(100_000, 1.5e9)
    with pytest.raises(jops.KeepRuleOverflow):
        getattr(jops, fn)(flat, 1, 3.0)
    with pytest.raises(tops.KeepRuleOverflow):
        getattr(tops, fn)(flat, 1, 3.0, device=CPU)


# ------------------------------------------------------------- compact_mask
MASKS = {
    "p01": lambda rng: rng.random(30_000) < 0.01,
    "p50": lambda rng: rng.random(30_000) < 0.5,
    "p99": lambda rng: rng.random(30_000) < 0.99,
    "all_false": lambda rng: np.zeros(5000, bool),
    "all_true": lambda rng: np.ones(4096, bool),
    "n1003": lambda rng: rng.random(1003) < 0.3,
    "one": lambda rng: np.ones(1, bool),
    "empty": lambda rng: np.zeros(0, bool),
}


@pytest.mark.parametrize("case", sorted(MASKS))
def test_compact_mask_bit_equal(case):
    mask = MASKS[case](np.random.default_rng(5))
    idx, total = tops.compact_mask(mask, device=CPU)
    jidx, jtotal = jops.compact_mask(mask)
    assert isinstance(total, int) and total == int(jtotal) == mask.sum()
    assert idx.dtype == torch.int32 and idx.shape == (len(mask),)
    np.testing.assert_array_equal(_host(idx), np.asarray(jidx))
    np.testing.assert_array_equal(_host(idx)[:total], np.flatnonzero(mask))
    assert (_host(idx)[total:] == len(mask)).all()


def test_compact_mask_of_a_tensor_stays_on_its_device():
    mask = torch.from_numpy(np.random.default_rng(2).random(2000) < 0.4)
    idx, total = tops.compact_mask(mask)          # device=None: the mask's
    assert idx.device == mask.device and total == int(mask.sum())
    idx01, _ = tops.compact_mask(mask.to(torch.int32))   # a 0-1 mask
    assert torch.equal(idx01, idx)


# -------------------------------------------------------------- bucket_hist
@pytest.mark.parametrize("max_range,n", [(60, 20_000), (3600, 50_000),
                                         (86_400, 30_000), (600, 1),
                                         (600, 0)])
def test_bucket_hist_bit_equal(max_range, n):
    rng = np.random.default_rng(max_range + n)
    ss = np.sort(rng.integers(0, max_range, n))
    h = tops.bucket_hist(ss, max_range, device=CPU)
    assert h.dtype == torch.int32 and h.shape == (max_range,)
    np.testing.assert_array_equal(_host(h), np.asarray(
        jops.bucket_hist(ss, max_range)))
    np.testing.assert_array_equal(_host(h),
                                  np.bincount(ss, minlength=max_range))


def test_bucket_hist_unsorted_and_guards():
    rng = np.random.default_rng(8)
    ss = rng.integers(0, 2048, 10_000)          # unsorted latency bins
    np.testing.assert_array_equal(
        _host(tops.bucket_hist(ss, 2048, device=CPU)),
        np.asarray(jops.bucket_hist(ss, 2048)))
    for bad in (np.array([0, 600]), np.array([-1, 3])):
        with pytest.raises(ValueError):
            jops.bucket_hist(bad, 600)
        with pytest.raises(ValueError):
            tops.bucket_hist(bad, 600, device=CPU)


# --------------------------------------------------------------- volatility
SERIES = {
    "day_counts": lambda rng: rng.poisson(120.0, 86_400),
    "bursty": lambda rng: (rng.random(3600) < 0.05) * rng.integers(
        0, 10_000, 3600),
    "constant": lambda rng: np.full(600, 7),
    "one": lambda rng: np.array([42]),
}


@pytest.mark.parametrize("case", sorted(SERIES))
def test_volatility_moments_and_stats(case):
    q = SERIES[case](np.random.default_rng(11))
    s, s2 = tops.volatility_moments(q, device=CPU)
    js, js2 = jops.volatility_moments(q)
    assert s.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose([float(s), float(s2)],
                               [float(js), float(js2)], rtol=MOMENT_RTOL)
    q64 = q.astype(np.float64)
    np.testing.assert_allclose([float(s), float(s2)],
                               [q64.sum(), (q64 * q64).sum()],
                               rtol=MOMENT_RTOL)
    got = [float(x) for x in tops.volatility_stats(q, device=CPU)]
    want = [float(x) for x in jops.volatility_stats(q)]
    np.testing.assert_allclose(got, want, rtol=MOMENT_RTOL, atol=1e-6)
    var64 = q64.var()
    np.testing.assert_allclose(got[:2], [q64.mean(), var64],
                               rtol=1e-4, atol=1e-3)


def test_volatility_of_an_empty_series_is_nan_as_in_the_reference():
    got = [float(x) for x in tops.volatility_stats(np.zeros(0), device=CPU)]
    want = [float(x) for x in jops.volatility_stats(np.zeros(0))]
    assert np.isnan(got).all() and np.isnan(want).all()


# --------------------------------------------------------------- predicates
def test_predicates_and_public_names():
    assert tops.on_tpu() is False
    assert tops.on_gpu() == tops.on_accelerator() == \
        torch.cuda.is_available()
    missing = [n for n in jops.__all__ if not hasattr(tops, n)]
    assert not missing, missing
    assert set(jops.__all__) <= set(tops.__all__)


def test_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = _stream(np.random.default_rng(0), 100)
    for call in (lambda: tops.stream_sample(t, 60, 2.0),
                 lambda: tops.stream_sample_ref(t, 60, 2.0),
                 lambda: tops.compact_mask(np.ones(5, bool)),
                 lambda: tops.bucket_hist(np.arange(5), 10),
                 lambda: tops.volatility_stats(np.arange(5)),
                 lambda: T.nsa_batched({"a": T.Stream("a", t, {})}, 60),
                 lambda: T.nsa_sweep({"a": T.Stream("a", t, {})}, [60])):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


# ------------------------------------------------------ nsa_batched / sweep
@pytest.fixture(scope="module")
def originals():
    return {d: J.preprocess(J.make_stream(d, scale=0.01, seed=4))
            for d in ("sogouq", "traffic", "userbehavior")}


def _port(stream):
    return T.Stream(stream.name, stream.t, dict(stream.payload),
                    stream.scale_stamp)


def _same_stream(a, b):
    assert a.name == b.name
    cols_a = {"t": a.t, "ss": a.scale_stamp, **a.payload}
    cols_b = {"t": b.t, "ss": b.scale_stamp, **b.payload}
    assert cols_a.keys() == cols_b.keys()
    for k in cols_a:
        assert cols_a[k].dtype == cols_b[k].dtype, k
        assert cols_a[k].tobytes() == cols_b[k].tobytes(), k


@pytest.mark.parametrize("max_range", [60, 600, 3600])
def test_nsa_batched_bit_equal(originals, max_range):
    got = T.nsa_batched({k: _port(s) for k, s in originals.items()},
                        max_range, backend="torch", device=CPU)
    want = J.nsa_batched(originals, max_range, backend="numpy")
    assert list(got) == list(want)
    for k in want:
        _same_stream(got[k], want[k])


def test_nsa_sweep_bit_equal(originals):
    streams = {k: _port(s) for k, s in originals.items()}
    ranges = (600, 1200, 1800, 2400, 3000, 3600)
    got = T.nsa_sweep(streams, ranges, backend="torch", device=CPU)
    want = J.nsa_sweep(originals, ranges, backend="numpy")
    assert list(got) == list(want) and len(got) == 18
    for k in want:
        _same_stream(got[k], want[k])
    pairs = [("traffic", 45), ("sogouq", 3600), ("traffic", 1)]
    got = T.nsa_sweep(streams, (), pairs=pairs, backend="torch",
                      device=CPU)
    want = J.nsa_sweep(originals, (), pairs=pairs, backend="numpy")
    assert list(got) == list(want) == pairs
    for k in want:
        _same_stream(got[k], want[k])


@pytest.mark.parametrize("odd", ["keep_rule_overflow", "empty"])
def test_nsa_batched_and_sweep_fall_back_to_numpy_wholesale(
        originals, monkeypatch, odd):
    # a zero-span stream of 100k records keeps every record of its one
    # bucket: (c - 1) * k overflows int32, so the batch runs on numpy, as
    # the reference's does; an empty stream does the same
    n = 100_000 if odd == "keep_rule_overflow" else 0
    extra = J.Stream("odd", np.full(n, 1.5e9),
                     {"v": np.arange(n, dtype=np.int64)})
    src = dict(originals, odd=extra)
    streams = {k: _port(s) for k, s in src.items()}
    device_legs = []
    real = tnsa.nsa_sweep_device

    def spy(*a, **kw):
        device_legs.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tnsa, "nsa_sweep_device", spy)
    got_b = T.nsa_batched(streams, 600, backend="torch", device=CPU)
    got_s = T.nsa_sweep(streams, [60, 600], backend="torch", device=CPU)
    if odd == "empty":
        assert device_legs == []                    # never dispatched
    want_b = J.nsa_batched(src, 600, backend="numpy")
    want_s = J.nsa_sweep(src, [60, 600], backend="numpy")
    for k in want_b:
        _same_stream(got_b[k], want_b[k])
    for k in want_s:
        _same_stream(got_s[k], want_s[k])
    if odd == "keep_rule_overflow":
        with pytest.raises(tops.KeepRuleOverflow):
            tops.stream_sample_batched([extra.t], 600, 1.0, device=CPU)


def test_nsa_batched_numpy_backend_and_guards(originals):
    streams = {k: _port(s) for k, s in originals.items()}
    got = T.nsa_batched(streams, 300, backend="numpy")
    for k, s in streams.items():
        _same_stream(got[k], T.nsa(s, 300, backend="numpy"))
    assert T.nsa_batched({}, 60, device=CPU) == {}
    with pytest.raises(ValueError):
        T.nsa_batched(streams, 0, device=CPU)
    with pytest.raises(ValueError):
        T.nsa_sweep(streams, [60, -1], device=CPU)
    # every autotune mode gives the "off" sweep; an unknown one raises
    off = T.nsa_sweep(streams, [60], device=CPU)
    cached = T.nsa_sweep(streams, [60], device=CPU, autotune="cached")
    forced = T.nsa_batched(streams, 60, device=CPU, autotune="force")
    for k in streams:
        _same_stream(cached[(k, 60)], off[(k, 60)])
        _same_stream(forced[k], off[(k, 60)])
    with pytest.raises(ValueError, match="autotune"):
        T.nsa_sweep(streams, [60], device=CPU, autotune="fastest")
