"""The originals' report statistics from B3's time form.

An NSA leg leaves each original's float64 timestamps on the device for B1;
B3's time form counts them there (``ops.original_metrics``), each record in
bucket ``clip(floor(t - t[0]), 0, tr - 1)``, and the report reads those
rows instead of bucketing the original on the host
(``metrics._bucket_series``) and uploading the stamps for a second B3.

On the CPU the time form runs its plain version. Its counts must equal
``np.bincount`` over ``_bucket_series`` bit for bit, and its moments those
of B3's int32 form on the same histogram. The reports and fidelity matrices
of ``run``, ``run_many`` and the chunked runner must equal what the host
group (``metrics_batched`` over every original) gives, and the span
``report.stats`` says which path served each row.
"""

import numpy as np
import pytest
import torch

import repro_torch.streamsim as T
from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.kernels.metrics_fused import (BUCKET_BLOCKS, stream_metrics,
                                               stream_metrics_time)
from repro_torch.kernels.tuning import TileConfig
from repro_torch.streamsim import engine as tengine
from repro_torch.streamsim.metrics import (_bucket_series,
                                           _volatility_from_moments,
                                           metrics_batched)

CPU = "cpu"
EPOCH = 1.5e9
NINE_DAYS = 9 * 86_400


def _fractions(rng):
    """Epoch-scale times just below and at whole seconds, from a first
    record with a fraction and from the whole epoch seconds around it."""
    t0 = EPOCH + 0.25
    ks = rng.integers(1, 5000, 4000).astype(np.float64)
    whole = np.floor(t0) + ks
    return np.sort(np.concatenate([
        [t0], t0 + ks, np.nextafter(t0 + ks, -np.inf), whole,
        np.nextafter(whole, -np.inf), t0 + ks + 0.999999]))


def _nine_days(rng):
    t = EPOCH + np.sort(rng.uniform(0, NINE_DAYS, 200_000))
    t[0], t[-1] = EPOCH, EPOCH + NINE_DAYS - 0.5
    return t


STREAMS = {
    "fractions": _fractions,
    "all_equal": lambda rng: np.full(5000, EPOCH + 0.3),
    "single": lambda rng: np.array([EPOCH + 0.7]),
    "nine_days": _nine_days,
    "day": lambda rng: EPOCH + np.sort(rng.uniform(0, 86_400, 50_000)),
}

#: the streams of one launch each; ``ragged`` puts three in one, as the grid
CASES = {name: (name,) for name in ("fractions", "all_equal", "single",
                                    "nine_days")}
CASES["ragged"] = ("fractions", "day", "all_equal")


def _uploaded(ts):
    """B1 on ``ts`` (one row a stream) and the sources it left on the CPU,
    as an NSA leg runs it."""
    uploaded = []
    ops.stream_sample_batched(ts, 60, 1.0, device=CPU,
                              on_upload=uploaded.append)
    return uploaded[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_form_counts_are_bincount_of_bucket_series(case):
    rng = np.random.default_rng(7)
    ts = [STREAMS[name](rng) for name in CASES[case]]
    series = [_bucket_series(T.Stream(str(i), t, {}), None, None)
              for i, t in enumerate(ts)]
    width = max(tr for _, tr in series)
    if case == "nine_days":
        assert width == NINE_DAYS
    if case in ("all_equal", "single"):
        assert width == 1
    sources = _uploaded(ts)
    hist, mom = ops.original_metrics(sources, range(len(ts)), width)
    assert hist.dtype == torch.int32 and hist.shape[1] % 512 == 0
    for d, (b, tr) in enumerate(series):
        assert tr == ops.time_series_length(ts[d])
        want = np.bincount(b, minlength=tr)
        np.testing.assert_array_equal(hist[d, :tr].numpy(), want)
        assert not hist[d, tr:].any()
    # the moments of B3's int32 form on the host-built stamps, bit for bit
    ss, lengths, buckets = ops.stream_metrics_inputs([b for b, _ in series],
                                                     width)
    hist32, mom32 = stream_metrics(torch.from_numpy(ss),
                                   torch.from_numpy(lengths), buckets)
    assert torch.equal(hist, hist32)
    assert torch.equal(mom, mom32)
    # and today's report statistics of the originals
    got = metrics_batched([T.Stream(str(i), t, {}) for i, t in enumerate(ts)],
                          [None] * len(ts), backend="torch", device=CPU)
    m = mom.numpy().astype(np.float64)
    for d, (ms, (_, tr)) in enumerate(zip(got, series)):
        np.testing.assert_array_equal(ms.counts, hist[d, :tr].numpy())
        assert ms.volatility == _volatility_from_moments(m[d, 0], m[d, 1],
                                                         tr)


@pytest.mark.parametrize("bucket_block", BUCKET_BLOCKS)
def test_time_form_moments_are_the_int32_forms_at_each_bucket_block(
        bucket_block):
    rng = np.random.default_rng(3)
    ts = [STREAMS["day"](rng), STREAMS["fractions"](rng)]
    series = [_bucket_series(T.Stream("x", t, {}), None, None) for t in ts]
    buckets = ops._padded_buckets(max(tr for _, tr in series), 1024)
    cfg = TileConfig(record_tile=4096, bucket_block=bucket_block)
    src = _uploaded(ts)
    lengths = torch.tensor([len(t) for t in ts], dtype=torch.int32)
    hist, mom = stream_metrics_time(
        src.t, torch.from_numpy(src.first),
        torch.tensor([t[0] for t in ts], dtype=torch.float64), lengths,
        torch.tensor([tr for _, tr in series], dtype=torch.int32), buckets,
        int(lengths.max()), config=cfg)
    ss, lens, _ = ops.stream_metrics_inputs([b for b, _ in series], buckets)
    hist32, mom32 = stream_metrics(torch.from_numpy(ss),
                                   torch.from_numpy(lens), buckets,
                                   config=cfg)
    assert torch.equal(hist, hist32)
    assert torch.equal(mom, mom32)


@pytest.mark.parametrize("t,want", [
    (np.zeros(0), 0), (np.array([EPOCH]), 1),
    (np.array([EPOCH, EPOCH + 86_399.999]), 86_400),
    (np.array([EPOCH, np.inf]), ops.PallasDomainError),
    (np.array([0.0, 2.0 ** 31]), ops.PallasDomainError)],
    ids=["empty", "single", "day", "infinite", "past_int32"])
def test_time_series_length(t, want):
    if isinstance(want, type):
        with pytest.raises(want):
            ops.time_series_length(t)
    else:
        assert ops.time_series_length(t) == want


# ------------------------------------------------------------ the engine
def _drain(queue):
    return {"records_seen": sum(len(b) for b in queue)}


DATASETS = ("traffic", "sogouq")
RANGES = (20, 40)
KW = dict(scale=0.002, seed=5, backend="torch")


def _entry(root, entry, ranges=RANGES):
    """Reports, fidelity matrices and the host group's ``report.stats``
    counts of one entry call on the CPU."""
    ctl = T.Controller(str(root), device=CPU)
    tracing.drain()
    tracing.enable()
    try:
        if entry == "run":
            reps = [ctl.run(DATASETS[0], ranges[0], _drain, **KW)]
            fid = None
        else:
            extra = {"chunked": dict(chunk_s=10),
                     "two_shards": dict(n_devices=2)}.get(entry, {})
            reps = ctl.run_many(DATASETS, ranges, _drain, **KW, **extra)
            fid = [(f.max_range, f.labels, f.trend_corr)
                   for f in ctl.last_fidelity]
    finally:
        tracing.enable(False)
    stats = [r.counts for r in tracing.drain()
             if r.name == "report.stats" and "device_rows" in r.counts]
    assert len(stats) == 1
    return reps, fid, stats[0], ctl.last_result


def _host_group_only(monkeypatch):
    """Every original through the host group's ``metrics_batched``."""
    monkeypatch.setattr(tengine.DeviceSweepResult, "count_originals",
                        lambda *a, **k: None)


def _same(got, want):
    reps, fid = got[:2]
    ref_reps, ref_fid = want[:2]
    assert [(r.dataset, r.max_range) for r in reps] == \
        [(r.dataset, r.max_range) for r in ref_reps]
    for r, ref in zip(reps, ref_reps):
        assert r.original_volatility == ref.original_volatility
        assert r.simulated_volatility == ref.simulated_volatility
        assert r.trend_corr == ref.trend_corr or \
            (np.isnan(r.trend_corr) and np.isnan(ref.trend_corr))
        assert r.simulated_rows == ref.simulated_rows
    if fid is not None:
        np.testing.assert_array_equal(
            np.array([m for _, _, m in fid], np.float64),
            np.array([m for _, _, m in ref_fid], np.float64))
        assert [f[:2] for f in fid] == [f[:2] for f in ref_fid]


@pytest.mark.parametrize("entry", ["run", "run_many", "chunked",
                                   "two_shards"])
def test_reports_and_fidelity_equal_the_host_groups(tmp_path, monkeypatch,
                                                    entry):
    # two shards: a launch each, the rows stacked on the report device
    got = _entry(tmp_path / "device", entry)
    n = 1 if entry == "run" else len(DATASETS)
    assert got[2] == {"rows": n, "device_rows": n, "host_rows": 0}
    assert got[3].mode == "device"
    assert len(got[3]._orig_rows) == (2 if entry == "two_shards" else 1)
    result = got[3]
    counts = {d: result.om[d].counts for d in result.plan.datasets}
    # the host group's path: every original through metrics_batched
    _host_group_only(monkeypatch)
    want = _entry(tmp_path / "host", entry)
    assert want[2] == {"rows": n, "device_rows": 0, "host_rows": n}
    _same(got, want)
    for d, q in counts.items():
        np.testing.assert_array_equal(q, want[3].om[d].counts)
        assert q.dtype == want[3].om[d].counts.dtype


def test_cache_hits_are_host_rows(tmp_path, monkeypatch):
    # the first call stores the sims of RANGES[0]; the second finds them
    # (cache hits) and runs NSA for RANGES[1] only: its originals still
    # come from the device, the cached sims go through metrics_batched
    _entry(tmp_path / "a", "run_many", RANGES[:1])
    got = _entry(tmp_path / "a", "run_many")
    n = len(DATASETS)
    assert got[2] == {"rows": 2 * n, "device_rows": n, "host_rows": n}
    # every scenario cached: no NSA leg, every row through metrics_batched
    again = _entry(tmp_path / "a", "run_many")
    assert again[2] == {"rows": 3 * n, "device_rows": 0, "host_rows": 3 * n}
    for d in DATASETS:
        assert again[3].om[d].volatility == got[3].om[d].volatility
        np.testing.assert_array_equal(again[3].om[d].counts,
                                      got[3].om[d].counts)
    _host_group_only(monkeypatch)
    _entry(tmp_path / "b", "run_many", RANGES[:1])
    _same(got, _entry(tmp_path / "b", "run_many"))


def _spread(root, entry):
    """Reports, merged fidelity matrices and every ``report.stats`` count
    of the host group over a whole grid served by a one-process sweep
    service (batches of one scenario) or by two static hosts run
    alternately until the grid is covered; with the cache hits each run
    of the hosts found, with the originals of datasets it reports only
    from cache hits (its host rows)."""
    tracing.drain()
    tracing.enable()
    host_rows, reps = [], {}
    try:
        if entry == "service":
            ctl = T.Controller(str(root), device=CPU)
            for r in ctl.run_many(DATASETS, RANGES, _drain, service=True,
                                  service_poll_s=0.05, **KW):
                reps[(r.dataset, r.max_range)] = r
        else:
            for i in range(4):
                ctl = T.Controller(str(root), device=CPU)
                for r in ctl.run_many(DATASETS, RANGES, _drain, n_devices=1,
                                      host_index=i % 2, n_hosts=2, **KW):
                    reps[(r.dataset, r.max_range)] = r
                plan = ctl.last_result.plan
                hits = {s.dataset for s in plan.cached}
                host_rows.append(len(plan.cached) + len(
                    hits - {s.dataset for s in plan.local_missing}))
                if len(reps) == len(DATASETS) * len(RANGES):
                    break
    finally:
        tracing.enable(False)
    stats = [r.counts for r in tracing.drain()
             if r.name == "report.stats" and "device_rows" in r.counts]
    fid = [(f.max_range, f.labels, f.trend_corr) for f in ctl.last_fidelity]
    return [reps[k] for k in sorted(reps)], fid, stats, host_rows


@pytest.mark.parametrize("entry", ["service", "two_hosts"])
def test_batches_and_hosts_count_only_the_originals_they_report(
        tmp_path, monkeypatch, entry):
    # a service batch of one scenario, or one static host's run, counts
    # on the device the originals of the datasets it reports and no
    # other: only cache hits go through metrics_batched, and the merged
    # matrices (numpy over the published count rows) equal the host
    # group's bit for bit
    got = _spread(tmp_path / "device", entry)
    stats, host_rows = got[2], got[3]
    if entry == "service":
        assert len(stats) == len(DATASETS) * len(RANGES)
        assert all(s == {"rows": 1, "device_rows": 1, "host_rows": 0}
                   for s in stats)
    else:
        assert [s["host_rows"] for s in stats] == host_rows
        assert all(s["device_rows"] + s["host_rows"] == s["rows"]
                   for s in stats)
        assert host_rows[0] == 0 and stats[0]["device_rows"] > 0
    _host_group_only(monkeypatch)
    want = _spread(tmp_path / "host", entry)
    assert all(s["device_rows"] == 0 for s in want[2])
    _same(got, want)
    assert [f[1] for f in got[1]] == [
        [f"{d}/original" for d in DATASETS] + [f"{d}/sim{mr}"
                                               for d in DATASETS]
        for mr in RANGES]
