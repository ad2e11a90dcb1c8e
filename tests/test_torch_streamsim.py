"""Host substrate and NSA/metrics/replay parity of the PyTorch port
against the JAX package, at small scale on the CPU.

- datasets, POSD and the stream store: byte-equal for the same
  ``(name, scale, seed)``, and stores written by either package read back
  by the other;
- NSA: the port's torch backend (plain kernel versions on ``device="cpu"``)
  is bit-identical to the reference's pallas (interpret mode) and numpy
  paths, including the degenerate shapes and the domain fallback;
- metrics: counts exact, raw moments within 1e-5, volatility within 1e-3;
- replay: the bucket sequence, ``emit_time`` stamps and counters of
  ``replay_one`` under the ``VirtualClock`` equal the reference's.
"""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import repro.streamsim as J
import repro_torch.streamsim as T
from repro.streamsim import engine as jengine
from repro_torch.streamsim import engine as tengine
from repro_torch.streamsim.queue import counts_only

CPU = "cpu"
SMALL = [("sogouq", 0.002, 3), ("traffic", 0.004, 5),
         ("userbehavior", 0.002, 7)]


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _same_stream(a, b):
    assert a.name == b.name
    assert _same_array(a.t, b.t)
    assert (a.scale_stamp is None) == (b.scale_stamp is None)
    if a.scale_stamp is not None:
        assert _same_array(a.scale_stamp, b.scale_stamp)
    assert list(a.payload) == list(b.payload)
    for k in a.payload:
        assert _same_array(a.payload[k], b.payload[k]), k


@pytest.fixture(scope="module")
def originals():
    return {name: (J.preprocess(J.make_stream(name, scale=sc, seed=seed)),
                   T.preprocess(T.make_stream(name, scale=sc, seed=seed)))
            for name, sc, seed in SMALL}


# ------------------------------------------------------ host substrate
@pytest.mark.parametrize("name,scale,seed", SMALL)
def test_datasets_byte_equal(name, scale, seed):
    a = J.make_stream(name, scale=scale, seed=seed)
    b = T.make_stream(name, scale=scale, seed=seed)
    assert a.name == b.name and list(a.columns) == list(b.columns)
    for k in a.columns:
        assert _same_array(a.columns[k], b.columns[k]), k


@pytest.mark.parametrize("name", [n for n, _, _ in SMALL])
def test_preprocess_byte_equal(originals, name):
    _same_stream(*originals[name])


def test_unknown_dataset_raises():
    with pytest.raises(KeyError):
        T.make_stream("nope")


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)])
def test_store_round_trip_across_packages(tmp_path, originals, writer,
                                          reader):
    orig = originals["traffic"][0]
    sim = J.nsa(orig, 60)
    w = writer.StreamStore(tmp_path)
    w.put("traffic__orig", orig, {"scale": 0.004, "seed": 5})
    w.put("traffic__sim60", sim, {"max_range": 60})
    r = reader.StreamStore(tmp_path)
    assert r.list() == ["traffic__orig", "traffic__sim60"]
    _same_stream(r.get("traffic__orig"), orig)
    _same_stream(r.get("traffic__sim60"), sim)
    m = r.manifest("traffic__sim60")
    assert m["rows"] == len(sim) and m["has_scale_stamp"]
    assert m["extra"] == {"max_range": 60}


def test_store_files_have_the_same_layout(tmp_path, originals):
    orig = originals["sogouq"][0]
    J.StreamStore(tmp_path / "j").put("k", orig, {"a": 1})
    T.StreamStore(tmp_path / "t").put("k", orig, {"a": 1})
    for f in ("columns.npz", "manifest.json"):
        assert (tmp_path / "t" / "k" / f).is_file()
    mj = J.StreamStore(tmp_path / "j").manifest("k")
    mt = T.StreamStore(tmp_path / "t").manifest("k")
    mj.pop("written_at"), mt.pop("written_at")
    assert mj == mt
    with np.load(tmp_path / "j" / "k" / "columns.npz") as zj, \
            np.load(tmp_path / "t" / "k" / "columns.npz") as zt:
        assert zj.files == zt.files
        assert all(_same_array(zj[k], zt[k]) for k in zj.files)


# ----------------------------------------------------------------- NSA
@pytest.mark.parametrize("name", [n for n, _, _ in SMALL])
@pytest.mark.parametrize("max_range", [1, 60, 3600])
def test_nsa_bit_identical_to_reference(originals, name, max_range):
    jorig, torig = originals[name]
    want = J.nsa(jorig, max_range, backend="numpy")
    got = T.nsa(torig, max_range, backend="torch", device=CPU)
    _same_stream(got, want)
    _same_stream(T.nsa(torig, max_range, backend="numpy"), want)
    if max_range == 3600:
        _same_stream(got, J.nsa(jorig, max_range, backend="pallas"))


@pytest.mark.parametrize("t", [np.full(300, 1.5e9), np.array([1.5e9]),
                               np.array([1.5e9, 1.5e9 + 7.5])],
                         ids=["zero_span", "single", "two"])
def test_nsa_degenerate_streams(t):
    n = len(t)
    payload = {"x": np.arange(n)}
    js = J.Stream("d", t, dict(payload))
    ts = T.Stream("d", t, dict(payload))
    for mr in (1, 600):
        want = J.nsa(js, mr, backend="pallas")
        _same_stream(T.nsa(ts, mr, backend="torch", device=CPU), want)
        _same_stream(T.nsa_paper(ts, mr), want)


def test_nsa_keep_first_and_records_mode(originals):
    jorig, torig = originals["userbehavior"]
    for kw in ({"keep": "first"}, {"multiple_mode": "records"}):
        _same_stream(T.nsa(torig, 600, backend="torch", device=CPU, **kw),
                     J.nsa(jorig, 600, **kw))


def test_nsa_empty_stream():
    ts = T.Stream("e", np.zeros(0), {"x": np.zeros(0, np.int32)})
    out = T.nsa(ts, 10, backend="torch", device=CPU)
    assert len(out) == 0 and out.scale_stamp.dtype == np.int64


def test_nsa_keep_rule_overflow_falls_back_to_numpy():
    t = np.full(100_000, 1.5e9)
    ts = T.Stream("big", t, {"x": np.arange(len(t))})
    got = T.nsa(ts, 10, backend="torch", device=CPU)
    _same_stream(got, J.nsa(J.Stream("big", t, {"x": np.arange(len(t))}),
                            10, backend="numpy"))


def test_nsa_paper_matches_vectorized(originals):
    torig = originals["traffic"][1]
    _same_stream(T.nsa_paper(torig, 120), T.nsa(torig, 120))


def test_nsa_rejects_bad_arguments(originals):
    torig = originals["traffic"][1]
    with pytest.raises(ValueError):
        T.nsa(torig, 0)
    with pytest.raises(ValueError):
        T.nsa(torig, 10, backend="pallas")
    with pytest.raises(ValueError, match="autotune"):
        T.nsa(torig, 10, backend="torch", device=CPU, autotune="fastest")
    _same_stream(
        T.nsa(torig, 10, backend="torch", device=CPU, autotune="force"),
        T.nsa(torig, 10, backend="numpy"))


def test_scale_stamps_and_helpers_match(originals):
    import repro.streamsim.nsa  # noqa: F401  (the module, not the function)
    import repro_torch.streamsim.nsa  # noqa: F401
    import sys
    jn = sys.modules["repro.streamsim.nsa"]
    tn = sys.modules["repro_torch.streamsim.nsa"]
    jorig, torig = originals["sogouq"]
    assert _same_array(tn.scale_stamps(torig.t, 777),
                       jn.scale_stamps(jorig.t, 777))
    assert tn.compression_factor(torig, 600) == \
        jn.compression_factor(jorig, 600)
    assert tn.expected_kept(torig, 600) == jn.expected_kept(jorig, 600)
    assert tn._resolve_backend("auto") == "torch"


# ------------------------------------------------------------- metrics
def test_metrics_batched_matches_reference(originals):
    jorig, torig = originals["userbehavior"]
    jsims = [J.nsa(jorig, mr) for mr in (60, 600)]
    tsims = [T.nsa(torig, mr) for mr in (60, 600)]
    trs = [None, 60, 900]
    ref_p = J.metrics_batched([jorig] + jsims, trs, backend="pallas")
    ref_n = J.metrics_batched([jorig] + jsims, trs, backend="numpy")
    got = T.metrics_batched([torig] + tsims, trs, backend="torch",
                            device=CPU)
    got_n = T.metrics_batched([torig] + tsims, trs, backend="numpy")
    for g, p, n, gn in zip(got, ref_p, ref_n, got_n):
        assert np.array_equal(g.counts, n.counts)
        assert g.counts.dtype == np.int64
        assert dataclasses.astuple(gn.volatility) == \
            dataclasses.astuple(n.volatility)
        assert g.volatility.time_range == n.volatility.time_range
        for f in ("average", "variance", "std_variance"):
            x = getattr(g.volatility, f)
            assert x == pytest.approx(getattr(p.volatility, f), rel=1e-5)
            assert x == pytest.approx(getattr(n.volatility, f), rel=1e-3)


def test_per_second_counts_and_volatility(originals):
    jorig, torig = originals["traffic"]
    sim = T.nsa(torig, 300)
    from repro.streamsim.metrics import per_second_counts, volatility
    want = per_second_counts(J.nsa(jorig, 300))
    assert np.array_equal(T.per_second_counts(sim, backend="torch",
                                              device=CPU), want)
    assert np.array_equal(T.per_second_counts(torig), per_second_counts(
        jorig))
    v = T.volatility(sim, backend="torch", device=CPU)
    w = volatility(J.nsa(jorig, 300))
    assert v.average == pytest.approx(w.average, rel=1e-5)
    assert v.std_variance == pytest.approx(w.std_variance, rel=1e-3)


def test_trend_helpers_match():
    from repro.streamsim import metrics as jm
    from repro_torch.streamsim import metrics as tm
    rng = np.random.default_rng(0)
    qa, qb = rng.poisson(30, 5000), rng.poisson(3, 600)
    for w in (1, 60, 10_000):
        assert _same_array(tm.sliding_mean(qa, w), jm.sliding_mean(qa, w))
    assert tm.trend_correlation_from_counts(qa, qb, 60) == \
        jm.trend_correlation_from_counts(qa, qb, 60)


# --------------------------------------------------------------- replay
def _recording_consumer(log):
    def consume(queue):
        for b in queue:
            log.append((b.scale_stamp, b.emit_time, len(b), b.t.tobytes(),
                        {k: v.tobytes() for k, v in b.payload.items()}))
        return {"records_seen": sum(x[2] for x in log)}
    return consume


@pytest.mark.parametrize("max_range,queue_size", [(60, 4), (600, 64)])
def test_replay_one_matches_reference(originals, max_range, queue_size):
    jorig, torig = originals["sogouq"]
    jlog, tlog = [], []
    jm, _ = jengine.replay_one(J.nsa(jorig, max_range),
                               _recording_consumer(jlog), queue_size)
    tm, t_prod = tengine.replay_one(T.nsa(torig, max_range),
                                    _recording_consumer(tlog), queue_size)
    assert tlog == jlog and len(tlog) > 0
    assert counts_only(tm) == jm
    assert t_prod >= 0.0


def test_producer_status_and_clock(originals):
    from repro.streamsim.producer import Producer as JP
    sim = T.nsa(originals["traffic"][1], 40)
    q, clock = T.StreamQueue(maxsize=10_000), T.VirtualClock()
    assert T.Producer(sim, q, clock=clock).run() == 0
    jq, jclock = J.StreamQueue(maxsize=10_000), J.VirtualClock()
    assert JP(J.nsa(originals["traffic"][0], 40), jq, clock=jclock).run() \
        == 0
    assert clock.now == jclock.now and counts_only(q.stats()) == jq.stats()


def test_fault_schedules_identical():
    spec = J.FaultSpec(drop_rate=0.2, duplicate_rate=0.1, reorder_rate=0.1)
    tspec = T.FaultSpec(drop_rate=0.2, duplicate_rate=0.1, reorder_rate=0.1)
    ji = J.FaultPlan(4, default=spec).injector(("x", 60))
    ti = T.FaultPlan(4, default=tspec).injector(("x", 60))
    for _ in range(50):
        assert dataclasses.astuple(ti.draw()) == \
            dataclasses.astuple(ji.draw())
    assert ti.stats() == ji.stats()


def test_plan_sweep_matches_reference(tmp_path):
    from repro.streamsim.plan import plan_sweep as jplan
    rows = {"sogouq": 5000, "traffic": 9000}
    a = jplan(J.StreamStore(tmp_path / "j"), list(rows), [60, 600, 3600],
              rows, n_devices=2, host_index=0, n_hosts=1)
    b = T.plan_sweep(T.StreamStore(tmp_path / "t"), list(rows),
                     [60, 600, 3600], rows, n_devices=2, host_index=0,
                     n_hosts=1)
    assert [[s.scenario for s in sh.specs] for sh in a.shards] == \
        [[s.scenario for s in sh.specs] for sh in b.shards]
    assert a.sweep_id == b.sweep_id and a.padded_area() == b.padded_area()
    assert [s.store_key for s in a.scenarios] == \
        [s.store_key for s in b.scenarios]
