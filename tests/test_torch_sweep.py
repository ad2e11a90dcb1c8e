"""End-to-end parity of the port's ``Controller.run_many`` (the paper's
dataset × time-range sweep with its Fig.-6 fidelity matrices) with the JAX
package's, on the CPU at small scale, plus the batched replay it runs on.

The port runs ``backend="torch", device="cpu"`` (the kernels' plain
PyTorch versions); the reference runs ``backend="pallas"`` (interpret
mode) and ``backend="numpy"``. Rows, compression, stored simulated
streams, count rows and every scenario's consumer, queue and producer
stats must be exact; simulated volatility within 1e-5 of the pallas run
and 1e-3 of numpy; trend correlations and fidelity matrices within 1e-4
of pallas and 1e-3 of numpy, with the same labels and NaN pattern.
Replay tests on a real clock assert bucket order and counts only.
"""

import dataclasses
import json
import threading

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import repro.streamsim as J
import repro_torch.streamsim as T
from repro_torch.streamsim import engine as tengine
from repro_torch.streamsim.queue import counts_only

CPU = "cpu"
DATASETS = ("sogouq", "traffic", "userbehavior")
RANGES = (20, 40, 60)
SCALE, SEED = 0.002, 0
ONE_HOST = dict(n_devices=1, host_index=0, n_hosts=1)


class _Consumer:
    """Thread-safe per-scenario consumer: drains its queue and records the
    stamps it saw under the scenario's max_range (the last stamp + 1)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seen = {}

    def __call__(self, queue):
        buckets = list(queue)
        n = sum(len(b) for b in buckets)
        if buckets:
            with self.lock:
                self.seen[buckets[-1].scale_stamp + 1] = \
                    self.seen.get(buckets[-1].scale_stamp + 1, 0) + n
        return {"records_seen": n}


def _drain(queue):
    return {"records_seen": sum(len(b) for b in queue)}


def _stored_equal(a_dir, b_dir, key, a_mod=T, b_mod=J):
    a = a_mod.StreamStore(a_dir).get(key)
    b = b_mod.StreamStore(b_dir).get(key)
    cols_a = {"t": a.t, "ss": a.scale_stamp, **a.payload}
    cols_b = {"t": b.t, "ss": b.scale_stamp, **b.payload}
    assert list(cols_a) == list(cols_b)
    for k in cols_a:
        assert cols_a[k].dtype == cols_b[k].dtype, k
        assert cols_a[k].tobytes() == cols_b[k].tobytes(), k


def _matrix(fr):
    return np.array([[np.nan if v is None else v for v in row]
                     for row in fr["trend_corr"]], float) \
        if isinstance(fr, dict) else np.asarray(fr.trend_corr, float)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    kw = dict(scale=SCALE, seed=SEED)
    out = {"root": root}
    port = T.Controller(str(root / "torch"), device=CPU)
    out["torch_consumer"] = _Consumer()
    out["torch"] = port.run_many(DATASETS, RANGES, out["torch_consumer"],
                                 backend="torch", **kw)
    out["port"] = port
    pal = J.Controller(str(root / "pallas"))
    out["pallas"] = pal.run_many(DATASETS, RANGES, _drain, backend="pallas",
                                 **ONE_HOST, **kw)
    out["pal_ctl"] = pal
    num = J.Controller(str(root / "numpy"))
    out["numpy"] = num.run_many(DATASETS, RANGES, _drain, backend="numpy",
                                **kw)
    out["num_ctl"] = num
    pnum = T.Controller(str(root / "port_numpy"))
    out["port_numpy"] = pnum.run_many(DATASETS, RANGES, _drain,
                                      backend="numpy", **kw)
    out["pnum_ctl"] = pnum
    return out


# ------------------------------------------------------------------ reports
def test_grid_order_rows_and_stats_exact(sweeps):
    grid = [(d, mr) for d in DATASETS for mr in RANGES]
    rep = sweeps["torch"]
    assert [(r.dataset, r.max_range) for r in rep] == grid
    assert sweeps["port"].last_result.mode == "device"
    for ref in ("pallas", "numpy"):
        for a, b in zip(rep, sweeps[ref]):
            assert (a.dataset, a.max_range) == (b.dataset, b.max_range)
            assert a.original_rows == b.original_rows
            assert a.simulated_rows == b.simulated_rows
            assert a.compression == b.compression
            # consumer + queue + producer stats, merged per scenario
            assert counts_only(a.consumer_metrics) == b.consumer_metrics
            assert (a.status, a.failure, a.attempts) == ("ok", None, 1)


def test_consumer_saw_every_record(sweeps):
    seen = sweeps["torch_consumer"].seen
    by_range = {}
    for r in sweeps["torch"]:
        assert r.consumer_metrics["records_seen"] == r.simulated_rows
        by_range[r.max_range] = by_range.get(r.max_range, 0) + \
            r.simulated_rows
    # every sim's last stamp is max_range - 1 here, so the consumer's
    # totals per range add up to the reports'
    assert seen == by_range


def test_statistics_within_tolerance(sweeps):
    for a, p, n in zip(sweeps["torch"], sweeps["pallas"], sweeps["numpy"]):
        for f in ("average", "variance", "std_variance"):
            x = getattr(a.simulated_volatility, f)
            assert x == pytest.approx(getattr(p.simulated_volatility, f),
                                      rel=1e-5, abs=1e-12)
            assert x == pytest.approx(getattr(n.simulated_volatility, f),
                                      rel=1e-3, abs=1e-12)
            assert getattr(a.original_volatility, f) == pytest.approx(
                getattr(n.original_volatility, f), rel=1e-3)
        assert abs(a.trend_corr - p.trend_corr) <= 1e-4
        assert abs(a.trend_corr - n.trend_corr) <= 1e-3


def test_port_numpy_equals_reference_numpy(sweeps):
    for a, b in zip(sweeps["port_numpy"], sweeps["numpy"]):
        for f in ("dataset", "max_range", "original_rows", "simulated_rows",
                  "compression", "trend_corr", "status", "attempts"):
            assert getattr(a, f) == getattr(b, f), f
        assert counts_only(a.consumer_metrics) == b.consumer_metrics
        for f in ("original_volatility", "simulated_volatility"):
            assert dataclasses.astuple(getattr(a, f)) == \
                dataclasses.astuple(getattr(b, f)), f
    for fa, fb in zip(sweeps["pnum_ctl"].last_fidelity,
                      sweeps["num_ctl"].last_fidelity):
        assert fa.labels == fb.labels
        np.testing.assert_array_equal(_matrix(fa), _matrix(fb))


@pytest.mark.parametrize("ref", ["pallas", "numpy"])
def test_stored_sims_byte_equal(sweeps, ref):
    root = sweeps["root"]
    for d in DATASETS:
        for mr in RANGES:
            _stored_equal(root / "torch", root / ref, f"{d}__sim{mr}")


def test_count_rows_exact(sweeps):
    got = sweeps["port"].last_result.count_rows()
    want = sweeps["pnum_ctl"].last_result.count_rows()
    assert list(got) == list(want)
    for sc in got:
        assert got[sc].dtype == np.int64
        np.testing.assert_array_equal(got[sc], want[sc])


# ----------------------------------------------------------------- fidelity
def test_fidelity_matrices(sweeps):
    port = sweeps["port"].last_fidelity
    assert [fr.max_range for fr in port] == list(RANGES)
    for ref, tol in (("pal_ctl", 1e-4), ("num_ctl", 1e-3)):
        for fa, fb in zip(port, sweeps[ref].last_fidelity):
            assert (fa.max_range, fa.window_s) == (fb.max_range, fb.window_s)
            assert fa.labels == fb.labels == \
                [f"{d}/original" for d in DATASETS] + \
                [f"{d}/sim{fa.max_range}" for d in DATASETS]
            a, b = _matrix(fa), _matrix(fb)
            assert np.array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, atol=tol)
            np.testing.assert_array_equal(a, a.T)


def test_fidelity_json_strict_and_readable_by_both(sweeps, tmp_path):
    port = sweeps["port"]
    assert len(port.list_fidelity()) == len(RANGES)
    assert len(port.list_metrics()) == len(DATASETS) * len(RANGES)

    def _no_constants(s):
        raise AssertionError(f"non-strict JSON token {s!r}")

    for p in port.list_fidelity():
        json.loads(p.read_text(), parse_constant=_no_constants)
    # each package's load_fidelity reads the other's artifacts
    for writer, reader_mod in ((sweeps["port"], J), (sweeps["pal_ctl"], T)):
        reader = reader_mod.Controller(str(tmp_path / reader_mod.__name__))
        for p in writer.list_fidelity():
            (reader.fidelity_dir).mkdir(parents=True, exist_ok=True)
            (reader.fidelity_dir / p.name).write_text(p.read_text())
        got = sorted(reader.load_fidelity(), key=lambda d: d["max_range"])
        mine = sorted(writer.load_fidelity(), key=lambda d: d["max_range"])
        assert len(got) == len(mine) == len(RANGES)
        for a, b in zip(got, mine):
            assert a["labels"] == b["labels"]
            np.testing.assert_allclose(_matrix(a), _matrix(b), atol=1e-3)
    nan = T.FidelityReport(60, 60, ["a", "b"],
                           [[1.0, float("nan")], [float("nan"), 1.0]])
    assert nan.to_json() == J.FidelityReport(
        60, 60, ["a", "b"], [[1.0, float("nan")],
                             [float("nan"), 1.0]]).to_json()
    assert nan.to_json()["trend_corr"] == [[1.0, None], [None, 1.0]]


def test_one_replay_loop_and_one_matrix_per_range(tmp_path, monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.streamsim import producer

    loops, matrices = [], []
    real_run = producer.MultiQueueProducer.run
    real_fid = ops.trend_correlation_batched_device

    def counting_run(self):
        loops.append(len(self.streams))
        return real_run(self)

    def counting_fid(qmat, *a, **k):
        matrices.append(tuple(qmat.shape))
        return real_fid(qmat, *a, **k)

    monkeypatch.setattr(producer.MultiQueueProducer, "run", counting_run)
    monkeypatch.setattr(ops, "trend_correlation_batched_device",
                        counting_fid)
    c = T.Controller(str(tmp_path), device=CPU)
    reps = c.run_many(["traffic", "sogouq"], [40, 80], _drain, scale=SCALE,
                      seed=9, backend="torch")
    assert len(reps) == 4 and loops == [4]
    assert [m[0] for m in matrices] == [4, 4]
    assert len(c.last_result.shard_results) == 1


# ------------------------------------------------ carried-across state
def test_stores_are_cache_hits_for_the_other_package(sweeps, tmp_path):
    root = sweeps["root"]
    # the reference replays the port's stored sims as cache hits ...
    j = J.Controller(str(root / "torch"), str(tmp_path / "j")).run_many(
        DATASETS, RANGES, _drain, scale=SCALE, seed=SEED, backend="numpy")
    # ... and the port the reference's
    tctl = T.Controller(str(root / "pallas"), str(tmp_path / "t"),
                        device=CPU)
    t = tctl.run_many(DATASETS, RANGES, _drain, scale=SCALE, seed=SEED,
                      backend="torch")
    assert len(tctl.last_result.plan.cached) == len(DATASETS) * len(RANGES)
    for a, b, first in zip(j, t, sweeps["torch"]):
        assert a.nsa_s == b.nsa_s == 0.0
        assert a.simulated_rows == b.simulated_rows == first.simulated_rows
        assert b.trend_corr == pytest.approx(first.trend_corr, abs=1e-6)
    for fa, fb in zip(tctl.last_fidelity, sweeps["port"].last_fidelity):
        np.testing.assert_allclose(_matrix(fa), _matrix(fb), atol=1e-6)


# ------------------------------------------------------------ chaos layer
CHAOS = dict(drop_rate=0.2, duplicate_rate=0.15, reorder_rate=0.25,
             reorder_window=3, delay_jitter_s=0.01, stall_rate=0.05,
             stall_s=0.02)


def test_fault_plan_sweep_matches_reference(tmp_path):
    kw = dict(scale=SCALE, seed=9)
    t = T.Controller(str(tmp_path / "t"), device=CPU).run_many(
        ["traffic"], [20, 40], _drain, backend="torch",
        fault_plan=T.FaultPlan(5, default=T.FaultSpec(**CHAOS)), **kw)
    j = J.Controller(str(tmp_path / "j")).run_many(
        ["traffic"], [20, 40], _drain, backend="numpy",
        fault_plan=J.FaultPlan(5, default=J.FaultSpec(**CHAOS)), **kw)
    for a, b in zip(t, j):
        m = a.consumer_metrics
        assert counts_only(m) == b.consumer_metrics
        assert m["fault_dropped"] + m["fault_duplicated"] > 0
        assert m["buckets_in"] == m["emitted_buckets"] - \
            m["fault_dropped"] + m["fault_duplicated"]
        assert (a.status, a.attempts) == (b.status, b.attempts) == ("ok", 1)


def test_degraded_scenario_matches_reference(tmp_path):
    broken = ("traffic", 40)
    out = {}
    for mod, name, backend, dev in ((T, "t", "torch", CPU),
                                    (J, "j", "numpy", None)):
        plan = mod.FaultPlan(3, overrides={
            broken: mod.FaultSpec(consumer_crash_attempts=(1, 2, 3, 4, 5))})
        ctl = mod.Controller(str(tmp_path / name), **(
            {"device": dev} if dev else {}))
        out[name] = ctl.run_many(
            ["traffic"], [20, 40], _drain, scale=SCALE, seed=9,
            backend=backend, fault_plan=plan,
            retry_policy=mod.RetryPolicy(max_attempts=2,
                                         base_delay_s=0.001),
            on_failure="degrade")
        out[name + "_ctl"] = ctl
    for a, b in zip(out["t"], out["j"]):
        for f in ("status", "failure", "attempts", "simulated_rows"):
            assert getattr(a, f) == getattr(b, f), f
        assert counts_only(a.consumer_metrics) == b.consumer_metrics
    bad = {(r.dataset, r.max_range): r for r in out["t"]}[broken]
    assert bad.status == "partial" and "InjectedConsumerCrash" in bad.failure
    assert bad.attempts == 2 and bad.simulated_rows > 0
    loaded = [m for m in out["t_ctl"].load_metrics()
              if m.get("status") == "partial"]
    assert len(loaded) == 1 and loaded[0]["max_range"] == 40


def test_failures_aggregate_like_reference(tmp_path):
    def consumer(queue):
        buckets = list(queue)
        if buckets and buckets[-1].scale_stamp + 1 in (20, 60):
            raise ValueError(f"scenario {buckets[-1].scale_stamp + 1}")
        return {"records_seen": sum(len(b) for b in buckets)}

    with pytest.raises(RuntimeError) as ei:
        T.Controller(str(tmp_path), device=CPU).run_many(
            ["traffic"], [20, 40, 60], consumer, scale=SCALE, seed=9,
            backend="torch")
    msg = str(ei.value)
    assert "2 of 3" in msg and "('traffic', 40)" not in msg
    assert "scenario 20" in str(ei.value.__cause__)
    assert "scenario 60" in str(ei.value.__cause__.__cause__)


def test_wedged_consumer_degrades_and_siblings_complete():
    s = T.preprocess(T.make_stream("traffic", scale=SCALE, seed=9))
    sims = {("traffic", mr): T.nsa(s, mr) for mr in (20, 40)}
    release = threading.Event()

    def consumer(queue):
        buckets = list(queue)
        if buckets[-1].scale_stamp + 1 == 40:
            release.wait(30)       # wedged well past the deadline
        return {"records_seen": sum(len(b) for b in buckets)}

    try:
        metrics, _ = tengine.replay_many(sims, consumer, 64,
                                         consumer_deadline_s=0.5,
                                         on_failure="degrade")
    finally:
        release.set()
    assert metrics[("traffic", 20)]["records_seen"] == \
        len(sims[("traffic", 20)])
    bad = metrics[("traffic", 40)]
    assert bad["degraded"] and "TimeoutError" in bad["failed"]
    assert bad["attempts"] == 1
    with pytest.raises(ValueError):
        tengine.replay_many({}, _drain, 64, on_failure="ignore")


# ------------------------------------------------------- multi-queue replay
def _sim_pair(max_ranges=(7, 40, 5000)):
    raw = T.make_stream("traffic", scale=0.003, seed=5)
    ts, js = T.preprocess(raw), J.preprocess(J.make_stream(
        "traffic", scale=0.003, seed=5))
    return ({("traffic", mr): T.nsa(ts, mr) for mr in max_ranges},
            {("traffic", mr): J.nsa(js, mr) for mr in max_ranges})


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "chaos"])
def test_multi_queue_walk_matches_reference(chaos):
    sims_t, sims_j = _sim_pair()
    got = {}
    for mod, sims in ((T, sims_t), (J, sims_j)):
        plan = mod.FaultPlan(7, default=mod.FaultSpec(**CHAOS)) \
            if chaos else None
        group = mod.QueueGroup(sims, maxsize=100_000)
        mp = mod.MultiQueueProducer(sims, group.queues,
                                    clock=mod.VirtualClock(),
                                    fault_plan=plan)
        assert mp.run() == 0
        got[mod] = {k: ([(b.scale_stamp, b.emit_time, len(b))
                         for b in group[k]], group[k].stats(), mp.stats(k))
                    for k in sims}
    got[T] = {k: (b, counts_only(q), p) for k, (b, q, p) in got[T].items()}
    assert got[T] == got[J]


def test_multi_queue_walk_equals_sequential_producer():
    sims, _ = _sim_pair()
    group = T.QueueGroup(sims, maxsize=100_000)
    mp = T.MultiQueueProducer(sims, group.queues, clock=T.VirtualClock())
    assert mp.run() == 0
    for key, sim in sims.items():
        q_ref = T.StreamQueue(maxsize=100_000)
        p_ref = T.Producer(sim, q_ref, clock=T.VirtualClock())
        assert p_ref.run() == 0
        got, exp = list(group[key]), list(q_ref)
        assert [(b.scale_stamp, b.emit_time) for b in got] == \
            [(b.scale_stamp, b.emit_time) for b in exp]
        assert counts_only(group[key].stats()) == counts_only(q_ref.stats())
        assert mp.stats(key) == p_ref.stats()


def _drain_all(group, mp):
    got = {}

    def drain(key):
        got[key] = [(b.scale_stamp, len(b)) for b in group[key]]

    threads = [threading.Thread(target=drain, args=(k,), daemon=True)
               for k in group] + [threading.Thread(target=mp.run,
                                                   daemon=True)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    return got


@pytest.mark.parametrize("maxsize", [2, 100_000])
def test_timer_wheel_order_and_counts(maxsize):
    # RealClock walk: only the bucket order and the counts are asserted,
    # never wall time
    sims, _ = _sim_pair((7, 23))
    group = T.QueueGroup(sims, maxsize=maxsize)
    mp = T.MultiQueueProducer(sims, group.queues, clock=T.RealClock(),
                              tick_s=0.001)
    got = _drain_all(group, mp)
    for key, sim in sims.items():
        q_ref = T.StreamQueue(maxsize=100_000)
        p_ref = T.Producer(sim, q_ref, clock=T.VirtualClock())
        assert p_ref.run() == 0
        assert got[key] == [(b.scale_stamp, len(b)) for b in q_ref]
        assert mp.stats(key) == p_ref.stats()
        assert counts_only(group[key].stats()) == counts_only(q_ref.stats())


def test_queue_group_budget_and_keys():
    sims, _ = _sim_pair((20, 40))
    group = T.QueueGroup(sims, maxsize=64, max_bytes=1 << 16)
    assert set(group.stats()) == set(sims) and len(group) == 2
    assert group.budget_stats()["max_bytes"] == 1 << 16
    metrics, _ = tengine.replay_many(sims, _drain, 64, max_bytes=1 << 16)
    for key, sim in sims.items():
        assert metrics[key]["records_seen"] == len(sim)
        assert metrics[key]["dropped_retention"] == 0
    assert T.QueueGroup(["a"]).budget_stats() is None


def test_chunk_feed_values_not_ported():
    # ported since: the port's own ChunkFeed values select the chunked walk;
    # a mix with whole streams, or mismatched keys, still raise
    feed = T.ChunkFeed()
    assert T.MultiQueueProducer({"a": feed}, {"a": T.StreamQueue()}).chunked
    sim = T.Stream("s", np.arange(3.0), {}, np.arange(3))
    with pytest.raises(ValueError, match="mix"):
        T.MultiQueueProducer({"a": feed, "b": sim},
                             {"a": T.StreamQueue(), "b": T.StreamQueue()})
    with pytest.raises(ValueError):
        T.MultiQueueProducer({"a": feed}, {"b": T.StreamQueue()})


# ---------------------------------------------------------- not ported yet
@pytest.mark.parametrize("knob,raises", [
    ({"checkpoint": True}, None), ({"chunk_s": 60}, None),
    ({"duration_s": 86_400}, ValueError),
    ({"service": True}, None),
    ({"n_hosts": 2, "host_index": 0}, None),
    ({"autotune": "cached"}, None)],
    ids=["checkpoint", "chunk_s", "duration_s", "service", "n_hosts",
         "autotune"])
def test_unported_knobs_raise(tmp_path, knob, raises):
    # checkpoint and chunk_s (the chunked slice), service and n_hosts (the
    # sweep-service slice) are ported and run: host 0 of 2 takes the one
    # scenario; duration_s without chunk_s raises the reference's
    # ValueError; autotune (the tile-tuning slice) runs too
    c = T.Controller(str(tmp_path), device=CPU)
    if raises is None:
        reps = c.run_many(["traffic"], [20], _drain, scale=SCALE, seed=9,
                          backend="torch", **knob)
        assert len(reps) == len(c.list_metrics()) == 1
        assert reps[0].status == "ok"
        assert reps[0].consumer_metrics["records_seen"] == \
            reps[0].simulated_rows > 0
        return
    with pytest.raises(raises):
        c.run_many(["traffic"], [20], _drain, scale=SCALE, seed=9,
                   backend="torch", **knob)
    assert c.list_metrics() == []


def test_run_many_without_device_needs_cuda(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        T.Controller(str(tmp_path / "t")).run_many(
            ["traffic"], [20], _drain, scale=SCALE, seed=9, backend="torch")
    with pytest.raises(RuntimeError, match="is_available"):
        T.trend_correlation_matrix([np.arange(30)], 5)
    # the host backend needs no device
    reps = T.Controller(str(tmp_path / "n")).run_many(
        ["traffic"], [20], _drain, scale=SCALE, seed=9, backend="numpy")
    assert reps[0].simulated_rows > 0


def test_run_sweep_report_hooks(tmp_path):
    # on_report sees each report as it is assembled; a SweepCheckpoint gets
    # one report marker per scenario that loads back equal
    originals = {d: T.preprocess(T.make_stream(d, scale=SCALE, seed=3))
                 for d in ("sogouq", "traffic")}
    store = T.StreamStore(tmp_path)
    plan = T.plan_sweep(store, list(originals), [20, 40],
                        {d: len(s) for d, s in originals.items()}, **ONE_HOST)
    res = T.execute_sweep(plan, originals, store, backend="torch",
                          device=CPU)
    ckpt = T.SweepCheckpoint(store, plan.sweep_id)
    seen = []
    reports, fid = T.run_sweep(res, _drain, checkpoint=ckpt,
                               on_report=seen.append)
    assert seen == reports and len(fid) == 2
    assert sorted(ckpt.done_scenarios()) == sorted(res.scenarios)
    loaded = ckpt.load_reports()
    for r in reports:
        assert loaded[(r.dataset, r.max_range)] == r
    assert T.run_sweep(res, _drain, fidelity=False)[1] == []
