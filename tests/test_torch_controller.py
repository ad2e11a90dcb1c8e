"""End-to-end parity of the port's ``Controller.run`` with the JAX
package's, on the CPU at small scale.

The port runs ``backend="torch", device="cpu"`` (the kernels' plain
PyTorch versions); the reference runs ``backend="pallas"`` (interpret
mode) and ``backend="numpy"``. Rows, compression and stored simulated
streams must be exact; ``simulated_volatility`` within 1e-5 of the pallas
run and 1e-3 of numpy; ``trend_corr`` within 1e-3.
"""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import repro.streamsim as J
import repro_torch.streamsim as T
from repro_torch.streamsim import engine as tengine

CPU = "cpu"
CELLS = [("userbehavior", 600, 0.01, 0), ("traffic", 60, 0.005, 4)]


def _consumer(queue):
    return {"records_seen": sum(len(b) for b in queue)}


def _vol(v):
    return dataclasses.astuple(v)


def _stored_equal(a_dir, b_dir, key, a_mod=T, b_mod=J):
    a = a_mod.StreamStore(a_dir).get(key)
    b = b_mod.StreamStore(b_dir).get(key)
    cols_a = {"t": a.t, "ss": a.scale_stamp, **a.payload}
    cols_b = {"t": b.t, "ss": b.scale_stamp, **b.payload}
    assert list(cols_a) == list(cols_b)
    for k in cols_a:
        if cols_a[k] is None or cols_b[k] is None:   # originals: no stamps
            assert cols_a[k] is None and cols_b[k] is None, k
            continue
        assert cols_a[k].dtype == cols_b[k].dtype, k
        assert cols_a[k].tobytes() == cols_b[k].tobytes(), k


@pytest.fixture(scope="module", params=CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def runs(request, tmp_path_factory):
    ds, mr, scale, seed = request.param
    root = tmp_path_factory.mktemp(f"{ds}{mr}")
    kw = dict(scale=scale, seed=seed)
    port = T.Controller(str(root / "torch"), device=CPU)
    rep = port.run(ds, mr, _consumer, backend="torch", **kw)
    return {
        "cell": request.param, "root": root, "port": port, "torch": rep,
        "pallas": J.Controller(str(root / "pallas")).run(
            ds, mr, _consumer, backend="pallas", **kw),
        "numpy": J.Controller(str(root / "numpy")).run(
            ds, mr, _consumer, backend="numpy", **kw),
        "port_numpy": T.Controller(str(root / "port_numpy")).run(
            ds, mr, _consumer, backend="numpy", **kw),
    }


def test_rows_and_compression_exact(runs):
    rep = runs["torch"]
    for ref in (runs["pallas"], runs["numpy"]):
        assert (rep.dataset, rep.max_range) == (ref.dataset, ref.max_range)
        assert rep.original_rows == ref.original_rows
        assert rep.simulated_rows == ref.simulated_rows
        assert rep.compression == ref.compression
    assert rep.consumer_metrics == runs["pallas"].consumer_metrics
    assert rep.consumer_metrics["records_seen"] == rep.simulated_rows
    assert runs["port"].last_result.mode == "device"


def test_stored_sims_exact(runs):
    ds, mr = runs["cell"][:2]
    for ref in ("pallas", "numpy"):
        _stored_equal(runs["root"] / "torch", runs["root"] / ref,
                      f"{ds}__sim{mr}")
    _stored_equal(runs["root"] / "torch", runs["root"] / "pallas",
                  f"{ds}__orig")


def test_volatility_and_trend_within_tolerance(runs):
    rep, pal, num = runs["torch"], runs["pallas"], runs["numpy"]
    for f in ("average", "variance", "std_variance"):
        x = getattr(rep.simulated_volatility, f)
        assert x == pytest.approx(getattr(pal.simulated_volatility, f),
                                  rel=1e-5, abs=1e-12)
        assert x == pytest.approx(getattr(num.simulated_volatility, f),
                                  rel=1e-3, abs=1e-12)
        assert getattr(rep.original_volatility, f) == pytest.approx(
            getattr(num.original_volatility, f), rel=1e-3)
    assert rep.simulated_volatility.time_range == \
        num.simulated_volatility.time_range
    assert abs(rep.trend_corr - pal.trend_corr) <= 1e-3
    assert abs(rep.trend_corr - num.trend_corr) <= 1e-3


def test_numpy_backend_equals_reference_numpy(runs):
    a, b = runs["port_numpy"], runs["numpy"]
    for f in ("original_rows", "simulated_rows", "compression",
              "trend_corr", "consumer_metrics", "status", "attempts"):
        assert getattr(a, f) == getattr(b, f), f
    assert _vol(a.simulated_volatility) == _vol(b.simulated_volatility)
    assert _vol(a.original_volatility) == _vol(b.original_volatility)


def test_report_json_has_reference_keys(runs):
    assert list(runs["torch"].to_json()) == list(runs["numpy"].to_json())
    back = T.SimulationReport.from_json(runs["torch"].to_json())
    assert back == runs["torch"]


def test_second_run_is_a_cache_hit(runs):
    ds, mr, scale, seed = runs["cell"]
    port = runs["port"]
    again = port.run(ds, mr, _consumer, scale=scale, seed=seed,
                     backend="torch")
    assert again.nsa_s == 0.0 and runs["torch"].nsa_s > 0.0
    assert again.simulated_rows == runs["torch"].simulated_rows
    assert again.trend_corr == pytest.approx(runs["torch"].trend_corr,
                                             abs=1e-6)
    assert len(port.list_metrics()) >= 2
    loaded = port.load_metrics()
    assert {m["dataset"] for m in loaded} == {ds}


def test_simulate_persists_and_reuses(tmp_path):
    c = T.Controller(str(tmp_path), device=CPU)
    sim = c.simulate("sogouq", 120, scale=0.002, seed=1, backend="torch")
    assert c.store.exists("sogouq__sim120")
    ref = J.Controller(str(tmp_path / "j")).simulate(
        "sogouq", 120, scale=0.002, seed=1, backend="numpy")
    assert np.array_equal(sim.t, ref.t)
    assert np.array_equal(sim.scale_stamp, ref.scale_stamp)
    again = c.simulate("sogouq", 120, scale=0.002, seed=1)
    assert np.array_equal(again.scale_stamp, sim.scale_stamp)


def test_simulate_stream_facade():
    from repro.core import simulate_stream as jsim
    from repro_torch.core import simulate_stream as tsim
    a = tsim("traffic", 90, scale=0.002, seed=2, backend="torch",
             device=CPU)
    b = jsim("traffic", 90, scale=0.002, seed=2)
    assert np.array_equal(a.t, b.t)
    assert np.array_equal(a.scale_stamp, b.scale_stamp)


def test_autotune_other_than_off_raises(tmp_path):
    # (the name is kept from when "cached" raised NotImplementedError):
    # "cached" runs and equals the "off" run; an unknown mode raises
    kw = dict(scale=0.002, seed=9, backend="torch")
    off = T.Controller(str(tmp_path / "off"), device=CPU).run(
        "traffic", 40, _consumer, **kw)
    c = T.Controller(str(tmp_path / "cached"), device=CPU)
    rep = c.run("traffic", 40, _consumer, autotune="cached", **kw)
    assert rep.simulated_rows == off.simulated_rows > 0
    assert rep.consumer_metrics == off.consumer_metrics
    np.testing.assert_allclose(rep.simulated_volatility.variance,
                               off.simulated_volatility.variance, rtol=1e-5)
    with pytest.raises(ValueError, match="autotune"):
        T.Controller(str(tmp_path / "bad"), device=CPU).run(
            "traffic", 40, _consumer, autotune="fastest", **kw)


def _plan(store, originals, max_ranges, n_devices=1):
    return T.plan_sweep(store, list(originals), max_ranges,
                        {d: len(s) for d, s in originals.items()},
                        n_devices=n_devices, host_index=0, n_hosts=1)


def test_domain_error_falls_back_to_host_mode(tmp_path):
    # one giant zero-span bucket overflows the int32 keep rule: the engine
    # must demote the whole sweep to host mode, with numpy-equal NSA
    t = np.full(100_000, 1.5e9)
    orig = T.Stream("flat", t, {"x": np.arange(len(t))})
    store = T.StreamStore(tmp_path)
    res = T.execute_sweep(_plan(store, {"flat": orig}, [10]),
                          {"flat": orig}, store, backend="torch",
                          device=CPU)
    assert res.mode == "host"
    sim = res.materialize()[("flat", 10)]
    want = T.nsa(orig, 10, backend="numpy")
    assert np.array_equal(sim.t, want.t)
    assert np.array_equal(sim.scale_stamp, want.scale_stamp)
    rep = tengine.build_report(res, ("flat", 10), 0.0, 0.0, {})
    assert rep.simulated_rows == len(want)


def test_two_shard_sweep_matches_numpy(tmp_path):
    originals = {d: T.preprocess(T.make_stream(d, scale=0.002, seed=3))
                 for d in ("sogouq", "traffic")}
    grid = [(d, mr) for d in originals for mr in (60, 600)]
    out = {}
    for backend in ("torch", "numpy"):
        store = T.StreamStore(tmp_path / backend)
        plan = _plan(store, originals, [60, 600], n_devices=2)
        assert len(plan.shards) == 2
        res = T.execute_sweep(plan, originals, store, backend=backend,
                              device=CPU)
        assert res.mode == ("device" if backend == "torch" else "host")
        sims = res.materialize()
        out[backend] = (sims, {sc: tengine.build_report(
            res, sc, 0.0, 0.0, {}) for sc in grid})
    for sc in grid:
        a, b = out["torch"][0][sc], out["numpy"][0][sc]
        assert np.array_equal(a.t, b.t)
        assert np.array_equal(a.scale_stamp, b.scale_stamp)
        ra, rb = out["torch"][1][sc], out["numpy"][1][sc]
        assert ra.simulated_rows == rb.simulated_rows
        assert abs(ra.trend_corr - rb.trend_corr) <= 1e-3 or \
            (np.isnan(ra.trend_corr) and np.isnan(rb.trend_corr))
        assert ra.simulated_volatility.average == pytest.approx(
            rb.simulated_volatility.average, rel=1e-3)
