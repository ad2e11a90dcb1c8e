"""The benchmark's plain reference held to the port driven on the CPU, and
its control held to fail. Small streams (scale <= 0.01); no card needed."""

from __future__ import annotations

import numpy as np
import pytest

from stream_bench import bench, judge
from stream_bench.reference import generators, simulate

#: the three datasets as the paper's grid states them
SPECS = bench.load_data("configs", "paper-grid")["datasets"]
DATASETS = tuple(SPECS)
SCALE, SEED = 0.01, 2**31 + 77


@pytest.fixture(scope="module")
def streams():
    """dataset -> (raw columns, the reference's POSD, the port's POSD)."""
    from repro_torch.streamsim.datasets import RawStream
    from repro_torch.streamsim.preprocess import preprocess
    out = {}
    for d in DATASETS:
        raw = generators.make(SPECS[d], SCALE, SEED)
        ref = simulate.posd(raw, SPECS[d]["time_column"],
                            SPECS[d]["tz_offset_s"])
        out[d] = (raw, ref, preprocess(RawStream(name=d, columns=raw)))
    return out


@pytest.mark.parametrize("name", DATASETS)
def test_frozen_generators_match_the_program_today(name):
    """The configuration's numbers and the frozen schemas give the
    program's own streams."""
    from repro_torch.streamsim.datasets import make_stream
    got = generators.make(SPECS[name], 0.003, 5)
    want = make_stream(name, scale=0.003, seed=5).columns
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", DATASETS)
def test_posd_matches_the_program(streams, name):
    _, (t, payload), stream = streams[name]
    np.testing.assert_array_equal(t, stream.t)
    assert list(payload) == list(stream.payload)
    for k, v in payload.items():
        np.testing.assert_array_equal(v, stream.payload[k])


def test_datetime_parse_matches_numpy():
    rng = np.random.default_rng(3)
    secs = rng.integers(-2_000_000_000, 4_000_000_000, 5000)
    secs = np.concatenate([secs, [951_782_400, 951_868_799, 0]])  # leap day
    iso = np.datetime_as_string(secs.astype("datetime64[s]"), unit="s")
    text = np.char.replace(iso, "T", " ")
    np.testing.assert_array_equal(simulate.parse_datetimes(text),
                                  secs.astype(np.float64))


@pytest.mark.parametrize("name,max_range", [
    ("sogouq", 600), ("traffic", 3600), ("userbehavior", 1200),
    ("userbehavior", 86_400)])
def test_nsa_matches_the_program_on_cpu(streams, name, max_range):
    from repro_torch.streamsim.nsa import nsa
    _, (t, payload), stream = streams[name]
    want = simulate.nsa(t, payload, max_range)
    got = nsa(stream, max_range, backend="torch", device="cpu")
    cols = {"t": got.t, "scale_stamp": got.scale_stamp, **got.payload}
    assert judge.records_bad(cols, want) == 0


def test_statistics_match_the_program_on_cpu(streams, tmp_path):
    """Reports and fidelity matrices of ``run_many`` on the CPU against the
    reference, within the float32 the configuration states."""
    from repro_torch.streamsim.controller import Controller
    from repro_torch.streamsim.store import StreamStore
    store = StreamStore(tmp_path)
    for d in DATASETS:
        store.put(f"{d}__orig", streams[d][2])
    ranges = [600, 1800]
    ctl = Controller(str(tmp_path), device="cpu")
    reports = ctl.run_many(list(DATASETS), ranges,
                           lambda q: {"n": sum(len(b) for b in q)},
                           backend="torch")
    exp = simulate.expected({d: streams[d][0] for d in DATASETS}, {
        "datasets": SPECS, "report_window_s": 60,
        "knobs": {"fidelity_window_s": 60}, "entry": "run_many"}, ranges)
    for r in reports:
        want = exp.reports[(r.dataset, r.max_range)]
        assert r.simulated_rows == want["simulated_rows"]
        got = (r.simulated_volatility.average, r.simulated_volatility.variance,
               r.simulated_volatility.std_variance)
        np.testing.assert_allclose(got, want["simulated_volatility"][:3],
                                   rtol=1e-5)
        assert abs(r.trend_corr - want["trend_corr"]) < 1e-4
    for f in ctl.last_fidelity:
        labels, want = exp.fidelity[f.max_range]
        assert f.labels == labels
        np.testing.assert_allclose(f.trend_corr, want, atol=1e-4)


def test_days_come_from_the_configuration():
    """A stream of several days repeats the day's shape over the span the
    configuration gives, at the day's rate."""
    spec = dict(SPECS["traffic"], days=3)
    one = generators.make(SPECS["traffic"], 0.01, 4)["query_ts"]
    three = generators.make(spec, 0.01, 4)["query_ts"]
    start = spec["start_epoch_s"]
    assert three.min() >= start and three.max() < start + 3 * 86_400
    assert three.max() - start > 2 * 86_400
    assert len(three) / len(one) == pytest.approx(3, rel=0.05)


def test_fidelity_matrix_matches_numpy_pearson():
    rng = np.random.default_rng(0)
    rows = [rng.poisson(20 + 10 * np.sin(np.arange(n) / 300), n)
            for n in (3000, 2000, 600)]
    m = simulate.corr_matrix(rows, 60)
    k = 600
    z = np.stack([simulate.resample(simulate.sliding_mean(q, 60), k)
                  for q in rows])
    np.testing.assert_allclose(m, np.corrcoef(z), atol=1e-12)


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1 + 2**-8, 1 + 3 * 2**-9, 256.0, 257.0, 259.0])
    np.testing.assert_array_equal(
        simulate.bf16(x), [1.0, 1.0, 1 + 2**-7, 256.0, 256.0, 260.0])


@pytest.mark.parametrize("config,ranges", [
    ("ub-day", [600]), ("paper-grid", [600, 3600]),
    ("paper-grid-chunked", [600, 3600])])
def test_control_is_not_correct(config, ranges):
    """The reference one precision lower, judged as the program would be;
    the reference itself, with a feed within its bound where the
    configuration bounds one, is correct, and without one is not."""
    from stream_bench import bench
    cfg = bench.load_data("configs", config)
    raw = {d: generators.make(spec, 0.02, 11)
           for d, spec in cfg["datasets"].items()}
    exp = simulate.expected(raw, cfg, ranges)
    low = simulate.expected(raw, cfg, ranges, low=True)
    ok, checks = judge.judge(exp, [judge.output_of(low)], cfg["limits"])
    assert not ok
    assert checks["vol_rel"]["value"] > cfg["limits"]["vol_rel"]
    assert checks["trend_gap"]["value"] > cfg["limits"]["trend_gap"]
    ok, _ = judge.judge(exp, [judge.output_of(exp, feed_hwm=2)],
                        cfg["limits"])
    assert ok
    ok, _ = judge.judge(exp, [judge.output_of(exp)], cfg["limits"])
    assert ok == ("feed_hwm" not in cfg["limits"])


def test_control_fails_the_stored_original():
    """Where the jobs run POSD, the control's original (its stamps as
    float32 holds them) is not the reference's, and the reference's is."""
    cfg = bench.load_data("configs", "ub-day")
    raw = {d: generators.make(spec, 0.02, 13)
           for d, spec in cfg["datasets"].items()}
    exp = simulate.expected(raw, cfg, [3600])
    low = simulate.expected(raw, cfg, [3600], low=True)
    ok, checks = judge.judge(exp, [judge.output_of(low)], cfg["limits"],
                             posd=True)
    assert not ok
    n = len(exp.originals["userbehavior"]["t"])
    assert checks["orig_bad"]["value"] > n // 2
    ok, checks = judge.judge(exp, [judge.output_of(exp)], cfg["limits"],
                             posd=True)
    assert ok and checks["orig_bad"]["value"] == 0
    # without POSD in the job the stored originals are not compared
    _, checks = judge.judge(exp, [judge.output_of(low)], cfg["limits"])
    assert "orig_bad" not in checks
