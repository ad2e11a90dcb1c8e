"""Tile tuning of the port (``repro_torch.kernels.tuning``) on the CPU.

One counterpart of each test of ``tests/test_tuning.py`` (the reference's
tuner), run against the port's tuner: the shipped defaults, the per-kind
JSON cache (a hit skips the sweep, a corrupt file falls back, concurrent
writers leave valid JSON), the ambient knob and the shared registry,
``nsa`` and ``Controller.run`` with ``autotune``. Sweeps here time the
plain PyTorch versions (the ``cpu-plain`` kind), so the tests hold the
cache's mechanics, never which candidate wins. Then the port against the
JAX package: the same keys and configs, one cache file read by both
tuners, the plain B3/B6 at other bucket blocks against the Pallas kernels
in interpret mode (histograms exact, moments within 1e-5, the reference's
own tolerance), ``grid_split`` and ``Controller.run``.
"""

import json
import threading

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.streamsim as J
import repro_torch.streamsim as T
from repro.kernels import ops as jops
from repro.kernels import tuning as jtuning
from repro_torch.kernels import compact as tcompact
from repro_torch.kernels import metrics_fused as tmetrics
from repro_torch.kernels import ops, tuning
from repro_torch.kernels import stream_sample as tsample
from repro_torch.kernels import trend_scan as ttrend
from repro_torch.kernels.tuning import (DEFAULT_CONFIG, KernelTuner,
                                        TileConfig, TuneKey)
from repro_torch.streamsim.queue import counts_only

CPU = "cpu"
KIND = tuning.CPU_KIND


@pytest.fixture()
def store(tmp_path):
    return T.StreamStore(tmp_path / "store")


def _cache_file(store, kind):
    return store.root / "_markers" / tuning.TUNE_NAMESPACE / f"{kind}.json"


def _consumer(queue):
    return {"records_seen": sum(len(b) for b in queue)}


# ------------------------------------------------------------ default path
def test_default_config_is_the_shipped_constants():
    assert DEFAULT_CONFIG.record_tile == ops.TILE == 1024
    assert DEFAULT_CONFIG.bucket_block == ops.BUCKET_BLOCK == 512
    assert DEFAULT_CONFIG.grid_split == 1
    assert DEFAULT_CONFIG.sublane == 8
    # on a card the heuristic is the port's shipped instances, each the
    # default library of its family
    key = {k: TuneKey.from_shape(k, s=8, n=90000, r=86400)
           for k in tuning.KERNELS}
    got = {k: tuning.heuristic_config(key[k], "gpu-h100") for k in key}
    assert got["stream_sample"].record_tile == 2048
    assert tsample.defines(got["stream_sample"]) == ()
    assert (got["metrics_fused"].record_tile,
            got["metrics_fused"].bucket_block) == (4096, 512)
    assert tmetrics.defines(got["metrics_fused"]) == ()
    assert ttrend.defines(got["trend_scan"]) == ()
    assert ttrend.pair_quantum(got["pair_stats"]) == ops.PAIR_TILE


@pytest.mark.parametrize("kind", [KIND, "tpu-v4", "tpu-v5e"])
def test_heuristic_reproduces_constants_off_gpu(kind):
    for kernel in tuning.KERNELS:
        key = TuneKey.from_shape(kernel, s=8, n=90000, r=86400)
        assert tuning.heuristic_config(key, kind) == DEFAULT_CONFIG


def test_tune_key_pow2_snaps_and_round_trips():
    key = TuneKey.from_shape("metrics_fused", s=5, n=90000, r=86400)
    assert (key.s, key.n, key.r) == (8, 1 << 17, 1 << 17)
    assert TuneKey.decode(key.encode()) == key


def test_off_mode_does_no_io(store):
    tuner = KernelTuner("off", store=store, kind=KIND)
    cfg = tuner.config_for("metrics_fused", s=4, n=4096, r=1024)
    assert cfg == DEFAULT_CONFIG
    assert not _cache_file(store, KIND).exists()
    # B2's shipped tile follows the UNSNAPPED shape, as its default
    # library's choice does: 3 x 40 tiles of 16384 are fewer than 132 SMs,
    # the snapped 4 x 64 are not
    gpu = KernelTuner("off", kind="gpu-h100")
    assert gpu.config_for("compact", s=3, n=40 * 16384).record_tile == 4096
    snapped = TuneKey.from_shape("compact", s=3, n=40 * 16384)
    assert tuning.heuristic_config(snapped, "gpu-h100",
                                   sms=132).record_tile == 16384


# ----------------------------------------------- non-default config outputs
def test_non_default_config_outputs_match_default():
    rng = np.random.default_rng(11)
    ss = torch.from_numpy(
        np.sort(rng.integers(0, 3000, (3, 4096)), axis=1).astype(np.int32))
    lengths = torch.tensor([4096, 3000, 17], dtype=torch.int32)
    wide = TileConfig(record_tile=2048, bucket_block=256)
    buckets = 3072   # multiple of both 512 and 256
    h0, m0 = tmetrics.stream_metrics(ss, lengths, buckets)
    h1, m1 = tmetrics.stream_metrics(ss, lengths, buckets, config=wide)
    assert torch.equal(h0, h1)
    torch.testing.assert_close(m1, m0, rtol=1e-5, atol=1e-5)

    mask = torch.from_numpy(rng.random((3, 4096)) < 0.4)
    for cfg in tuning.instances("compact"):
        assert all(torch.equal(a, b) for a, b in zip(
            tcompact.compact(mask), tcompact.compact(mask, config=cfg)))
    q = torch.from_numpy(rng.integers(0, 5, (3, 4096)).astype(np.int32))
    for cfg in tuning.instances("trend_scan"):
        assert torch.equal(ttrend.trend_scan(q),
                           ttrend.trend_scan(q, config=cfg))
    # a tile a family has no instance of is refused before any launch
    with pytest.raises(ValueError, match="instance"):
        tsample.defines(TileConfig(record_tile=3072))
    with pytest.raises(ValueError, match="instance"):
        tmetrics.defines(TileConfig(record_tile=4096, bucket_block=384))
    with pytest.raises(ValueError):
        ttrend.pair_quantum(TileConfig(bucket_block=2048))


def test_grid_split_matches_single_launch():
    # the batch-axis split is a pure partition of the rows: the same bits
    # as one launch, and as the reference's split launches
    rng = np.random.default_rng(3)
    streams = [np.sort(rng.uniform(0, 600.0, 700)) for _ in range(5)]

    class _Tuner(KernelTuner):
        def config_for(self, kernel, **kw):
            return TileConfig(grid_split=3)

    class _JTuner(jtuning.KernelTuner):
        def config_for(self, kernel, **kw):
            return jtuning.TileConfig(grid_split=3)

    ranges = [100, 200, 300, 400, 500]
    calls = []
    real = tsample.stream_sample

    def spy(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    ss0, keep0, len0 = ops.stream_sample_batched(streams, ranges, 1.0,
                                                 device=CPU)
    ops._stream_sample_kernel, saved = spy, ops._stream_sample_kernel
    try:
        with tuning.use(_Tuner("off")):
            ss1, keep1, len1 = ops.stream_sample_batched(streams, ranges,
                                                         1.0, device=CPU)
    finally:
        ops._stream_sample_kernel = saved
    assert calls == [2, 1, 2]
    assert torch.equal(ss0, ss1) and torch.equal(keep0, keep1)
    assert np.array_equal(len0, len1)
    with jtuning.use(_JTuner("off")):
        jss, jkeep, jlen = jops.stream_sample_batched(streams, ranges, 1.0)
    n = ss1.shape[1]
    assert np.array_equal(ss1.numpy(), np.asarray(jss)[:, :n])
    assert np.array_equal(keep1.numpy(), np.asarray(jkeep)[:, :n])


# --------------------------------------------------------------- sweep/cache
def _counting_timer(tuner):
    calls = [0]
    real = tuner._timer

    def timer():
        calls[0] += 1
        return real()

    tuner._timer = timer
    return calls


def test_force_sweep_persists_and_cached_hit_skips_sweep(store):
    t1 = KernelTuner("force", store=store, kind=KIND, reps=1, device=CPU)
    c1 = _counting_timer(t1)
    cfg = t1.config_for("trend_scan", s=2, n=2048)
    assert c1[0] > 0, "force mode must actually time candidates"
    assert isinstance(cfg, TileConfig)
    blob = json.loads(_cache_file(store, KIND).read_text())
    assert blob["version"] == 1 and blob["device_kind"] == KIND
    keystr = TuneKey.from_shape("trend_scan", s=2, n=2048).encode()
    assert blob["entries"][keystr] == cfg.as_dict()
    # every candidate is recorded with its time; none was dropped
    rec = t1.records[(KIND, TuneKey.decode(keystr))]
    assert rec["winner"] == cfg.as_dict()
    assert [c["config"] for c in rec["candidates"]] == [
        c.as_dict() for c in tuning.candidate_lattice(
            TuneKey.decode(keystr), KIND)]
    assert all(c["ms"] >= 0 for c in rec["candidates"])
    assert t1.dropped() == []

    t2 = KernelTuner("cached", store=store, kind=KIND, reps=1, device=CPU)
    c2 = _counting_timer(t2)
    assert t2.config_for("trend_scan", s=2, n=2048) == cfg
    assert c2[0] == 0, "cache hit must skip the measured sweep"


def test_cache_is_keyed_per_device_kind(store):
    ka, kb = "tpu-v4", "gpu-a100"
    ta = KernelTuner("force", store=store, kind=ka, reps=1)
    ta._sweep = lambda key, kind=None, device=None: TileConfig(
        record_tile=2048)
    ta.config_for("compact", s=4, n=4096)
    assert _cache_file(store, ka).exists()
    assert not _cache_file(store, kb).exists()

    tb = KernelTuner("cached", store=store, kind=kb, reps=1)
    swept = []
    tb._sweep = lambda key, kind=None, device=None: \
        swept.append(key) or TileConfig()
    tb.config_for("compact", s=4, n=4096)
    assert len(swept) == 1


def test_corrupt_cache_falls_back_to_heuristic(store):
    f = _cache_file(store, KIND)
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text('{"version": 1, "entries": {"trunca')   # torn write
    tuner = KernelTuner("cached", store=store, kind=KIND, reps=1)
    assert tuner._load_cache() == {}
    tuner._sweep = lambda key, kind=None, device=None: \
        tuning.heuristic_config(key, KIND)
    cfg = tuner.config_for("metrics_fused", s=2, n=2048, r=512)
    assert cfg == DEFAULT_CONFIG

    f.write_text(json.dumps({
        "version": 1, "device_kind": KIND,
        "entries": {"trend_scan/s2/n2048/r0/int32":
                    {"record_tile": 2048, "bucket_block": 512,
                     "grid_split": 1},
                    "not-a-key": {"record_tile": "wat"}}}))
    cache = tuner._load_cache()
    assert cache == {TuneKey.from_shape("trend_scan", s=2, n=2048):
                     TileConfig(record_tile=2048)}


def test_concurrent_force_writers_leave_valid_json(store):
    keys = [("trend_scan", 2, 2048), ("compact", 4, 4096)]
    cfgs = {0: TileConfig(record_tile=2048), 1: TileConfig(bucket_block=256)}
    errs = []

    def write(i):
        try:
            t = KernelTuner("force", store=store, kind=KIND, reps=1)
            t._sweep = lambda key, kind=None, device=None: cfgs[i]
            kernel, s, n = keys[i]
            for _ in range(20):      # hammer the read-merge-write path
                t._mem.clear()
                t.config_for(kernel, s=s, n=n)
        except Exception as e:       # pragma: no cover - failure detail
            errs.append(e)

    threads = [threading.Thread(target=write, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs
    entries = json.loads(_cache_file(store, KIND).read_text())["entries"]
    for i, (kernel, s, n) in enumerate(keys):
        assert entries[TuneKey.from_shape(kernel, s=s, n=n).encode()] == \
            cfgs[i].as_dict()


def test_sweep_failure_degrades_to_heuristic(store):
    tuner = KernelTuner("force", store=store, kind=KIND, reps=1, device=CPU)

    def boom():
        raise RuntimeError("device fell over")

    tuner._timer = boom
    key = TuneKey.from_shape("trend_scan", s=2, n=2048)
    assert tuner.config_for("trend_scan", s=2, n=2048) == \
        tuning.heuristic_config(key, KIND)
    # each candidate is recorded as dropped, with the reason
    assert {c["dropped"].split(":")[0] for c in
            tuner.records[(KIND, key)]["candidates"]} == {"timing"}


# ------------------------------------------------------------- ambient knob
def test_tuner_context_off_installs_nothing(store):
    with tuning.tuner_context(None, store=store):
        assert tuning.current() is tuning._DEFAULT_TUNER
    with tuning.tuner_context("off", store=store):
        assert tuning.current() is tuning._DEFAULT_TUNER
    with pytest.raises(ValueError):
        with tuning.tuner_context("fastest", store=store):
            pass  # pragma: no cover


def test_shared_tuner_registry_reuses_instances(store):
    a = tuning.shared_tuner("cached", store=store, kind="tpu-v4")
    b = tuning.shared_tuner("cached", store=store, kind="tpu-v4")
    c = tuning.shared_tuner("cached", store=store, kind="tpu-v5e")
    assert a is b and a is not c
    assert tuning.shared_tuner("cached", store=store, device=CPU) is \
        tuning.shared_tuner("cached", store=store, device=torch.device(CPU))


def test_nsa_autotune_off_is_bit_identical():
    st = T.preprocess(T.make_stream("traffic", scale=0.01, seed=2))
    base = T.nsa(st, 600, backend="torch", device=CPU)
    for mode in ("off", "cached", "force"):
        tuned = T.nsa(st, 600, backend="torch", device=CPU, autotune=mode)
        np.testing.assert_array_equal(base.t, tuned.t)
        np.testing.assert_array_equal(base.scale_stamp, tuned.scale_stamp)


def test_controller_run_accepts_autotune(tmp_path):
    kw = dict(scale=0.01, seed=3)
    r0 = T.Controller(str(tmp_path / "s1"), device=CPU).run(
        "traffic", 600, _consumer, backend="torch", **kw)
    ctl = T.Controller(str(tmp_path / "s2"), device=CPU)
    r1 = ctl.run("traffic", 600, _consumer, backend="torch",
                 autotune="cached", **kw)
    assert r0.simulated_rows == r1.simulated_rows
    assert counts_only(r0.consumer_metrics) == counts_only(r1.consumer_metrics)
    np.testing.assert_allclose(r1.simulated_volatility.variance,
                               r0.simulated_volatility.variance, rtol=1e-5)
    # the run persisted a winner for every key it dispatched
    entries = ctl.store.get_marker(tuning.TUNE_NAMESPACE, KIND)["entries"]
    assert {k.split("/")[0] for k in entries} == {
        "stream_sample", "compact", "metrics_fused"}
    # and the JAX package's run agrees
    rj = J.Controller(str(tmp_path / "jax")).run("traffic", 600, _consumer,
                                                 **kw)
    assert r1.simulated_rows == rj.simulated_rows
    assert counts_only(r1.consumer_metrics) == rj.consumer_metrics
    np.testing.assert_allclose(r1.simulated_volatility.variance,
                               rj.simulated_volatility.variance, rtol=1e-5)


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("fields", [
    dict(), dict(record_tile=2048, bucket_block=256, grid_split=3),
    dict(record_tile=1000), dict(record_tile=0), dict(bucket_block=200),
    dict(bucket_block=-128), dict(grid_split=0)])
def test_tile_config_validation_is_the_references(fields):
    try:
        want = jtuning.TileConfig(**fields)
    except ValueError:
        with pytest.raises(ValueError):
            TileConfig(**fields)
        return
    got = TileConfig(**fields)
    assert got.as_dict() == want.as_dict()
    assert (got.sublane, got.vmem_bytes()) == (want.sublane,
                                               want.vmem_bytes())
    assert TileConfig.from_dict(want.as_dict()) == got


@pytest.mark.parametrize("kernel,s,n,r", [
    ("metrics_fused", 5, 90000, 86400), ("stream_sample", 1, 1, 0),
    ("compact", 0, 0, 0), ("trend_scan", 18, 87040, 0),
    ("pair_stats", 6, 3600, 0)])
def test_tune_key_is_the_references(kernel, s, n, r):
    got = TuneKey.from_shape(kernel, s=s, n=n, r=r)
    want = jtuning.TuneKey.from_shape(kernel, s=s, n=n, r=r)
    assert got.encode() == want.encode()
    assert TuneKey.decode(want.encode()) == got
    assert jtuning.TuneKey.decode(got.encode()) == want
    with pytest.raises(ValueError):
        TuneKey.from_shape("flash_decode", s=s, n=n)
    assert set(tuning.KERNELS) == set(jtuning.KERNELS)
    assert tuning.AUTOTUNE_MODES == jtuning.AUTOTUNE_MODES
    assert tuning.TUNE_NAMESPACE == jtuning.TUNE_NAMESPACE
    assert set(jtuning.__all__) <= set(tuning.__all__)


def test_cache_file_is_read_by_both_tuners(tmp_path):
    kind = "gpu-nvidia-h100-80gb-hbm3"
    winners = {TuneKey.from_shape("trend_scan", s=6, n=87040):
               TileConfig(record_tile=4096),
               TuneKey.from_shape("metrics_fused", s=18, n=10 ** 6, r=3600):
               TileConfig(record_tile=2048, bucket_block=1024)}
    port_store = T.StreamStore(tmp_path / "port")
    tuner = KernelTuner("force", store=port_store, kind=kind)
    for key, cfg in winners.items():
        tuner._persist(key, cfg)
    ref = jtuning.KernelTuner("cached", store=J.StreamStore(port_store.root),
                              kind=kind)
    got = ref._load_cache()
    assert {k.encode(): c.as_dict() for k, c in got.items()} == {
        k.encode(): c.as_dict() for k, c in winners.items()}

    ref_store = J.StreamStore(tmp_path / "ref")
    jt = jtuning.KernelTuner("force", store=ref_store, kind=kind)
    for key, cfg in winners.items():
        jt._persist(jtuning.TuneKey.decode(key.encode()),
                    jtuning.TileConfig.from_dict(cfg.as_dict()))
    # the reference's 2048-record B2 tile has no instance on a card: the
    # port skips that entry and keeps the others
    jt._persist(jtuning.TuneKey.from_shape("compact", s=1, n=4096),
                jtuning.TileConfig(record_tile=2048))
    port = KernelTuner("cached", store=T.StreamStore(ref_store.root),
                       kind=kind)
    assert port._load_cache() == winners
    raw = json.loads(_cache_file(T.StreamStore(ref_store.root),
                                 kind).read_text())
    assert len(raw["entries"]) == 3 and raw["device_kind"] == kind


@pytest.mark.parametrize("bb", [256, 1024])
def test_plain_metrics_at_other_bucket_blocks_match_pallas(bb):
    from repro.kernels.metrics_fused import (stream_metrics_carry_pallas,
                                             stream_metrics_pallas)
    rng = np.random.default_rng(bb)
    buckets = 3072
    ss = np.sort(rng.integers(0, buckets + 40, (3, 4096)),
                 axis=1).astype(np.int32)   # some stamps past the width
    cfg = jtuning.TileConfig(bucket_block=bb)
    jh, jm = stream_metrics_pallas(jnp.asarray(ss), buckets, interpret=True,
                                   config=cfg)
    lengths = torch.full((3,), 4096, dtype=torch.int32)
    th, tm = tmetrics.stream_metrics_plain(torch.from_numpy(ss), lengths,
                                           buckets, bucket_block=bb)
    assert np.array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    # through the kernel wrapper with a config, on the CPU
    kh, km = tmetrics.stream_metrics(torch.from_numpy(ss), lengths, buckets,
                                     config=TileConfig(bucket_block=bb))
    assert torch.equal(kh, th) and torch.equal(km, tm)

    base = 700
    mcar = rng.normal(0.0, 50.0, (3, 4)).astype(np.float32)
    jh, jm = stream_metrics_carry_pallas(jnp.asarray(ss), jnp.asarray(mcar),
                                         buckets, interpret=True, config=cfg)
    th, tm = tmetrics.stream_metrics_carry_plain(
        torch.from_numpy(ss + base), lengths, buckets,
        torch.from_numpy(mcar), base, bucket_block=bb)
    assert np.array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tm.numpy()[:, ::2], np.asarray(jm)[:, ::2],
                               rtol=1e-5)


def test_ops_pad_histograms_to_the_config_block():
    # the returned widths stay max_range; the kernel sees a multiple of
    # the config's bucket block
    seen = []
    real = tmetrics.stream_metrics

    def spy(ss, lengths, buckets, *, config=None):
        seen.append((buckets, config.bucket_block))
        return real(ss, lengths, buckets, config=config)

    class _Tuner(KernelTuner):
        def config_for(self, kernel, **kw):
            return TileConfig(record_tile=2048, bucket_block=1024)

    rng = np.random.default_rng(4)
    rows = [np.sort(rng.integers(0, 600, n)) for n in (50, 900)]
    h0, m0, _ = ops.stream_metrics_batched(rows, 600, device=CPU)
    ops._stream_metrics_kernel, saved = spy, ops._stream_metrics_kernel
    try:
        with tuning.use(_Tuner("off")):
            h1, m1, _ = ops.stream_metrics_batched(rows, 600, device=CPU)
    finally:
        ops._stream_metrics_kernel = saved
    assert seen == [(1024, 1024)]
    assert h1.shape == (2, 600) and torch.equal(h0, h1)
    torch.testing.assert_close(m1, m0, rtol=1e-5, atol=0.0)


def test_lattice_is_the_ports_instances():
    key = TuneKey.from_shape("metrics_fused", s=18, n=10 ** 7, r=3600)
    cands = tuning.candidate_lattice(key, "gpu-h100")
    assert cands[0] == tuning.heuristic_config(key, "gpu-h100")
    assert set(cands) == set(tuning.instances("metrics_fused"))
    # tiles wider than the padded problem never run: a 3000-record stream
    # keeps B1's 1024 and 2048 instances
    small = tuning.candidate_lattice(
        TuneKey.from_shape("stream_sample", s=1, n=1500, r=60), "gpu-h100")
    assert [c.record_tile for c in small] == [2048, 1024]
    builds = tuning.lattice_builds()
    assert ("metrics_fused", ()) in builds and len(builds) == len(set(builds))
    assert {name for name, _ in builds} == {
        "stream_sample", "compact", "metrics_fused", "trend_scan",
        "pair_stats"}
    assert len([b for b in builds if b[0] == "metrics_fused"]) == 9
