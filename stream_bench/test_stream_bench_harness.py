"""The harness driven end to end on the CPU at a small scale: every cell
comes out correct, its metrics named as ``BENCHMARK.json`` names them, and
each fault planted underneath the timed path comes out not correct. The
harness's look for a card is skipped (``run_cell(device="cpu")``)."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from unittest import mock

import numpy as np
import pytest

from stream_bench import bench
from stream_bench.reference import generators

SCALE = 0.005
SEED = 2**31 + 5
CHUNKED = "paper-grid-chunked.c600"
_ONE_DAY = ["sims_bad", "replay_bad", "rows_bad", "vol_rel", "trend_gap"]
#: a cell of traffic ``posd`` (POSD and the original's write in every
#: job), which ``BENCHMARK.json`` does not run (PERF.md, section 7)
POSD = "ub-day.posd"
_load_spec = bench.load_spec


def spec_with_posd(root=bench.ROOT):
    """``BENCHMARK.json`` with the cell :data:`POSD` added, reporting what
    ``ub-day.r3600`` reports and ``posd_s``."""
    spec = _load_spec(root)
    spec["workloads"].append({"name": POSD, "config": "ub-day",
                              "traffic": "posd", "chips": 1,
                              "why": "POSD in the job"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ub-day.r3600" in m.get("workloads", []):
            m["workloads"].append(POSD)
    spec["per_layer"].append({"name": "posd_s", "unit": "s",
                              "better": "lower", "source": "program_span",
                              "layer": "POSD", "moves": "first_bucket_s",
                              "workloads": [POSD]})
    return spec


def check_keys(cell):
    """The numbers the cell's checks print, in order, from its data: the
    day's five, ``fidelity_gap`` where the entry gives fidelity matrices,
    ``feed_hwm`` where the configuration limits it, ``orig_bad`` where the
    traffic runs POSD in the job."""
    entry = bench.cell_of(spec_with_posd(), cell)
    config = bench.load_data("configs", entry["config"])
    traffic = bench.load_data("traffic", entry["traffic"])
    return _ONE_DAY + ["fidelity_gap"] * (config["entry"] == "run_many") + \
        ["feed_hwm"] * ("feed_hwm" in config["limits"]) + \
        ["orig_bad"] * bool(traffic.get("posd"))


def _run(cell, traced=False, seconds=0.2):
    with mock.patch.object(bench, "load_spec", spec_with_posd):
        return bench.run_cell(cell, SEED, seconds, traced, device="cpu",
                              scale=SCALE)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec_with_posd()["workloads"]])
def test_cell_runs_correct_on_cpu(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in bench.metrics_of(spec_with_posd(), cell,
                                                False)}
    # the card's memory peak finds nothing to read without a card
    assert set(out["metrics"]) == want - {"device_peak_bytes"}
    assert list(out)[-1] == "checks"
    assert list(out["checks"]) == check_keys(cell)
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_check_keys_follow_the_cells_data():
    """The keys a cell prints come from its configuration and traffic, so a
    cell added later needs no table here."""
    assert check_keys("ub-day.r3600") == _ONE_DAY
    assert check_keys("paper-grid.sweep") == _ONE_DAY + ["fidelity_gap"]
    assert check_keys(CHUNKED) == check_keys("ub-9day.r3600") == \
        _ONE_DAY + ["fidelity_gap", "feed_hwm"]
    assert check_keys(POSD) == _ONE_DAY + ["orig_bad"]


def test_traced_posd_run_reads_posd_s_once_a_job_on_cpu(monkeypatch):
    """POSD inside the job: one ``bench.posd`` span a job of the window,
    read by ``posd_s``."""
    seen = {}
    close = bench.Cell.close

    def keep(self):
        seen["spans"] = [s for s in self.tracer.records
                         if s[0] == "bench.posd"]
        close(self)

    monkeypatch.setattr(bench.Cell, "close", keep)
    out = _run(POSD, traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["posd_s"]["value"] > 0
    assert sorted(job for _, job, _, _ in seen["spans"]) == \
        list(range(out["attempted"]))


@pytest.mark.parametrize("cell,links", [("ub-day.r3600", 2), (POSD, 1)])
def test_original_is_linked_or_written_in_the_job(cell, links, monkeypatch):
    """The entry reads an original hard-linked from set-up's template, or,
    where the job runs POSD, one the job wrote itself."""
    from repro_torch.streamsim.store import StreamStore
    got = []
    get = StreamStore.get

    def counted(self, key):
        if "__orig" in key:
            got.append(os.stat(self.root / key / "columns.npz").st_nlink)
        return get(self, key)

    monkeypatch.setattr(StreamStore, "get", counted)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert got and set(got) == {links}


def test_traced_run_reads_the_span_metrics_on_cpu():
    out = _run("paper-grid.sweep", traced=True)
    assert out["correct"]
    spans = {"sweep_original_load_s", "sweep_nsa_s", "fidelity_s",
             "sweep_materialize_s", "sweep_produce_s", "sweep_job_s",
             "sweep_first_bucket_s"}
    assert spans <= set(out["metrics"])
    # no device operation ran: the device's metrics find nothing to read
    assert "sweep_device_idle" not in out["metrics"]
    assert "sweep_kernel_roofline" not in out["metrics"]


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    spec = bench.load_spec()
    for w in spec["workloads"]:
        e2e = {m["name"] for m in bench.metrics_of(spec, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.metrics_of(spec, w["name"], True)
        assert layer
        assert all(m["moves"] in e2e for m in layer), w["name"]


def _sweep_twins():
    return [m["name"] for m in bench.load_spec()["per_layer"]
            if m["name"].startswith("sweep_")]


@pytest.mark.parametrize("twin", _sweep_twins())
def test_sweep_metric_reads_what_its_cells_metric_reads(twin):
    """A sweep cell's per-layer metric is its ub-day twin's reader."""
    base = twin[len("sweep_"):]
    assert bench.load_reader(twin).__code__.co_filename == \
        bench.load_reader(base).__code__.co_filename
    run = bench.Run(None, 1.0, 2.0, [], [], None, [])
    assert bench.load_reader(twin)(run) == bench.load_reader(base)(run)


def test_device_peak_reads_the_card_and_nothing_without_one():
    read = bench.load_reader("device_peak_bytes")
    run = bench.Run(None, 1.0, 2.0, [], [], None, [])
    assert read(run) is None
    run.memory_peak_bytes = 1_838_203_392
    assert read(run) == 1_838_203_392


def _keep_all(orig):
    def f(ts, max_range, mults, **kw):
        ss, keep, lengths = orig(ts, max_range, mults, **kw)
        import torch
        idx = torch.arange(keep.shape[1], device=keep.device)[None, :]
        lens = torch.as_tensor(np.asarray(lengths), device=keep.device)
        return ss, (idx < lens[:, None]).to(keep.dtype), lengths
    return f


def _half_rows(orig):
    def f(ss, valid_counts, max_range):
        return orig(ss, np.asarray(valid_counts) // 2, max_range)
    return f


def _stamp_off(orig):
    def f(*args, **kw):
        out = orig(*args, **kw)
        sim = next(iter(out.values()))
        sim.scale_stamp[0] += 1
        return out
    return f


def _drop_buckets(orig):
    seen = {"n": 0}

    def f(self, bucket, *args, **kw):
        seen["n"] += 1
        if seen["n"] % 7 == 3:
            return None
        return orig(self, bucket, *args, **kw)
    return f


def _nudge(orig, by=1e-2):
    def f(*args, **kw):
        return np.asarray(orig(*args, **kw)) + by
    return f


def _chunk_record_off(orig):
    """One record of the second chunk altered in the file only: the replay
    gets the chunk as it was."""
    def f(self, key, chunk_idx, stream, *args, **kw):
        if chunk_idx == 1 and len(stream):
            t = stream.t.copy()
            t[0] += 0.25
            stream = dataclasses.replace(stream, t=t)
        return orig(self, key, chunk_idx, stream, *args, **kw)
    return f


def _after_finalize(act):
    """Act on a stream's chunk files once its manifest is written."""
    def make(orig):
        def f(self, key, **kw):
            orig(self, key, **kw)
            if kw["n_chunks"] > 1:
                act(self.root / key)
        return f
    return make


def _swap(d):
    a, b = d / "columns.00000.npz", d / "columns.00001.npz"
    os.replace(a, d / "swap.tmp")
    os.replace(b, a)
    os.replace(d / "swap.tmp", b)


def _delete(d):
    (d / "columns.00001.npz").unlink()


def _feed_over(orig):
    def f(self):
        return dict(orig(self), feed_hwm_chunks=3)
    return f


def _no_shift(orig):
    def f(t, *, tz_offset_s=0.0):
        return t
    return f


def _dropped_payload_off(orig):
    """One payload value of a record that NSA at 3600 s drops, altered in
    the stored original only: the entry reads it back and drops it."""
    def f(self, key, stream, *args, **kw):
        if "__orig" in key:
            from stream_bench.reference import simulate
            kept = simulate.nsa(stream.t, {}, 3600)["t"]
            i = int(np.flatnonzero(~np.isin(stream.t, kept))[0])
            name = sorted(stream.payload)[0]
            col = stream.payload[name].copy()
            col[i] += 1
            stream = dataclasses.replace(
                stream, payload=dict(stream.payload, **{name: col}))
        return orig(self, key, stream, *args, **kw)
    return f


#: (cell, owner module, attribute, fault, the check it must fail)
FAULTS = {
    "state_unchanged": ("ub-day.r600", "repro_torch.kernels.ops",
                        "stream_sample_batched", _keep_all, "sims_bad"),
    "half_the_batch": ("ub-day.r600", "repro_torch.kernels.ops",
                       "stream_metrics_batched_device", _half_rows,
                       "vol_rel"),
    "stamp_altered": ("ub-day.r3600", "repro_torch.streamsim.engine",
                      "materialize_sweep", _stamp_off, "sims_bad"),
    "bucket_lost": ("paper-grid.sweep", "repro_torch.streamsim.queue",
                    "StreamQueue.put", _drop_buckets, "replay_bad"),
    "trend_altered": ("ub-day.r600", "repro_torch.kernels.ops",
                      "trend_corr_pairwise", _nudge, "trend_gap"),
    "fidelity_altered": ("paper-grid.sweep", "repro_torch.kernels.ops",
                         "trend_correlation_batched_device", _nudge,
                         "fidelity_gap"),
    "chunk_record_altered": (CHUNKED, "repro_torch.streamsim.store",
                             "StreamStore.append_chunk", _chunk_record_off,
                             "sims_bad"),
    "chunk_files_swapped": (CHUNKED, "repro_torch.streamsim.store",
                            "StreamStore.finalize_chunks",
                            _after_finalize(_swap), "sims_bad"),
    "chunk_file_deleted": (CHUNKED, "repro_torch.streamsim.store",
                           "StreamStore.finalize_chunks",
                           _after_finalize(_delete), "sims_bad"),
    "feed_over_its_bound": (CHUNKED, "repro_torch.streamsim.producer",
                            "ChunkFeed.stats", _feed_over, "feed_hwm"),
    "bucket_lost_half_day": ("ub-day.r43200", "repro_torch.streamsim.queue",
                             "StreamQueue.put", _drop_buckets, "replay_bad"),
    "posd_zone_unshifted": (POSD, "repro_torch.streamsim.preprocess",
                            "unify_timezone", _no_shift, "orig_bad"),
    "orig_dropped_record_altered": (POSD, "repro_torch.streamsim.store",
                                    "StreamStore.put", _dropped_payload_off,
                                    "orig_bad"),
}
#: fault -> numbers it must read exactly
EXACT = {"orig_dropped_record_altered": {"orig_bad": 1, "sims_bad": 0,
                                         "replay_bad": 0}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    import importlib
    cell, module, path, make, check = FAULTS[fault]
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = _run(cell, seconds=0.0)
    assert not out["correct"]
    c = out["checks"][check]
    assert c["value"] > c["limit"], out["checks"]
    for k, v in EXACT.get(fault, {}).items():
        assert out["checks"][k]["value"] == v, out["checks"]


def _record_off(orig):
    def f(self, bucket, *args, **kw):
        if len(bucket):
            bucket = dataclasses.replace(bucket, t=bucket.t + 0.25)
        return orig(self, bucket, *args, **kw)
    return f


#: (cell, owner module, attribute, fault, the check it must fail): faults
#: that leave the window's first job, checked whole, alone
LATE_FAULTS = {
    "stored_stamp_altered": ("ub-day.r600", "repro_torch.streamsim.engine",
                             "materialize_sweep", _stamp_off, "sims_bad"),
    "delivered_record_altered": ("ub-day.r3600",
                                 "repro_torch.streamsim.queue",
                                 "StreamQueue.put", _record_off,
                                 "replay_bad"),
    "stored_chunks_swapped": (CHUNKED, "repro_torch.streamsim.store",
                              "StreamStore.finalize_chunks",
                              _after_finalize(_swap), "sims_bad"),
    "stored_original_altered": (POSD, "repro_torch.streamsim.store",
                                "StreamStore.put", _dropped_payload_off,
                                "orig_bad"),
}


@pytest.mark.parametrize("fault", sorted(LATE_FAULTS))
def test_fault_in_a_later_job_fails_its_digest(fault, monkeypatch):
    """Jobs after the first keep digests only; a record that differs from
    the first job's in any of them is not correct."""
    import importlib
    cell, module, path, make, check = LATE_FAULTS[fault]
    job = {"index": -1}
    run_job = bench.Cell.run_job

    def tracked(self, index, full=False):
        job["index"] = index
        return run_job(self, index, full)

    def two_jobs(self, seconds):
        """The window with two jobs, however long they take."""
        return [self.run_job(0, full=True), self.run_job(1)], 1.0

    monkeypatch.setattr(bench.Cell, "run_job", tracked)
    monkeypatch.setattr(bench.Cell, "window", two_jobs)
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    orig = getattr(owner, attr)
    bad = make(orig)

    def late(*args, **kw):
        return (bad if job["index"] >= 1 else orig)(*args, **kw)

    monkeypatch.setattr(owner, attr, late)
    out = _run(cell, seconds=0.0)
    assert out["attempted"] == 2
    assert not out["correct"]
    c = out["checks"][check]
    assert c["value"] > c["limit"], out["checks"]
    if check == "orig_bad":
        # the later job's original is counted in full, and nothing else
        # it produced differs
        config = bench.load_data("configs", bench.cell_of(
            spec_with_posd(), cell)["config"])
        day = generators.make(config["datasets"]["userbehavior"], SCALE,
                              SEED)
        assert c["value"] == len(day["timestamp"])
        assert out["checks"]["sims_bad"]["value"] == 0


def test_delivered_digest_samples_the_same_buckets_every_job():
    """A queue's digest covers its first and last bucket and a sample drawn
    from the seed, the same in every job; a short queue is digested
    whole."""
    from repro_torch.streamsim.queue import Bucket

    def queue(n, off=None):
        return [Bucket(i, np.arange(3.0) + i + (0.5 if i == off else 0.0),
                       {"x": np.arange(3) * i}, 0.0) for i in range(n)]

    got = bench.Delivered.of(queue(500), 7, False)
    assert got.digest == bench.Delivered.of(queue(500), 7, False).digest
    assert list(got.counts) == [3] * 500 and list(got.stamps) == \
        list(range(500))
    for off in (0, 499):
        assert got.digest != bench.Delivered.of(queue(500, off), 7,
                                                False).digest
    n = bench.SAMPLE + 2
    whole = bench.Delivered.of(queue(n), 7, False)
    assert all(whole.digest != bench.Delivered.of(queue(n, i), 7,
                                                  False).digest
               for i in range(n))


def test_two_day_chunked_source_is_correct(tmp_path):
    """A configuration whose datasets run two days: set-up stores the
    frozen generators' two days under the key the program's multi-day
    sweep reads, the entry gets ``duration_s``, and the reference
    compresses each day into ``max_range`` buckets. The program, had it
    made its own days, would read not correct."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.BENCH, root / "stream_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    cfg = bench.load_data("configs", "paper-grid-chunked")
    cfg["name"] = "grid-2day"
    cfg["datasets"] = {d: dict(s, days=2) for d, s in cfg["datasets"].items()
                       if d != "userbehavior"}
    (root / "stream_bench" / "configs" / "grid-2day.json").write_text(
        json.dumps(cfg))
    (root / "stream_bench" / "traffic" / "r300-900.json").write_text(
        json.dumps({"max_ranges": [300, 900]}))
    spec = bench.load_spec()
    spec["workloads"].append({"name": "grid-2day.c600", "config": "grid-2day",
                              "traffic": "r300-900", "chips": 1,
                              "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = bench.Cell("grid-2day.c600", SEED, "cpu", SCALE, root)
    cell.close()
    assert cell.knobs["duration_s"] == 2 * 86_400
    assert cell.key_suffix == "__d172800"
    out = bench.run_cell("grid-2day.c600", SEED, 0.0, False, device="cpu",
                         scale=SCALE, root=root)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert 1 <= out["checks"]["feed_hwm"]["value"] <= 2
