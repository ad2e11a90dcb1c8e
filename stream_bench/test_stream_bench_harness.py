"""The harness driven end to end on the CPU at a small scale: every cell
comes out correct, its metrics named as ``BENCHMARK.json`` names them, and
each fault planted underneath the timed path comes out not correct. The
harness's look for a card is skipped (``run_cell(device="cpu")``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from stream_bench import bench

SCALE = 0.005
SEED = 2**31 + 5


def _run(cell, traced=False, seconds=0.2):
    return bench.run_cell(cell, SEED, seconds, traced, device="cpu",
                          scale=SCALE)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.load_spec()["workloads"]])
def test_cell_runs_correct_on_cpu(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in bench.metrics_of(bench.load_spec(), cell,
                                                False)}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_traced_run_reads_the_span_metrics_on_cpu():
    out = _run("paper-grid.sweep", traced=True)
    assert out["correct"]
    spans = {"original_load_s", "nsa_s", "fidelity_s", "materialize_s",
             "produce_s"}
    assert spans <= set(out["metrics"])
    # no device operation ran: the device's metrics find nothing to read
    assert "device_idle" not in out["metrics"]
    assert "kernel_roofline" not in out["metrics"]


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
}


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
