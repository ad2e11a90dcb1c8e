"""The nine-day deployment (``ub-9day``) on the CPU at a small scale: its
configuration's shape, what one job stores and replays, faults planted at
its day boundaries, each not correct, and the readers of the chunk feed's
waits."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

from stream_bench import bench

SCALE = 0.005
SEED = 2**31 + 21
CELL = "ub-9day.r3600"
DAYS, RANGE, CHUNK_S = 9, 3600, 600
SCENARIO = ("userbehavior", RANGE)


def test_configuration_is_the_chunked_one_over_nine_days():
    spec = bench.load_spec()
    cell = bench.cell_of(spec, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("ub-9day", "r3600", 1)
    cfg = bench.load_data("configs", "ub-9day")
    chunked = bench.load_data("configs", "paper-grid-chunked")
    assert cfg["entry"] == "run_many" and cfg["scale"] == 1.0
    assert cfg["reduced"] == []
    assert list(cfg["datasets"]) == ["userbehavior"]
    ub = dict(cfg["datasets"]["userbehavior"])
    assert ub.pop("days") == DAYS
    one_day = dict(bench.load_data("configs", "ub-day")["datasets"]
                   ["userbehavior"])
    assert one_day.pop("days") == 1
    ub.pop("table"), one_day.pop("table")
    assert ub == one_day
    assert cfg["knobs"] == chunked["knobs"] and \
        cfg["knobs"]["chunk_s"] == CHUNK_S
    assert cfg["guarantees"] == chunked["guarantees"]
    assert cfg["limits"] == chunked["limits"] and \
        cfg["limits"]["feed_hwm"] == 2
    assert bench.load_data("configs", "ub-9day")["source"] == next(
        c["source"] for c in spec["configs"] if c["name"] == "ub-9day")


def test_a_job_stores_54_chunks_and_replays_32400_buckets():
    cell = bench.Cell(CELL, SEED, "cpu", SCALE)
    try:
        assert cell.knobs["duration_s"] == DAYS * 86_400
        assert cell.key_suffix == f"__d{DAYS * 86_400}"
        cell.set_up()
        job = cell.run_job(0, full=True)
        assert job.error is None
        (files,) = job.stored.values()
        assert [p.name for p in files] == [
            f"columns.{i:05d}.npz" for i in range(DAYS * RANGE // CHUNK_S)]
        (slot,) = job.slots
        # one bucket a second of the nine compressed days, in order, up to
        # the last (at this scale some are empty)
        assert slot.stamps.min() >= 0 and \
            slot.stamps.max() == DAYS * RANGE - 1
        assert np.all(np.diff(slot.stamps) > 0)
        assert len(slot.stamps) > DAYS * RANGE // 2
        (rep,) = job.reports
        assert rep.simulated_volatility.time_range == DAYS * RANGE
        assert rep.consumer_metrics["feed_chunks"] == DAYS * RANGE // CHUNK_S
        assert 1 <= rep.consumer_metrics["feed_hwm_chunks"] <= 2
        exp = cell.expected()
        assert exp.reports[SCENARIO]["original_rows"] == \
            rep.original_rows == cell.records["userbehavior"]
    finally:
        cell.close()


def _swap_across_day_boundary(orig):
    """Once the manifest is written: the last kept record of day 0's last
    chunk and the first of day 1's first chunk trade places, in the
    files only."""
    def f(self, key, **kw):
        orig(self, key, **kw)
        d = self.root / key
        a, b = d / "columns.00005.npz", d / "columns.00006.npz"
        with np.load(a) as za, np.load(b) as zb:
            ca = {k: za[k].copy() for k in za.files}
            cb = {k: zb[k].copy() for k in zb.files}
        for k in ca:
            ca[k][-1], cb[k][0] = cb[k][0].copy(), ca[k][-1].copy()
        for path, cols in ((a, ca), (b, cb)):
            with open(path, "wb") as fh:
                np.savez(fh, **cols)
    return f


def _carry_restarted_each_day(orig):
    """B6's carry starts afresh at every day boundary of the timeline."""
    def f(carry, ss, valid_counts, lo, hi):
        from repro_torch.kernels import ops
        if lo and lo % RANGE == 0:
            carry = dataclasses.replace(ops.chunk_carry_init(
                carry.hist.shape[0], carry.hist.shape[1], carry.window,
                device=carry.hist.device), next_lo=carry.next_lo)
        return orig(carry, ss, valid_counts, lo, hi)
    return f


#: (owner module, attribute, fault, the checks of which one must fail)
FAULTS = {
    "record_swapped_across_a_day": (
        "repro_torch.streamsim.store", "StreamStore.finalize_chunks",
        _swap_across_day_boundary, ("sims_bad",)),
    "carry_restarted_each_day": (
        "repro_torch.kernels.ops", "stream_metrics_chunk",
        _carry_restarted_each_day, ("vol_rel", "trend_gap")),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_day_boundary_fault_is_not_correct(fault, monkeypatch):
    import importlib
    module, path, make, checks = FAULTS[fault]
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = bench.run_cell(CELL, SEED, 0.0, False, device="cpu", scale=SCALE)
    assert not out["correct"]
    assert out["failed"] == 0
    assert any(out["checks"][c]["value"] > out["checks"][c]["limit"]
               for c in checks), out["checks"]


def _run(*jobs):
    return types.SimpleNamespace(jobs=[types.SimpleNamespace(reports=[
        types.SimpleNamespace(consumer_metrics=m) for m in job])
        for job in jobs])


@pytest.mark.parametrize("name,counter", [("feed_wait_s", "feed_get_wait_s"),
                                          ("feed_block_s",
                                           "feed_put_wait_s")])
def test_feed_readers_sum_a_job_and_average_the_jobs(name, counter):
    read = bench.load_reader(name)
    # a monolithic job's reports, or a program that does not count
    assert read(_run([{"put_wait_s": 0.5}])) is None
    assert read(_run()) is None
    assert read(_run([{counter: 0.25}, {}])) is None
    assert read(_run([{counter: 0.25}, {counter: 0.5}],
                     [{counter: 0.25}])) == 0.5
