"""The per-layer metrics that read the program's own spans and counters
(``repro_torch.tracing``, ``StreamQueue``'s waits), on the CPU: a traced
run of each cell reads all four, each inside the metric of the layer
around it; where the program keeps no such spans or counters, the readers
find nothing and raise nothing."""

from __future__ import annotations

import sys
import types

import pytest

from stream_bench import bench, trace

SCALE = 0.005
SEED = 2**31 + 11
SPAN_READERS = ("nsa_host_s", "store_write_s", "report_s")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.load_spec()["workloads"]])
def test_traced_run_reads_the_program_spans(cell):
    out = bench.run_cell(cell, SEED, 0.2, True, device="cpu", scale=SCALE)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_READERS) | {"queue_wait_s"} <= set(m)
    assert 0 < m["nsa_host_s"] <= m["nsa_s"]
    assert 0 < m["store_write_s"] <= m["materialize_s"]
    assert 0 < m["report_s"]
    assert 0 <= m["queue_wait_s"] <= m["produce_s"]
    # the program's spans take no name of the harness's: its breakdown
    # reads as before
    from repro_torch import tracing
    names = {r.name for r in tracing.drain()}
    assert "nsa.host_tables" in names
    assert not names & (set(trace.LAYER_SPANS) | set(bench.BENCH_SPANS))


def _run(jobs, ranges):
    trace = types.SimpleNamespace(ranges=ranges)
    return types.SimpleNamespace(jobs=jobs, device_trace=trace)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_find_nothing_without_the_tracer(name, monkeypatch):
    import repro_torch
    read = bench.load_reader(name)
    run = _run([], [("bench.entry", 0.0, 1e18)])
    # a program without a tracer
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(run) is None
    monkeypatch.undo()
    assert read(_run([], [])) is None         # no job in the trace


def test_queue_wait_finds_nothing_without_the_counter():
    read = bench.load_reader("queue_wait_s")
    report = types.SimpleNamespace(consumer_metrics={"records_in": 3})
    job = types.SimpleNamespace(reports=[report])
    assert read(_run([job], [])) is None
    report.consumer_metrics["put_wait_s"] = 0.25
    assert read(_run([job, job], [])) == 0.25
