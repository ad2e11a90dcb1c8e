"""The per-layer metrics that read the program's own spans and counters
(``repro_torch.tracing``, ``StreamQueue``'s waits), on the CPU: a traced
run of each cell, with every per-layer metric read, reads the four of
every path, each inside the metric of the layer around it, and the
chunked runner's three legs where a cell runs it and nowhere else; where
the program keeps no such spans or counters, the readers find nothing and
raise nothing."""

from __future__ import annotations

import sys
import types

import pytest

from stream_bench import bench, trace
from stream_bench.test_stream_bench_harness import spec_with_posd

SCALE = 0.005
SEED = 2**31 + 11
SPAN_READERS = ("nsa_host_s", "store_write_s", "report_s")
CHUNK_READERS = ("chunk_dispatch_s", "chunk_host_leg_s", "chunk_event_wait_s")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec_with_posd()["workloads"]])
def test_traced_run_reads_the_program_spans(cell, monkeypatch):
    spec = spec_with_posd()
    every = spec["per_layer"]
    listed = {x["name"] for x in bench.metrics_of(spec, cell, True)}
    monkeypatch.setattr(bench, "load_spec", spec_with_posd)
    monkeypatch.setattr(bench, "metrics_of",
                        lambda spec, name, traced: every if traced else [])
    entry = bench.cell_of(spec, cell)
    config = bench.load_data("configs", entry["config"])
    posd = bool(bench.load_data("traffic", entry["traffic"]).get("posd"))
    out = bench.run_cell(cell, SEED, 0.2, True, device="cpu", scale=SCALE)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_READERS) | {"queue_wait_s"} <= set(m)
    assert 0 < m["nsa_host_s"]
    assert 0 < m["report_s"]
    chunked = bool(config["knobs"].get("chunk_s"))
    if chunked:
        # the chunk files are written in the host legs; nothing
        # materializes the sims whole, and the report's produce_s holds
        # the whole chunk pipeline, so no replay layer reads it
        assert set(CHUNK_READERS) <= set(m)
        assert not {"produce_s", "nsa_s", "materialize_s",
                    "sweep_produce_s", "sweep_nsa_s",
                    "sweep_materialize_s"} & listed
        assert 0 <= m["queue_wait_s"] <= out["device"]["window_s"]
        assert 0 < m["store_write_s"] <= m["chunk_host_leg_s"]
        assert 0 <= m["chunk_event_wait_s"] <= m["chunk_host_leg_s"]
        assert 0 < m["chunk_dispatch_s"]
        assert "materialize_s" not in m
    else:
        assert not set(CHUNK_READERS) & set(m)
        assert 0 <= m["queue_wait_s"] <= m["produce_s"]
        assert m["nsa_host_s"] <= m["nsa_s"]
        # where the job runs POSD, the original's write is in the job too
        assert 0 < m["store_write_s"]
        assert posd or m["store_write_s"] <= m["materialize_s"]
    assert ("posd_s" in m) == posd
    # the program's spans take no name of the harness's: its breakdown
    # reads as before
    from repro_torch import tracing
    names = {r.name for r in tracing.drain()}
    assert "nsa.host_tables" in names
    assert (set(trace.PROGRAM_SPANS) <= names) == chunked
    assert not names & (set(trace.LAYER_SPANS) | set(bench.BENCH_SPANS))


def _run(jobs, ranges):
    trace = types.SimpleNamespace(ranges=ranges)
    return types.SimpleNamespace(jobs=jobs, device_trace=trace)


@pytest.mark.parametrize("name", SPAN_READERS + CHUNK_READERS)
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
