"""The benchmark of the stream simulator's port, driven by data.

A cell of ``BENCHMARK.json`` names a configuration
(``stream_bench/configs/<config>.json``: the recorded streams, their
scale, the entry of the program, its knobs, the guarantees, the limits of
the comparison) and a traffic mix (``stream_bench/traffic/<traffic>.json``:
the compressed ranges each job simulates; with ``"posd": true`` a job
that preprocesses and stores the raw streams itself). Every metric is a
reader of its own, ``stream_bench/metrics/<metric>.py``, with a
``read(run)`` that takes a :class:`Run` and returns a number, or None
where it finds nothing to read. Adding a cell, a mix or a metric adds
files and entries; no file of the harness changes.

One run:

1. Set-up: import the program, make the raw streams from the seed with the
   frozen generators, hand them to the program's ``preprocess`` and
   ``StreamStore.put`` under the keys ``Controller.prepare`` reads (where
   the configuration's datasets run ``days`` N > 1, the key
   ``Controller._prepare_multiday`` reads, and the entry gets
   ``duration_s`` N days), into a template store under ``TMPDIR``, and run
   one untimed job (it builds or loads the kernels and warms every shape).
   Where the traffic runs POSD inside the job, set-up makes the raw
   streams only, and the untimed job stores them as every job does.
2. The window: jobs back to back until the seconds have passed; the job in
   flight is finished and counted. A job gets a fresh store whose
   originals are hard links into the template (no original byte is
   written again), or, where the traffic runs POSD inside the job, hands
   each raw stream to ``preprocess`` (the span ``bench.posd``) and
   ``StreamStore.put`` from the call on; it calls the configuration's
   entry with its knobs (which reads the originals back), drains
   the replay into the benchmark's consumer, and deletes its store. Of
   what it produced it keeps its reports and matrices, each bucket's
   stamp and count, its feed's high-water mark where it replayed chunk by
   chunk, a digest of the records of a sample of buckets drawn from the
   seed and one of each stored sim's files (its ``columns.npz``, or its
   chunk files in order), and of each original it stored itself; the
   window's first job keeps its records and stored streams whole.
3. The check: the plain reference works out the job's outputs from the
   same raw streams, and every job is compared with it
   (:mod:`stream_bench.judge`): the first job record for record, the
   others through their digests, which must be the first job's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from stream_bench import judge, roofline, trace
from stream_bench.reference import generators, simulate

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: host ranges the device trace labels idle time with, besides the layers
BENCH_SPANS = ("bench.window", "bench.job_setup", "bench.entry",
               "bench.posd", "bench.job_check", "bench.job_delete")


# ---------------------------------------------------------------- the spec
def load_spec(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_data(kind: str, name: str, bench: Path = BENCH) -> Dict:
    """``stream_bench/<kind>/<name>.json``."""
    with open(bench / kind / f"{name}.json") as f:
        return json.load(f)


def cell_of(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(spec: Dict, cell: str, traced: bool) -> List[Dict]:
    """The cell's metric entries: its end-to-end metrics in a plain run,
    its per-layer metrics in a traced one."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_reader(name: str, bench: Path = BENCH):
    """The ``read`` function of ``stream_bench/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"stream_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------- consumer
#: buckets of a queue, besides its first and last, whose records every job
#: digests (drawn from the seed; the same in every job of a run)
SAMPLE = 64


@dataclasses.dataclass
class Delivered:
    """What one queue delivered: each bucket's scale stamp and record
    count, a digest of the records of the first, the last and
    :data:`SAMPLE` buckets drawn from the seed, and, where the job is
    checked in full, the buckets themselves."""

    stamps: np.ndarray
    counts: np.ndarray
    digest: str
    buckets: Optional[list] = None

    @classmethod
    def of(cls, buckets: list, seed: int, keep: bool) -> "Delivered":
        n = len(buckets)
        pick = range(n) if n <= SAMPLE + 2 else np.unique(np.concatenate([
            [0, n - 1], np.random.default_rng([seed & (2**64 - 1), n])
            .choice(np.arange(1, n - 1), SAMPLE, replace=False)]))
        h = hashlib.sha1()
        for i in pick:
            b = buckets[int(i)]
            h.update(b"%d:%d;" % (int(i), len(b)))
            h.update(np.ascontiguousarray(b.t))
            for k in sorted(b.payload):
                h.update(np.ascontiguousarray(b.payload[k]))
        return cls(np.array([b.scale_stamp for b in buckets], np.int64),
                   np.array([len(b) for b in buckets], np.int64),
                   h.hexdigest(), buckets if keep else None)


class Consumer:
    """Drains replay queues, one thread per scenario in ``run_many``; keeps
    each queue's buckets for the job and the time its first bucket came.
    Digests are taken after the job, so that the replay's threads do no
    more than a consumer that takes its buckets."""

    def __init__(self):
        self.lock = threading.Lock()
        self.first: Optional[float] = None
        self.slots: List[list] = []

    def __call__(self, queue) -> Dict:
        got = []
        for bucket in queue:
            if not got:
                now = time.perf_counter()
                with self.lock:
                    if self.first is None or now < self.first:
                        self.first = now
            got.append(bucket)
        with self.lock:
            slot = len(self.slots)
            self.slots.append(got)
        return {"bench_slot": slot}


def _columns_of(buckets) -> Dict[str, np.ndarray]:
    cols = {"t": np.concatenate([b.t for b in buckets]) if buckets
            else np.empty(0)}
    for k in (buckets[0].payload if buckets else {}):
        cols[k] = np.concatenate([b.payload[k] for b in buckets])
    return cols


# --------------------------------------------------------------------- job
@dataclasses.dataclass
class Job:
    """One job of the window."""

    index: int
    t_call: float            # host clock at the call into the entry
    t_first: Optional[float]  # at the consumer's first bucket
    t_end: float             # at the end of the job, its store deleted
    calls: List[list]        # the entry's reports, a list a call
    fidelity: list           # the FidelityReports of a run_many
    slots: List[Delivered]   # what the consumer got, one a queue
    #: scenario -> the stored sim's digest, None where none was stored
    stored_digest: Dict[Tuple[str, int], Optional[tuple]]
    #: scenario -> the stored sim's files kept whole (None where none was
    #: stored), in the job checked in full
    stored: Optional[Dict[Tuple[str, int], Optional[List[Path]]]] = None
    error: Optional[str] = None
    #: dataset -> the digest of the original the job stored (None where
    #: none was), where it ran POSD itself
    orig_digest: Optional[Dict[str, Optional[tuple]]] = None
    #: dataset -> its files kept whole, in the job checked in full
    orig_stored: Optional[Dict[str, Optional[List[Path]]]] = None

    @property
    def reports(self) -> list:
        return [r for call in self.calls for r in call]

    def per_call(self, field: str) -> float:
        """A report field summed over the entry's calls (the scenarios of
        one ``run_many`` call share one value)."""
        return float(sum(getattr(call[0], field) for call in self.calls
                         if call))

    def output(self) -> judge.JobOutput:
        reports, replay = {}, {}
        for r in self.reports:
            sc = (r.dataset, int(r.max_range))
            reports[sc] = {
                "original_rows": r.original_rows,
                "simulated_rows": r.simulated_rows,
                "original_volatility": _vol(r.original_volatility),
                "simulated_volatility": _vol(r.simulated_volatility),
                "trend_corr": r.trend_corr, "status": r.status,
                "feed_hwm": r.consumer_metrics.get("feed_hwm_chunks")}
            slot = r.consumer_metrics.get("bench_slot")
            if slot is not None:
                got = self.slots[slot]
                replay[sc] = {
                    "stamps": got.stamps, "counts": got.counts,
                    "digest": got.digest, "columns": None
                    if got.buckets is None else _columns_of(got.buckets)}
        fid = {int(f.max_range): (list(f.labels), np.asarray(
            f.trend_corr, np.float64)) for f in self.fidelity}
        stored = None if self.stored is None else {
            sc: None if files is None else judge.load_stored(files)
            for sc, files in self.stored.items()}
        orig = None if self.orig_stored is None else {
            d: None if files is None else judge.load_stored(files)
            for d, files in self.orig_stored.items()}
        return judge.JobOutput(reports, fid, replay, self.stored_digest,
                               stored, failed=self.error is not None,
                               orig_digest=self.orig_digest, orig=orig)


def _vol(v) -> Tuple[float, float, float, int]:
    return (v.average, v.variance, v.std_variance, v.time_range)


class Cell:
    """The set-up of one cell and its jobs."""

    def __init__(self, name: str, seed: int, device: str = "cuda",
                 scale: Optional[float] = None, root: Path = ROOT,
                 tracer=None):
        spec = load_spec(root)
        entry = cell_of(spec, name)
        bench = root / BENCH.name
        self.name, self.seed, self.device = name, int(seed), device
        self.config = load_data("configs", entry["config"], bench)
        self.traffic = load_data("traffic", entry["traffic"], bench)
        self.scale = float(self.config["scale"] if scale is None else scale)
        self.datasets = list(self.config["datasets"])
        self.ranges = [int(mr) for mr in self.traffic["max_ranges"]]
        #: POSD and the original's write inside each job, not in set-up
        self.posd = bool(self.traffic.get("posd", False))
        self.knobs = dict(self.config["knobs"])
        days = {int(s["days"]) for s in self.config["datasets"].values()}
        if len(days) != 1:
            raise ValueError(f"{entry['config']}: datasets of different days")
        n_days = days.pop()
        #: a multi-day source's seconds (0: the native day), and the suffix
        #: of the store keys the program's multi-day sweep reads and writes
        self.duration_s = n_days * generators.DAY if n_days > 1 else 0
        self.key_suffix = f"__d{self.duration_s}" if self.duration_s else ""
        if self.duration_s:
            self.knobs["duration_s"] = self.duration_s
        self.tracer = tracer or trace.NullTracer()
        self.workdir = Path(tempfile.mkdtemp(prefix="stream_bench-"))
        self.template = self.workdir / "template"
        self.checked = self.workdir / "checked"
        self.raw: Dict[str, Dict[str, np.ndarray]] = {}
        self.records: Dict[str, int] = {}

    def close(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)

    def make_raw(self) -> None:
        """The raw streams from the seed, read-only: the program and the
        reference get the same arrays."""
        for d in self.datasets:
            cols = generators.make(self.config["datasets"][d], self.scale,
                                   self.seed)
            for v in cols.values():
                v.flags.writeable = False
            self.raw[d] = cols

    def set_up(self) -> None:
        """The raw streams, preprocessed and stored by the program into the
        template store; where the jobs run POSD, the raw streams alone."""
        from repro_torch.streamsim.store import StreamStore
        self.make_raw()
        if not self.posd:
            self.store_originals(StreamStore(self.template))

    def run_job(self, index: int, full: bool = False) -> Job:
        """Job ``index`` of the window (-1: the warm-up); with ``full`` it
        keeps its records and stored streams whole for the check."""
        from repro_torch.streamsim.controller import Controller
        tr = self.tracer
        tr.job = index
        jdir = self.workdir / f"job{index + 1:05d}"
        with tr.span("bench.job_setup"):
            for d in self.datasets if not self.posd else ():
                key = f"{d}__orig{self.key_suffix}"
                src, dst = self.template / key, jdir / key
                dst.mkdir(parents=True)
                for f in ("columns.npz", "manifest.json"):
                    os.link(src / f, dst / f)
            ctl = Controller(str(jdir), device=self.device)
        consumer = Consumer()
        calls, fidelity, error = [], [], None
        t_call = time.perf_counter()
        try:
            with tr.span("bench.entry"):
                if self.posd:
                    self.store_originals(ctl.store)
                if self.config["entry"] == "run":
                    for d in self.datasets:
                        for mr in self.ranges:
                            calls.append([ctl.run(
                                d, mr, consumer, scale=self.scale,
                                seed=self.seed, **self.knobs)])
                else:
                    calls.append(ctl.run_many(
                        self.datasets, self.ranges, consumer,
                        scale=self.scale, seed=self.seed, **self.knobs))
                    fidelity = list(ctl.last_fidelity)
            if ctl.last_result is None or ctl.last_result.mode != "device":
                error = "the sweep ran on the host, not the device path"
        except Exception:
            error = traceback.format_exc()
        digests, stored = {}, {} if full else None
        orig_digest, orig_stored = ({}, {} if full else None) if self.posd \
            else (None, None)
        with tr.span("bench.job_check"):
            slots = [Delivered.of(b, self.seed, full)
                     for b in consumer.slots]
            consumer.slots.clear()
            if full:
                self.checked.mkdir(exist_ok=True)
            for d in self.datasets:
                for mr in self.ranges:
                    self._keep(jdir, f"{d}__sim{mr}{self.key_suffix}",
                               (d, mr), digests, stored)
                if self.posd:
                    self._keep(jdir, f"{d}__orig{self.key_suffix}", d,
                               orig_digest, orig_stored)
        with tr.span("bench.job_delete"):
            shutil.rmtree(jdir)
        return Job(index, t_call, consumer.first, time.perf_counter(),
                   calls, fidelity, slots, digests, stored, error,
                   orig_digest, orig_stored)

    def store_originals(self, store) -> None:
        """Each raw stream through the program's ``preprocess`` (the span
        ``bench.posd``) and into ``store`` under the key
        ``Controller.prepare`` reads (``_prepare_multiday``'s for N days)."""
        from repro_torch.streamsim.datasets import RawStream
        from repro_torch.streamsim.preprocess import preprocess
        for d in self.datasets:
            with self.tracer.span("bench.posd"):
                stream = preprocess(RawStream(name=d,
                                              columns=dict(self.raw[d])))
            self.records[d] = len(stream)
            store.put(f"{d}__orig{self.key_suffix}", stream,
                      {"scale": self.scale, "seed": self.seed})

    def _keep(self, jdir: Path, key: str, name, digests: Dict,
              kept: Optional[Dict]) -> None:
        """The digest of the stream the job stored under ``key`` into
        ``digests[name]`` (None where none was stored); with ``kept``, its
        files linked out of the job's store into ``kept[name]``."""
        files = judge.stored_files(jdir / key)
        digests[name] = None if files is None else tuple(
            judge.npz_digest(p) for p in files)
        if kept is None:
            return
        kept[name] = None
        if files is not None:
            (self.checked / key).mkdir()
            kept[name] = [self.checked / key / p.name for p in files]
            for p, out in zip(files, kept[name]):
                os.link(p, out)

    def window(self, seconds: float) -> Tuple[List[Job], float]:
        """Jobs back to back until ``seconds`` have passed; the first is
        kept whole for the check."""
        jobs: List[Job] = []
        t0 = time.perf_counter()
        with self.tracer.span("bench.window"):
            while True:
                jobs.append(self.run_job(len(jobs), full=not jobs))
                if time.perf_counter() - t0 >= seconds:
                    break
        return jobs, time.perf_counter() - t0

    def expected(self, low: bool = False) -> simulate.Expected:
        return simulate.expected(self.raw, self.config, self.ranges, low)

    def launches(self, exp: simulate.Expected) -> List[roofline.Launch]:
        seconds = {d: int(exp.reports[(d, self.ranges[0])]
                          ["original_volatility"][3]) for d in self.datasets}
        kept = {sc: len(exp.sims[sc]["t"]) for sc in exp.scenarios}
        return roofline.job_launches(self.config["entry"], self.datasets,
                                     self.ranges, self.records, seconds,
                                     kept)


# --------------------------------------------------------------------- run
@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    window_s: float
    jobs: List[Job]
    spans: List[Tuple[str, int, float, float]]
    device_trace: Optional[trace.DeviceTrace]
    launches: List[roofline.Launch]
    #: the card's allocated-memory peak over the run, 0 without a card
    memory_peak_bytes: int = 0

    def span_seconds(self, name: str) -> Optional[List[float]]:
        """Seconds a job spent in spans ``name``, a value a job; None when
        the window recorded no such span."""
        if not any(s[0] == name for s in self.spans):
            return None
        per = [0.0] * len(self.jobs)
        for n, job, t0, t1 in self.spans:
            if n == name and 0 <= job < len(per):
                per[job] += t1 - t0
        return per


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", scale: Optional[float] = None,
             root: Path = ROOT, t_start: Optional[float] = None) -> Dict:
    """One run of cell ``name``; returns the result line's object, its
    checks last. ``t_start`` is the host clock at the process's start
    (``setup_s`` counts from it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    tracer = trace.Tracer(torch, sync=device != "cpu") if traced else None
    cell = Cell(name, seed, device, scale, root, tracer)
    try:
        cell.set_up()
        warm = cell.run_job(-1)
        if warm.error:
            print(f"warm-up job failed:\n{warm.error}", file=sys.stderr)
        undo, prof = [], None
        if traced:
            cell.tracer.records.clear()
            undo = cell.tracer.install()
            prof = trace.start_profiler()
        setup_s = time.perf_counter() - t_start
        try:
            jobs, window_s = cell.window(seconds)
        finally:
            dtrace = trace.stop_profiler(
                prof, set(trace.LAYER_SPANS) | set(BENCH_SPANS) |
                set(trace.PROGRAM_SPANS)) \
                if prof is not None else None
            trace.uninstall(undo)
        on_gpu = device != "cpu" and torch.cuda.is_available()
        peak = int(torch.cuda.max_memory_allocated()) if on_gpu else 0
        if on_gpu:
            torch.cuda.empty_cache()
        for j in jobs:
            if j.error:
                print(f"job {j.index} failed:\n{j.error}", file=sys.stderr)
        ends = [0.0] + [j.t_end - jobs[0].t_call for j in jobs]
        print("job seconds: " + " ".join(
            f"{b - a:.3f}" for a, b in zip(ends, ends[1:])), file=sys.stderr)

        t_ref = time.perf_counter()
        exp = cell.expected()
        correct, checks = judge.judge(exp, (j.output() for j in jobs),
                                      cell.config["limits"], cell.posd)
        print(f"reference and check: {time.perf_counter() - t_ref:.3f} s",
              file=sys.stderr)

        run = Run(cell, setup_s, window_s, jobs,
                  cell.tracer.records if traced else [], dtrace,
                  cell.launches(exp), peak)
        metrics = {}
        for m in metrics_of(spec, name, traced):
            value = load_reader(m["name"], root / BENCH.name)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if on_gpu else "cpu",
               "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
               "count": 1, "memory_peak_bytes": peak}
        out = {"correct": correct, "attempted": len(jobs),
               "failed": sum(1 for j in jobs if j.error), "metrics": metrics,
               "device": dev}
        if dtrace is not None:
            dev["busy_s"] = dtrace.busy_s()
            dev["window_s"] = dtrace.window_s
            out["breakdown"] = {"device_ops": dtrace.top_ops(),
                                "idle_gaps": dtrace.idle_by_host()}
        out["checks"] = checks
        return out
    finally:
        cell.close()
