#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one NVIDIA card.

    python3 tools/trace_main_path.py [--dataset userbehavior]
        [--max-range 3600] [--scale 1.0] [--seed 0] [--reps 3]
        [--sweep | --chunked | --multiday | --serve [--steps 20]]

Drives ``repro_torch.streamsim.Controller(tmp, device="cuda").run(...,
backend="torch")`` — or, with ``--sweep``, ``run_many`` over the paper's
grid (sogouq, traffic, userbehavior × 600 ... 3600 s, the Tables 1-3 sweep
with its Fig.-6 fidelity matrices); with ``--chunked``, the same grid
through the chunked pipeline (``chunk_s=600``); with ``--multiday``, nine
days of ``--dataset`` at ``--max-range`` per day, chunked; with
``--serve``, ``run("sogouq", 120, consumer=ServingTask(...))`` serving
llama3-8b at its published width (seeded bf16 weights, 8 slots of 512
positions, 16-token prompts, 16 new tokens, 4 requests per bucket) —
``--reps`` times, each in a fresh store (so every run does POSD and NSA; the
multi-day original is prepared once and copied into each store, so its
runs leave POSD out), in three modes:

- ``plain``: the program's tracer off — the end-to-end wall time;
- ``spans``: the program's tracer on (``repro_torch.tracing.enable()``):
  for every span the stream path records (``call``, ``prepare``,
  ``store.read``, ``nsa``, ``nsa.host_tables``, ``nsa.upload``,
  ``nsa.kernels``, ``fidelity``, ``materialize``, ``materialize.gather``,
  ``store.write``, ``replay``, ``replay.produce``, ``replay.consume``,
  ``report.stats``, ``report.build``, and the chunked pipeline's
  ``chunk.dispatch``, ``chunk.host_leg``, ``chunk.event_wait``) its calls,
  its seconds, its self seconds (less its children's on its own thread)
  and its counts summed, medians over the reps. The spans never
  synchronise the device: a span holds device work only where the program
  waits for it, so the double buffering runs as it does untraced. With
  ``--serve`` the spans also wrap ``transformer.prefill``,
  ``transformer.decode_step``, the logits head ``transformer.unembed`` and
  kernel B8 (``ops.flash_decode``), synchronising the device at both ends
  (``serve_spans``);
- ``profile``: one run under ``torch.profiler`` for the device's busy time
  (the union of kernel and copy intervals), its idle share, and the idle
  device seconds by the innermost program span open at the time
  (``stream_bench.trace.DeviceTrace``; ``untraced`` where none is). With
  ``--serve`` the profile covers one prefill of 8 prompts and ``--steps``
  decode steps at 8 busy slots instead of the whole run (thousands of
  launches per step would swamp the profiler), with the host's enqueue
  time per step beside the device's busy time.

Prints one JSON object. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DEVICE = "cuda"
WINDOW = "trace_main_path.window"
SWEEP_DATASETS = ("sogouq", "traffic", "userbehavior")
SWEEP_RANGES = (600, 1200, 1800, 2400, 3000, 3600)
CHUNK_S = 600
MULTIDAY_S = 9 * 86_400
SERVE_ARCH, SERVE_DATASET, SERVE_RANGE = "llama3-8b", "sogouq", 120
SERVE_TASK = dict(slots=8, max_len=512, prompt_len=16, max_new_tokens=16,
                  max_requests_per_bucket=4, reuse_engine=True)


class Spans:
    """Nested wall-clock spans, nested per thread, for the serving engine's
    calls; each synchronises the device at its edges, so its time includes
    its device work."""

    def __init__(self, torch):
        self.torch = torch
        self.records = []        # (name, depth, seconds, self seconds)
        self._local = threading.local()

    def _children(self):
        child = getattr(self._local, "child", None)
        if child is None:
            child = self._local.child = [0.0]
        return child

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            self.torch.cuda.synchronize()
            child = self._children()
            child.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                inner = child.pop()
                child[-1] += dt
                self.records.append((name, len(child) - 1, dt, dt - inner))
        return traced


def _instrument_serve(spans: Spans):
    """Wrap the serving engine's model calls and kernel B8 where the run
    looks them up; returns an undo list."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    undo = []
    for owner, attr, name in (
            (transformer, "prefill", "serve.prefill"),
            (transformer, "decode_step", "serve.decode_step"),
            (transformer, "unembed", "serve.unembed"),
            (ops, "flash_decode", "kernel.flash_decode")):
        orig = getattr(owner, attr)
        undo.append((owner, attr, orig))
        setattr(owner, attr, spans.wrap(name, orig))
    return undo


#: counts that are a position or a width, not an amount: the largest is kept
_LARGEST = ("chunk", "width")


def _span_table(records) -> dict:
    """Per span name: calls, seconds, self seconds (less its children's on
    its own thread) and the numeric counts summed (those of
    :data:`_LARGEST`: their largest)."""
    child = {}
    for r in records:
        child.setdefault((r.parent, r.thread), 0)
        child[(r.parent, r.thread)] += r.end_ns - r.start_ns
    table = {}
    for r in records:
        t = table.setdefault(r.name, {"calls": 0, "s": 0.0, "self_s": 0.0,
                                      "counts": {}})
        t["calls"] += 1
        t["s"] += r.seconds
        t["self_s"] += (r.end_ns - r.start_ns -
                        child.get((r.id, r.thread), 0)) * 1e-9
        for k, v in r.counts.items():
            if isinstance(v, (int, float)):
                had = t["counts"].get(k, 0)
                t["counts"][k] = max(had, v) if k in _LARGEST else had + v
    return table


def _idle_by_span(prof, t0_ns: int, t1_ns: int, names) -> dict:
    """The device's busy seconds and idle share in ``[t0_ns, t1_ns]``, and
    its idle seconds by the innermost range of ``names`` open at the
    time."""
    from stream_bench.trace import DeviceTrace

    events = [(WINDOW, "CPU", t0_ns * 1e-3, t1_ns * 1e-3)]
    for e in prof.profiler.kineto_results.events():
        kind = getattr(e.device_type(), "name", "")
        if kind in ("CUDA", "CPU"):
            start = e.start_ns() * 1e-3
            events.append((e.name(), kind, start,
                           start + e.duration_ns() * 1e-3))
    tr = DeviceTrace(events, set(names) | {WINDOW}, WINDOW)
    busy = tr.busy_s() if tr.ops else None
    return {"window_s": tr.window_s, "device_ops": len(tr.ops),
            "device_busy_s": busy,
            "device_idle_share": None if busy is None
            else 1 - busy / tr.window_s,
            "idle_by_span": tr.idle_by_host(n=24),
            "top_device_ops": tr.top_ops(12)}


def _consumer(queue):
    """Drains one queue; keeps no shared state, so ``run_many`` may call it
    from one thread per scenario."""
    return {"records_seen": sum(len(b) for b in queue)}


def _multiday_original(args, workdir: Path):
    """Prepare the multi-day original once; returns ``(its store key, its
    directory)`` for :func:`_run` to copy into each fresh store."""
    from repro_torch.streamsim import Controller
    ctl = Controller(str(workdir), device=DEVICE)
    ctl._prepare_multiday(args.dataset, args.scale, args.seed, MULTIDAY_S)
    key = f"{args.dataset}__orig__d{MULTIDAY_S}"
    return key, ctl.store._dir(key)


def _run(args, workdir: Path):
    """One run in a fresh store; returns ``(wall s, report or the list of
    reports, the executed result)``."""
    import torch

    from repro_torch.streamsim import Controller
    ctl = Controller(str(workdir), device=DEVICE)
    if args.multiday:
        key, src = args.original
        shutil.copytree(src, ctl.store._dir(key))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if args.multiday:
        rep = ctl.run_many((args.dataset,), (args.max_range,), _consumer,
                           scale=args.scale, seed=args.seed, backend="torch",
                           chunk_s=CHUNK_S, duration_s=MULTIDAY_S)
    elif args.serve:
        rep = ctl.run(SERVE_DATASET, SERVE_RANGE, args.task, scale=args.scale,
                      seed=args.seed)
    elif args.sweep or args.chunked:
        rep = ctl.run_many(SWEEP_DATASETS, SWEEP_RANGES, _consumer,
                           scale=args.scale, seed=args.seed, backend="torch",
                           chunk_s=CHUNK_S if args.chunked else 0)
    else:
        rep = ctl.run(args.dataset, args.max_range, _consumer,
                      scale=args.scale, seed=args.seed, backend="torch")
    torch.cuda.synchronize()
    if ctl.last_result.mode != "device":
        raise AssertionError("the run fell back to host mode")
    return time.perf_counter() - t0, rep, ctl.last_result


def _summary(rep) -> dict:
    if isinstance(rep, list):
        return {"scenarios": len(rep),
                "feed_hwm_chunks": max(r.consumer_metrics.get(
                    "feed_hwm_chunks", 0) for r in rep),
                "original_rows": {r.dataset: r.original_rows for r in rep},
                "simulated_rows": sum(r.simulated_rows for r in rep),
                "preprocess_s": {r.dataset: r.preprocess_s for r in rep},
                "nsa_s": max(r.nsa_s for r in rep),
                "produce_s": max(r.produce_s for r in rep)}
    if "serving_decode_steps" in rep.consumer_metrics:
        m = rep.consumer_metrics
        return {"simulated_rows": rep.simulated_rows,
                "preprocess_s": rep.preprocess_s, "nsa_s": rep.nsa_s,
                "produce_s": rep.produce_s,
                **{k: m[k] for k in ("task_records", "serving_finished",
                                     "serving_tokens_out",
                                     "serving_decode_steps",
                                     "serving_queue_peak", "task_wall_s")}}
    return {"original_rows": rep.original_rows,
            "simulated_rows": rep.simulated_rows,
            "preprocess_s": rep.preprocess_s,
            "nsa_s": rep.nsa_s, "produce_s": rep.produce_s}


def _serve_profile(args):
    """Profile one prefill of 8 prompts and ``args.steps`` decode steps of
    the served model at 8 busy slots; returns the host's enqueue seconds
    per step, the wall, the device's busy seconds and the top events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer
    cfg, params = args.cfg, args.params
    rng = np.random.default_rng(args.seed)
    slots, p_len = SERVE_TASK["slots"], SERVE_TASK["prompt_len"]
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (slots, p_len),
                                         dtype=np.int32)).to(DEVICE)
    lens = torch.full((slots,), p_len, dtype=torch.int32, device=DEVICE)

    def window():
        logits, cache = transformer.prefill(cfg, params, toks, lens,
                                            SERVE_TASK["max_len"])
        nxt = torch.argmax(logits, -1).to(torch.int32)
        enqueue = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(cfg, params, cache, nxt)
            enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return enqueue

    window()                                      # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        enqueue = window()
        t1 = time.time_ns()
    t0p = time.perf_counter()
    plain_enqueue = window()
    plain_wall = time.perf_counter() - t0p
    return (t0, t1), prof, {"steps": args.steps,
                        "plain_window_s": plain_wall,
                        "plain_enqueue_per_step_s": float(
                            np.median(plain_enqueue)),
                        "profiled_enqueue_per_step_s": float(
                            np.median(enqueue))}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="userbehavior")
    p.add_argument("--max-range", type=int, default=3600)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=3)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--sweep", action="store_true",
                      help="trace run_many over the paper grid instead of "
                           "run")
    mode.add_argument("--chunked", action="store_true",
                      help="trace the paper grid through the chunked "
                           "pipeline (chunk_s=600)")
    mode.add_argument("--multiday", action="store_true",
                      help="trace nine days of --dataset, chunked")
    mode.add_argument("--serve", action="store_true",
                      help="trace run(sogouq, 120) serving llama3-8b "
                           "through ServingTask")
    p.add_argument("--steps", type=int, default=20,
                   help="decode steps in the --serve profile window")
    args = p.parse_args()
    chunked = args.chunked or args.multiday

    import torch
    if not torch.cuda.is_available():
        print("trace_main_path: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch import tracing
    from repro_torch.kernels import _build
    _build.build_all()

    out = {"card": torch.cuda.get_device_name(0), "args": dict(vars(args))}
    if args.serve:
        from repro_torch.configs import get_config
        from repro_torch.models import transformer
        from repro_torch.streamsim import ServingTask
        args.cfg = get_config(SERVE_ARCH)
        args.params = transformer.init_params(args.cfg, args.seed,
                                              device=DEVICE)
        args.task = ServingTask(args.cfg, args.params, device=DEVICE,
                                **SERVE_TASK)
    with tempfile.TemporaryDirectory(prefix="trace_") as tmp:
        tmp = Path(tmp)
        if args.multiday:
            t0 = time.perf_counter()
            args.original = _multiday_original(args, tmp / "original")
            out["multiday_posd_s"] = time.perf_counter() - t0
        _run(args, tmp / "warm")                 # warm-up: CUDA context etc.
        plain = [_run(args, tmp / f"plain{i}") for i in range(args.reps)]
        out["plain_run_s"] = [w for w, _, _ in plain]
        if chunked:
            out["plain_pipeline_s"] = [r.pipeline_s for _, _, r in plain]

        per_rep, serve_recs = [], []
        for i in range(args.reps):
            spans = Spans(torch)
            undo = _instrument_serve(spans) if args.serve else []
            tracing.enable()
            try:
                wall, rep, _ = _run(args, tmp / f"spans{i}")
            finally:
                tracing.enable(False)
                for owner, attr, orig in undo:
                    setattr(owner, attr, orig)
            per_rep.append((wall, _span_table(tracing.drain()), rep))
            serve_recs.append(spans.records)
        out["spans_run_s"] = [w for w, _, _ in per_rep]
        table = {}
        for n in sorted({n for _, t, _ in per_rep for n in t}):
            got = [t.get(n) for _, t, _ in per_rep if n in t]
            table[n] = {
                "calls": got[0]["calls"],
                "median_s": float(np.median([g["s"] for g in got])),
                "median_self_s": float(np.median([g["self_s"]
                                                  for g in got])),
                "counts": got[0]["counts"]}
        out["spans"] = table
        if args.serve:
            out["serve_spans"] = {n: {
                "calls": sum(1 for r in serve_recs[0] if r[0] == n),
                "median_s": float(np.median([sum(r[2] for r in recs
                                                 if r[0] == n)
                                             for recs in serve_recs])),
                "median_self_s": float(np.median([sum(r[3] for r in recs
                                                      if r[0] == n)
                                                  for recs in serve_recs]))}
                for n in sorted({r[0] for recs in serve_recs
                                 for r in recs})}
        out["report"] = _summary(per_rep[-1][2])

        from torch.profiler import ProfilerActivity, profile
        if args.serve:
            (t0, t1), prof, window = _serve_profile(args)
            out["serve_window"] = window
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.time_ns()
                _run(args, tmp / "profiled")
                t1 = time.time_ns()
        out["profile"] = _idle_by_span(prof, t0, t1,
                                       {r.name for r in tracing.drain()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
