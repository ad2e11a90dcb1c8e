#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA card.

    python3 tools/trace_main_path.py [--dataset userbehavior]
        [--max-range 3600] [--scale 1.0] [--seed 0] [--reps 3]

Drives ``repro_torch.streamsim.Controller(tmp, device="cuda").run(...,
backend="torch")`` ``--reps`` times, each in a fresh store (so every run
does POSD and NSA), in three modes:

- ``plain``: no instrumentation — the end-to-end wall time;
- ``spans``: the layer boundaries of the run (controller, plan, engine,
  NSA, each kernel wrapper, host table build, store writes, replay,
  report statistics) are wrapped in spans that synchronise the device at
  both ends, so each span's time includes its device work; self time is a
  span's time minus its child spans';
- ``profile``: one run under ``torch.profiler`` for the device's busy time
  (the union of kernel and copy intervals) and so its idle share.

Prints one JSON object. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DEVICE = "cuda"


class Spans:
    """Nested wall-clock spans with device synchronisation at the edges."""

    def __init__(self, torch):
        self.torch = torch
        self.records = []        # (name, depth, seconds, self seconds)
        self.depth = 0
        self.child = [0.0]

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            self.torch.cuda.synchronize()
            self.depth += 1
            self.child.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                inner = self.child.pop()
                self.depth -= 1
                self.child[-1] += dt
                self.records.append((name, self.depth, dt, dt - inner))
        return traced


def _instrument(spans: Spans):
    """Wrap the main path's layer boundaries where the run looks them up;
    returns an undo list."""
    from repro_torch.kernels import ops
    from repro_torch.streamsim import controller, engine, store

    targets = [
        (controller.Controller, "prepare", "posd.prepare"),
        (controller.Controller, "save_metrics", "controller.save_metrics"),
        (controller, "plan_sweep", "plan.plan_sweep"),
        (engine, "execute_sweep", "engine.execute_sweep"),
        (engine, "nsa_sweep_device", "nsa.nsa_sweep_device"),
        (ops, "stream_sample_inputs", "ops.nsa_tables_host"),
        (ops, "_stream_sample_kernel", "kernel.stream_sample"),
        (ops, "compact", "kernel.compact"),
        (ops, "_stream_metrics_kernel", "kernel.metrics_fused"),
        (ops, "stream_metrics_inputs", "ops.metrics_inputs_host"),
        (engine.DeviceSweepResult, "materialize", "engine.materialize"),
        (store.StreamStore, "put", "store.put"),
        (engine, "replay_one", "replay.replay_one"),
        (engine, "build_report", "report.build_report"),
        (engine, "metrics_batched", "report.metrics_batched"),
        (ops, "trend_corr_pairwise", "report.trend_corr_pairwise"),
    ]
    undo = []
    for owner, attr, name in targets:
        orig = getattr(owner, attr)
        undo.append((owner, attr, orig))
        setattr(owner, attr, spans.wrap(name, orig))
    return undo


def _consumer(queue):
    return {"records_seen": sum(len(b) for b in queue)}


def _run(args, workdir: Path):
    import torch

    from repro_torch.streamsim import Controller
    ctl = Controller(str(workdir), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = ctl.run(args.dataset, args.max_range, _consumer, scale=args.scale,
                  seed=args.seed, backend="torch")
    torch.cuda.synchronize()
    if ctl.last_result.mode != "device":
        raise AssertionError("the run fell back to host mode")
    return time.perf_counter() - t0, rep


def _busy_seconds(events) -> float:
    """Union of the device intervals of kernels and copies (µs -> s)."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -np.inf
    for a, b in iv:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="userbehavior")
    p.add_argument("--max-range", type=int, default=3600)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("trace_main_path: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    _build.build_all()

    out = {"card": torch.cuda.get_device_name(0), "args": vars(args)}
    with tempfile.TemporaryDirectory(prefix="trace_") as tmp:
        tmp = Path(tmp)
        _run(args, tmp / "warm")                 # warm-up: CUDA context etc.
        plain = [_run(args, tmp / f"plain{i}")[0] for i in range(args.reps)]
        out["plain_run_s"] = plain

        per_rep = []
        for i in range(args.reps):
            spans = Spans(torch)
            undo = _instrument(spans)
            try:
                wall, rep = _run(args, tmp / f"spans{i}")
            finally:
                for owner, attr, orig in undo:
                    setattr(owner, attr, orig)
            per_rep.append((wall, spans.records, rep))
        out["spans_run_s"] = [w for w, _, _ in per_rep]
        names = sorted({r[0] for _, recs, _ in per_rep for r in recs})
        table = {}
        for n in names:
            tot = [sum(r[2] for r in recs if r[0] == n)
                   for _, recs, _ in per_rep]
            self_t = [sum(r[3] for r in recs if r[0] == n)
                      for _, recs, _ in per_rep]
            calls = [sum(1 for r in recs if r[0] == n)
                     for _, recs, _ in per_rep]
            table[n] = {"calls": calls[0],
                        "median_s": float(np.median(tot)),
                        "median_self_s": float(np.median(self_t))}
        out["spans"] = table
        rep = per_rep[-1][2]
        out["report"] = {"original_rows": rep.original_rows,
                         "simulated_rows": rep.simulated_rows,
                         "preprocess_s": rep.preprocess_s,
                         "nsa_s": rep.nsa_s, "produce_s": rep.produce_s}

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = _run(args, tmp / "profiled")
        dev = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None and
               e.device_type.name == "CUDA"]
        busy = _busy_seconds(dev) if dev else None
        kernels = {}
        for e in dev:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += (e.time_range.end - e.time_range.start) * 1e-6
        out["profile"] = {
            "run_s": wall, "device_events": len(dev),
            "device_busy_s": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall,
            "top_device_events": sorted(
                ([n, c, s] for n, (c, s) in kernels.items()),
                key=lambda x: -x[2])[:12]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
