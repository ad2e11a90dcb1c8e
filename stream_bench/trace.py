"""Spans around the program's layers, and what the device trace says.

In a traced run the benchmark wraps the program's layer boundaries where
the program looks them up (module and class attributes, put back after
the window), as ``tools/trace_main_path.py`` does; nothing in the program
is edited. A span synchronises the device at both ends, so its time holds
its device work, and it is also a ``torch.profiler.record_function`` range,
so the device trace can say what the host was doing while the device
idled. An attribute that a later program no longer has is skipped, and
the metric that reads its span finds nothing.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from typing import Dict, List, Optional, Tuple

#: span name -> (module, attribute path) of the program's layer boundaries
LAYER_SPANS: Dict[str, Tuple[str, str]] = {
    "store.load_originals": ("repro_torch.streamsim.controller",
                             "Controller._prepare_all"),
    "plan.plan_sweep": ("repro_torch.streamsim.controller", "plan_sweep"),
    "engine.execute_sweep": ("repro_torch.streamsim.engine",
                             "execute_sweep"),
    "nsa.tables_host": ("repro_torch.kernels.ops", "stream_sample_inputs"),
    "nsa.device": ("repro_torch.streamsim.engine", "nsa_sweep_device"),
    "engine.fidelity": ("repro_torch.streamsim.engine",
                        "DeviceSweepResult.fidelity"),
    "engine.materialize": ("repro_torch.streamsim.engine",
                           "DeviceSweepResult.materialize"),
    "store.put": ("repro_torch.streamsim.store", "StreamStore.put"),
    "replay.replay_one": ("repro_torch.streamsim.engine", "replay_one"),
    "replay.replay_many": ("repro_torch.streamsim.engine", "replay_many"),
    "report.build_report": ("repro_torch.streamsim.engine", "build_report"),
    "report.metrics_batched": ("repro_torch.streamsim.engine",
                               "metrics_batched"),
    "report.trend_corr_pairwise": ("repro_torch.kernels.ops",
                                   "trend_corr_pairwise"),
    "controller.save_metrics": ("repro_torch.streamsim.controller",
                                "Controller.save_metrics"),
    "controller.save_fidelity": ("repro_torch.streamsim.controller",
                                 "Controller.save_fidelity"),
}


#: the program's own spans (``repro_torch.tracing``) that also label the
#: device's idle time: the chunked runner's legs
PROGRAM_SPANS = ("chunk.dispatch", "chunk.host_leg", "chunk.event_wait")

#: device operations that are copies or fills, not kernels, by name prefix
COPIES = ("Memcpy", "Memset")


def program_seconds(device_trace, name: str) -> Optional[List[float]]:
    """Seconds each job of the window spent in the program's spans ``name``
    (``repro_torch.tracing``'s records, on the device trace's clock): a
    record is job k's when it starts inside the k-th ``bench.entry`` range
    of ``device_trace``. None where the program keeps no such records, or
    none starts inside a job."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    entries = sorted((a, b) for n, a, b in getattr(
        device_trace, "ranges", ()) if n == "bench.entry")
    per, found = [0.0] * len(entries), False
    for r in tracing.records():
        if r.name != name:
            continue
        at = r.start_ns * 1e-3
        for k, (a, b) in enumerate(entries):
            if a <= at < b:
                per[k] += r.seconds
                found = True
                break
    return per if found else None


class NullTracer:
    """Tracing off: spans cost nothing."""

    job = -1

    @contextlib.contextmanager
    def span(self, name: str):
        yield


class Tracer:
    """Synchronising, nested spans recorded as ``(name, job, start, end)``
    host-clock seconds; ``job`` is the window's job index at the time."""

    def __init__(self, torch, sync: bool = True):
        self.torch = torch
        self.sync = sync and torch.cuda.is_available()
        self.records: List[Tuple[str, int, float, float]] = []
        self.job = -1

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function
        if self.sync:
            self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(name):
            try:
                yield
            finally:
                if self.sync:
                    self.torch.cuda.synchronize()
        self.records.append((name, self.job, t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return traced

    def install(self) -> List[Tuple[object, str, object]]:
        """Wrap every layer boundary of :data:`LAYER_SPANS` the program
        has; returns the list that :func:`uninstall` puts back."""
        undo = []
        for name, (module, path) in LAYER_SPANS.items():
            owner = importlib.import_module(module)
            *parents, attr = path.split(".")
            try:
                for p in parents:
                    owner = getattr(owner, p)
                orig = owner.__dict__[attr] if isinstance(owner, type) \
                    else getattr(owner, attr)
            except (AttributeError, KeyError):
                continue
            undo.append((owner, attr, orig))
            setattr(owner, attr, self.wrap(name, orig))
        return undo


def uninstall(undo) -> None:
    for owner, attr, orig in reversed(undo):
        setattr(owner, attr, orig)


# ------------------------------------------------------------ device trace
class DeviceTrace:
    """The device's operations and the host's ranges in one traced window,
    on the profiler's clock (microseconds). ``events`` are ``(name, kind,
    start, end)`` with ``kind`` ``"CUDA"`` or ``"CPU"``."""

    def __init__(self, events, labels, window_name: str = "bench.window"):
        self.ops: List[Tuple[str, float, float]] = []
        self.ranges: List[Tuple[str, float, float]] = []
        for name, kind, a, b in events:
            if kind == "CUDA" and name not in labels:
                # (a host range's mirror on the device's timeline carries
                # the range's name and is no operation)
                self.ops.append((name, a, b))
            elif kind == "CPU" and name in labels:
                self.ranges.append((name, a, b))
        win = [r for r in self.ranges if r[0] == window_name]
        if win:
            self.start, self.end = win[0][1], win[0][2]
        elif self.ops:
            self.start = min(o[1] for o in self.ops)
            self.end = max(o[2] for o in self.ops)
        else:
            self.start = self.end = 0.0
        self.ranges = [r for r in self.ranges if r[0] != window_name]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's operation intervals in the window."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        """Device operations by total seconds, largest first."""
        tot: Dict[str, float] = {}
        for name, a, b in self.ops:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle device seconds in the window, split by the innermost host
        range open at each instant (``untraced`` where none is)."""
        gaps, t = [], self.start
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        # the ranges nest (they are the main thread's): a stack gives the
        # innermost one between consecutive boundaries
        marks = sorted([(s, 1, i) for i, (_, s, _) in enumerate(self.ranges)]
                       + [(e, 0, i) for i, (_, _, e) in
                          enumerate(self.ranges)])
        segments, stack, t = [], [], self.start
        for at, opening, i in marks:
            if at > t:
                label = self.ranges[stack[-1]][0] if stack else "untraced"
                segments.append((t, at, label))
                t = at
            if opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        segments.append((t, max(t, self.end), "untraced"))
        tot: Dict[str, float] = {}
        k = 0
        for a, b in gaps:
            while k < len(segments) and segments[k][1] <= a:
                k += 1
            j = k
            while j < len(segments) and segments[j][0] < b:
                s0, s1, label = segments[j]
                over = min(b, s1) - max(a, s0)
                if over > 0:
                    tot[label] = tot.get(label, 0.0) + over * 1e-6
                j += 1
        return [[k2, v] for k2, v in sorted(tot.items(),
                                            key=lambda kv: -kv[1])[:n]]

    def kernel_s(self) -> float:
        """Seconds the device's kernels took in the window, summed over
        every operation but the copies and fills."""
        return sum(min(b, self.end) - max(a, self.start)
                   for name, a, b in self.ops
                   if not name.startswith(COPIES) and
                   min(b, self.end) > max(a, self.start)) * 1e-6


def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_profiler(prof, labels) -> DeviceTrace:
    """Stop ``prof``; its trace with the host ranges named in ``labels``.
    The profiler's raw events are read as they are: building its event
    tree takes seconds for a window's tens of thousands of operations."""
    prof.__exit__(None, None, None)
    events = []
    for e in prof.profiler.kineto_results.events():
        kind = getattr(e.device_type(), "name", "")
        if kind in ("CUDA", "CPU"):
            start = e.start_ns() * 1e-3
            events.append((e.name(), kind, start,
                           start + e.duration_ns() * 1e-3))
    return DeviceTrace(events, labels)
