"""Task benchmark harness — the paper's comparison, end to end.

Counterpart of ``repro/streamsim/taskbench.py``.

The paper validates its framework by running a stream task twice — once
against the original day-long stream, once against the NSA-compressed
simulated stream — and showing the simulated run is >= 24x faster while
the task sees the same volatility/trends. :class:`TaskBenchRunner` is that
experiment as code: for every (task, dataset, max_range) cell it replays
the *original* stream (per-second scale stamps over its natural span) and
the *simulated* stream (compressed to ``max_range`` virtual seconds)
through the same :func:`repro_torch.streamsim.engine.replay_many` transport
(MultiQueueProducer + QueueGroup, virtual clock), and emits a
:class:`TaskReport` carrying:

- ``speedup`` — original-replay wall time over simulated-replay wall time
  (both at virtual speed, so the ratio reflects the data-volume
  compression the paper buys, not sleep time);
- ``trend_fidelity`` — Pearson correlation between the task's OWN output
  series (``task_output_counts``) under the two replays, via
  :func:`repro_torch.streamsim.metrics.trend_correlation_matrix` (on the
  torch backend the device chain: kernel B4's prefix sums, then kernel
  B5's Gram at S = 2), plus the two output streams' coefficients of
  variation (the volatility half of the claim);
- ``latency`` — p50/p99/p999/mean/jitter of the task's per-bucket (or,
  for the serving task, per-request) latency, summarized from histograms:
  ALL sim scenarios' latency-bin arrays for a task feed ONE
  :func:`repro_torch.kernels.ops.stream_metrics_batched` call (kernel B3
  on the torch backend; the bins are unsorted) (:func:`summarize_latencies`).

Backends: ``"numpy" | "torch" | "auto"`` (``"auto"`` is ``"torch"``), with
``device`` where the torch backend runs (``None`` means CUDA, and raises
without a usable card: nothing falls back to the CPU unless asked). The
simulated streams come from the numpy NSA, as in the reference.

``FIDELITY_FLOOR`` is the documented floor the equivalence suite and the
CI benchmark gate hold the trend correlation to (docs/tasks.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.streamsim.datasets import make_stream
from repro_torch.streamsim.engine import REPORT_TREND_WINDOW_S, replay_many
from repro_torch.streamsim.metrics import trend_correlation_matrix
from repro_torch.streamsim.nsa import _resolve_backend, nsa
from repro_torch.streamsim.preprocess import Stream, preprocess
from repro_torch.streamsim.tasks import LATENCY_BINS, LATENCY_BIN_US

__all__ = [
    "FIDELITY_FLOOR",
    "PAPER_SPEEDUP",
    "LatencySummary",
    "TaskBenchRunner",
    "TaskReport",
    "original_replay_stream",
    "slice_stream",
    "summarize_latencies",
]

#: documented trend-fidelity floor for the task-output equivalence check
#: (the paper's "ensure volatility and trends" premise as a number): the
#: Pearson correlation of a task's output trend between original and
#: simulated replay, at the report window, must not fall below this.
FIDELITY_FLOOR = 0.75

#: the paper's headline task-acceleration figure (§6): one day compressed
#: into <= 1 hour makes the stream task >= 24x faster. Recorded on every
#: benchmark row as ``paper_ratio``; CI gates a conservative floor.
PAPER_SPEEDUP = 24.0


# ---------------------------------------------------------- latency summary
@dataclasses.dataclass
class LatencySummary:
    """Per-scenario latency digest from one device histogram row."""

    samples: int
    p50_us: float
    p99_us: float
    p999_us: float
    mean_us: float
    jitter_us: float      # std of the latency distribution

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _check_device(backend: str, device):
    """The torch backend's device, resolved up front (``None`` means CUDA
    and raises without a usable card); ``None`` for numpy."""
    if _resolve_backend(backend) == "numpy":
        return None
    from repro_torch.kernels import ops
    return ops.resolve_device(device)


def _hist_rows(arrays: List[np.ndarray], n_bins: int, backend: str,
               device=None) -> np.ndarray:
    """(S, n_bins) histogram matrix — ONE kernel B3 call on the torch
    backend, plain bincount on numpy / domain fallback."""
    if _resolve_backend(backend) != "numpy":
        from repro_torch.kernels import ops
        try:
            hist, _, _ = ops.stream_metrics_batched(arrays, n_bins,
                                                    device=device)
            return hist.cpu().numpy().astype(np.int64)
        except ops.PallasDomainError:
            pass
    return np.stack([np.bincount(a, minlength=n_bins).astype(np.int64)
                     for a in arrays])


def summarize_latencies(bin_arrays: Sequence,
                        *, bin_us: float = LATENCY_BIN_US,
                        n_bins: int = LATENCY_BINS,
                        backend: str = "auto",
                        device=None) -> List[LatencySummary]:
    """Latency summaries for S scenarios from ONE fused histogram call.

    ``bin_arrays`` are the tasks' ``task_latency_bins`` outputs (integer
    bin indices in ``[0, n_bins)``, ragged lengths, empties allowed).
    The bins are scale-stamp-shaped, so the whole sweep goes through a
    single :func:`repro_torch.kernels.ops.stream_metrics_batched` call
    (kernel B3 on ``device`` for the torch backend); the
    quantiles (nearest-rank over the cumulative histogram, reported at
    bin centers), mean, and jitter (std) all derive from the returned
    histogram rows. Empty scenarios yield NaN summaries.
    """
    device = _check_device(backend, device)
    arrays = [np.asarray(a, np.int32).reshape(-1) for a in bin_arrays]
    if not arrays:
        return []
    hist = _hist_rows(arrays, n_bins, backend, device)
    centers = (np.arange(n_bins, dtype=np.float64) + 0.5) * bin_us
    out = []
    for s, a in enumerate(arrays):
        n = len(a)
        if n == 0:
            out.append(LatencySummary(0, *([float("nan")] * 5)))
            continue
        cum = np.cumsum(hist[s])

        def pct(p, cum=cum, n=n):
            rank = max(1, int(np.ceil(p * n)))
            return float(centers[np.searchsorted(cum, rank, side="left")])

        mean = float((hist[s] * centers).sum() / n)
        var = float((hist[s] * centers ** 2).sum() / n - mean ** 2)
        out.append(LatencySummary(n, pct(0.50), pct(0.99), pct(0.999),
                                  mean, float(np.sqrt(max(var, 0.0)))))
    return out


# ------------------------------------------------------------- task report
def _cv(q: np.ndarray) -> float:
    """Coefficient of variation of a count series (volatility digest)."""
    q = np.asarray(q, np.float64)
    if len(q) == 0 or q.mean() == 0:
        return float("nan")
    return float(q.std() / q.mean())


@dataclasses.dataclass
class TaskReport:
    """One (task, dataset, max_range) cell of the paper comparison."""

    task: str
    dataset: str
    max_range: int
    t_original_s: float       # original-replay wall (virtual clock)
    t_simulated_s: float      # simulated-replay wall (virtual clock)
    speedup: float            # t_original_s / t_simulated_s
    paper_ratio: float        # the paper's >= 24x figure, for the record
    trend_fidelity: float     # task-output trend corr, original vs sim
    cv_original: float        # output-series volatility (std/mean)
    cv_simulated: float
    records_original: int
    records_simulated: int
    latency: Dict[str, float]  # sim-run LatencySummary.to_dict()

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def slice_stream(stream: Stream, span_s: int) -> Stream:
    """The stream's first ``span_s`` seconds (payload column-sliced).

    Reduced-span runs keep the CI smoke fast while leaving enough diurnal
    structure for the fidelity check; full-day runs are the paper
    numbers. The slice is taken BEFORE NSA so original and simulated
    replays see the same source window.
    """
    if span_s <= 0:
        raise ValueError("span_s must be positive")
    if len(stream.t) == 0:
        return stream
    mask = stream.t < stream.t.min() + span_s
    return Stream(name=stream.name, t=stream.t[mask],
                  payload={k: v[mask] for k, v in stream.payload.items()},
                  scale_stamp=None)


def original_replay_stream(stream: Stream) -> Stream:
    """The original stream readied for replay: per-second scale stamps
    over its natural span (stamp = floor(t - t0)), so the producer walks
    it exactly like a simulated stream whose max_range is the full day.
    The payload is shared, not copied."""
    if len(stream.t) == 0:
        stamps = np.zeros(0, np.int64)
    else:
        t0 = np.floor(stream.t.min())
        stamps = np.floor(stream.t - t0).astype(np.int64)
    return Stream(name=stream.name, t=stream.t, payload=stream.payload,
                  scale_stamp=stamps)


# ------------------------------------------------------------------ runner
class TaskBenchRunner:
    """Run each task against original AND simulated replay; report both
    halves of the paper's claim (speedup, output fidelity) per scenario.

    Every replay leg goes through :func:`replay_many` — the same
    MultiQueueProducer/QueueGroup transport ``Controller.run_many``
    drives — with its own wall clock, so per-scenario speedups are
    clean. Per task, ALL simulated scenarios' latency bins are then
    summarized in one histogram call, and each (dataset, max_range) cell's
    two output series are correlated in one S = 2 trend chain, on
    ``device`` for the torch backend (``None`` means CUDA).
    """

    def __init__(self, datasets: Sequence[str],
                 max_ranges: Sequence[int], *, scale: float = 0.01,
                 seed: int = 0, span_s: Optional[int] = None,
                 window_s: int = REPORT_TREND_WINDOW_S,
                 queue_size: int = 256, backend: str = "auto",
                 paper_ratio: float = PAPER_SPEEDUP, device=None):
        if not datasets or not max_ranges:
            raise ValueError("need at least one dataset and one max_range")
        self.device = _check_device(backend, device)
        self.datasets = list(datasets)
        self.max_ranges = [int(r) for r in max_ranges]
        self.scale = scale
        self.seed = seed
        self.span_s = span_s
        self.window_s = window_s
        self.queue_size = queue_size
        self.backend = backend
        self.paper_ratio = paper_ratio
        self._originals: Optional[Dict[str, Stream]] = None
        self._sims: Optional[Dict[Tuple[str, int], Stream]] = None

    def _prepare(self):
        if self._originals is None:
            self._originals = {
                ds: preprocess(make_stream(ds, scale=self.scale,
                                           seed=self.seed))
                for ds in self.datasets}
            if self.span_s is not None:
                self._originals = {ds: slice_stream(s, self.span_s)
                                   for ds, s in self._originals.items()}
            self._sims = {
                (ds, mr): nsa(self._originals[ds], mr)
                for ds in self.datasets for mr in self.max_ranges}
        return self._originals, self._sims

    def _replay(self, key, stream: Stream, task) -> Tuple[Dict, float]:
        metrics, wall = replay_many({key: stream}, task, self.queue_size)
        return metrics[key], wall

    def run(self, tasks: Sequence) -> List[TaskReport]:
        originals, sims = self._prepare()
        reports: List[TaskReport] = []
        for task in tasks:
            orig_runs = {
                ds: self._replay((ds, "original"),
                                 original_replay_stream(originals[ds]),
                                 task)
                for ds in self.datasets}
            keys = list(sims)
            sim_runs = {k: self._replay(k, sims[k], task) for k in keys}
            # one fused latency dispatch across the task's whole sweep
            summaries = summarize_latencies(
                [sim_runs[k][0]["task_latency_bins"] for k in keys],
                bin_us=getattr(task, "bin_us", LATENCY_BIN_US),
                n_bins=getattr(task, "n_bins", LATENCY_BINS),
                backend=self.backend, device=self.device)
            for k, latency in zip(keys, summaries):
                ds, mr = k
                om, ow = orig_runs[ds]
                sm, sw = sim_runs[k]
                corr = trend_correlation_matrix(
                    [om["task_output_counts"], sm["task_output_counts"]],
                    self.window_s, backend=self.backend,
                    device=self.device)
                reports.append(TaskReport(
                    task=getattr(task, "name", type(task).__name__),
                    dataset=ds, max_range=mr,
                    t_original_s=ow, t_simulated_s=sw,
                    speedup=ow / sw if sw > 0 else float("inf"),
                    paper_ratio=self.paper_ratio,
                    trend_fidelity=float(corr[0, 1]),
                    cv_original=_cv(om["task_output_counts"]),
                    cv_simulated=_cv(sm["task_output_counts"]),
                    records_original=int(om["task_records"]),
                    records_simulated=int(sm["task_records"]),
                    latency=latency.to_dict()))
        return reports
