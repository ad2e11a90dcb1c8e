"""Sweep engine — executes a :class:`~repro_torch.streamsim.plan.SweepPlan`.

The middle layer of the plan → engine → replay/report architecture:

- **Execute** (:func:`execute_sweep`): runs every plan shard's NSA →
  metrics chain as ONE launch per kernel on that shard's device, giving a
  :class:`DeviceSweepResult` whose kept-index sets and per-second counts
  stay on the device — :func:`~repro_torch.streamsim.nsa.nsa_sweep_device`
  (kernels B1, B2) chains straight into
  :func:`~repro_torch.kernels.ops.stream_metrics_batched_device` (kernel
  B3) and only O(S) report scalars (kept totals, ``[Σq, Σq²]``) cross to
  the host.
- **Materialize** (:meth:`DeviceSweepResult.materialize`): the single lazy
  host pass — kept indices gather the payload columns once and the
  simulated streams land in the store.
- **Fidelity** (:meth:`DeviceSweepResult.fidelity`): one S×S
  trend-correlation matrix per ``max_range`` over ``[originals...,
  sims...]``, straight from the device-resident count rows through the
  trend kernels B4 and B5 (:func:`~repro_torch.kernels.ops.
  trend_correlation_batched_device`).
- **Replay / report** (:func:`run_sweep`, :func:`replay_one`,
  :func:`replay_many`, :func:`build_report`): the PSDA replay (one
  :class:`~repro_torch.streamsim.producer.MultiQueueProducer` loop for a
  sweep) and the :class:`SimulationReport` s, whose statistics read the
  original streams' metrics (B3's time form, launched in the NSA leg on
  the float64 copy B1 read: :func:`~repro_torch.kernels.ops.
  original_metrics`) and the pairwise trend correlation (plain PyTorch,
  :func:`~repro_torch.kernels.ops.trend_corr_pairwise`).
- **Chunked pipeline** (:class:`ChunkedSweepRunner`,
  :func:`run_sweep_chunked`): the same sweep computed, persisted and
  replayed one time chunk at a time (B1, B2 and B6 per chunk, the carry
  on the device), double-buffered, in bounded host memory.

Backend semantics
-----------------
``backend="numpy"`` runs the *host mode*: per-scenario numpy NSA, one
batched ``metrics_batched`` call, f64 per-pair trend correlations.
``backend="torch"`` (and ``"auto"``) runs the *device mode* above on
``device`` (``None`` means CUDA; the CPU runs the kernels' plain
versions). NSA output is bit-identical, counts are bit-exact, moments and
trend correlations agree within 1e-3. A
:class:`~repro_torch.kernels.ops.PallasDomainError` during the device
chain falls back to host mode wholesale; nothing else falls back.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.streamsim.faults import FaultPlan
from repro_torch.streamsim.metrics import (StreamMetrics, Volatility,
                                           _volatility_from_moments,
                                           metrics_batched,
                                           trend_correlation_from_counts,
                                           trend_correlation_matrix)
from repro_torch.streamsim.nsa import (ChunkedNSA, _resolve_backend,
                                       compression_factor, materialize_sweep,
                                       nsa, nsa_sweep_device)
from repro_torch.streamsim.plan import Shard, SweepPlan
from repro_torch.streamsim.preprocess import Stream
from repro_torch.streamsim.producer import (ChunkFeed, MultiQueueProducer,
                                            Producer, VirtualClock)
from repro_torch.streamsim.queue import QueueGroup, StreamQueue
from repro_torch.streamsim.resilience import (CircuitBreaker, Deadline,
                                              RetryPolicy, SweepCheckpoint)

#: sliding-mean window of the per-report trend correlation — the single
#: source for the device chain AND its host fallback
REPORT_TREND_WINDOW_S = 60


# ------------------------------------------------------------------ reports
@dataclasses.dataclass
class SimulationReport:
    dataset: str
    max_range: int
    original_rows: int
    simulated_rows: int
    compression: float
    original_volatility: Volatility
    simulated_volatility: Volatility
    trend_corr: float
    preprocess_s: float
    nsa_s: float
    produce_s: float
    consumer_metrics: Dict
    #: "ok", or "partial" when the scenario's consumer failed persistently
    #: and the sweep degraded it instead of failing
    status: str = "ok"
    failure: Optional[str] = None   #: repr of the terminal consumer error
    attempts: int = 1               #: replay attempts consumed (1 = clean)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "SimulationReport":
        """Rebuild a report from its :meth:`to_json` payload."""
        d = dict(d)
        for f in ("original_volatility", "simulated_volatility"):
            v = d[f]
            if isinstance(v, dict):
                d[f] = Volatility(**v)
        known = {fld.name for fld in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class FidelityReport:
    """One sweep's Fig.-6 fidelity artifact from a ``run_many`` sweep.

    ``trend_corr`` is the full S×S trend-correlation matrix over the
    sweep's streams — every dataset's original stream followed by every
    dataset's simulated stream at ``max_range`` — computed from ONE
    batched chain (on the torch backend the whole counts → trend →
    correlation chain stays on the device, consuming the engine's
    device-resident count rows directly). ``labels[i]`` names row/column
    ``i`` (``"<dataset>/original"`` or ``"<dataset>/sim<max_range>"``).

    Matrix entries for empty / zero-variance streams are NaN in memory and
    serialize to ``null`` in :meth:`to_json` (bare ``NaN`` tokens are not
    valid JSON and would break non-Python consumers of the artifact).
    """

    max_range: int
    window_s: int
    labels: List[str]
    trend_corr: List[List[float]]
    #: cross-host merge provenance: ``provenance[i]`` names the
    #: host/worker that produced row ``i``'s count data, parallel to
    #: ``labels``. None (single-host artifacts) keeps it out of the JSON
    #: payload.
    provenance: Optional[List[Optional[str]]] = None

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["trend_corr"] = [[None if v != v else v for v in row]
                           for row in self.trend_corr]
        if self.provenance is None:
            d.pop("provenance")
        return d


# ---------------------------------------------------------------- execution
def _local_scenarios(plan: SweepPlan) -> Tuple[Tuple[str, int], ...]:
    """The plan's scenarios THIS process reports, in grid order."""
    if plan.n_hosts == 1:
        return tuple(s.scenario for s in plan.scenarios)
    local = {s.scenario for s in plan.local_missing} | \
        {s.scenario for s in plan.cached}
    return tuple(s.scenario for s in plan.scenarios if s.scenario in local)


def _local_datasets(plan: SweepPlan) -> Tuple[str, ...]:
    """The datasets of :func:`_local_scenarios`, in the plan's order."""
    read = {d for d, _ in _local_scenarios(plan)}
    return tuple(d for d in plan.datasets if d in read)


@dataclasses.dataclass
class ShardResult:
    """One shard's device-resident NSA + metrics output.

    ``ss_kept``/``idx`` are the :func:`~repro_torch.streamsim.nsa.
    nsa_sweep_device` handles and ``hist`` the per-second count matrix,
    all still on the shard's device (a chunked run consumed its handles
    chunk by chunk and leaves ``ss_kept``/``idx`` None). Only ``totals``
    and ``mom`` — O(rows) report scalars — live on the host.
    """

    shard: Shard
    pairs: Tuple[Tuple[str, int], ...]
    ss_kept: object          # (R, K) int32 device
    idx: object              # (R, N) int32 device
    totals: np.ndarray       # (R,) int64 host
    hist: object             # (R, max_range) int32 device
    mom: np.ndarray          # (R, 2) float64 host
    nsa_s: float


class DeviceSweepResult:
    """Executed sweep: device-resident handles + lazy materialization.

    ``mode`` is ``"device"`` (kernel chain) or ``"host"`` (the numpy
    composition, also the wholesale domain fallback). ``device`` is the
    report-reduction device (the first shard device; unused in host mode).
    ``autotune`` is the tile-tuning mode of every deferred device leg (the
    host-group metrics and the fidelity matrices), whose winners persist
    under the store (:mod:`repro_torch.kernels.tuning`; an unknown mode
    raises ``ValueError`` when a leg runs).
    """

    def __init__(self, plan: SweepPlan, originals: Dict[str, Stream],
                 store, backend: str, mode: str, device=None,
                 autotune: Optional[str] = None):
        self.plan = plan
        self.originals = originals
        self.store = store
        self.backend = backend
        self.mode = mode
        self.device = device
        self.autotune = autotune
        self.nsa_s: Dict[Tuple[str, int], float] = {}
        self.shard_results: List[ShardResult] = []
        #: cache-hit sims (host mode: ALL sims), loaded/computed on host
        self.host_sims: Dict[Tuple[str, int], Stream] = {}
        self.sm: Dict[Tuple[str, int], StreamMetrics] = {}  # host mode only
        self._om: Dict[str, StreamMetrics] = {}
        self._cached_sm: Dict[Tuple[str, int], StreamMetrics] = {}
        self._host_group_done = False
        self._sims: Optional[Dict[Tuple[str, int], Stream]] = None
        self._persisted = False   # shard sims written to the store yet?
        self._stats: Optional[Dict] = None
        self._om_mat = None   # the originals' rows on the report device
        #: the originals' count rows and moments that the NSA legs counted
        #: on the device (:meth:`count_originals`), one entry a launch:
        #: ``(datasets, hist (k, W) int32, mom (k, 2) f32)``, on the
        #: launch's device
        self._orig_rows: List[Tuple[Tuple[str, ...], object, object]] = []
        self._orig_dev = None
        self._time_trs: Optional[Dict[str, int]] = None
        #: optional SweepCheckpoint; materialize() then persists
        #: per-scenario completion markers for crash-resume
        self.checkpoint: Optional[SweepCheckpoint] = None
        #: per-scenario EFFECTIVE simulated range (``ScenarioSpec.span_s``
        #: — ``max_range`` per simulated day of a multi-day sweep)
        self.spans: Dict[Tuple[str, int], int] = {
            s.scenario: s.span_s for s in plan.scenarios}
        self._store_keys: Dict[Tuple[str, int], str] = {
            s.scenario: s.store_key for s in plan.scenarios}
        #: chunked runs set this: scenario -> kept-row count, so
        #: ``build_report`` never needs the (unbounded-memory)
        #: ``materialize()`` host pass just to count rows
        self.sim_row_counts: Optional[Dict[Tuple[str, int], int]] = None
        #: chunked device runs set this: seconds spent dispatching chunks,
        #: in host legs, and of those waiting on the chunks' copy events
        self.pipeline_s: Dict[str, float] = {}

    @property
    def om(self) -> Dict[str, StreamMetrics]:
        """Per-dataset original-stream metrics of :attr:`datasets`,
        computed lazily when report statistics are read: the rows the NSA
        legs counted on the device (:meth:`count_originals`) in one copy to
        the host, and one batched metrics call over the other originals and
        the cache-hit sims."""
        self._ensure_host_group()
        return self._om

    @property
    def datasets(self) -> Tuple[str, ...]:
        """The datasets of :attr:`scenarios`, in the plan's order: the
        originals whose statistics this process's reports, matrices and
        published rows read."""
        return _local_datasets(self.plan)

    def count_originals(self, pairs, sources) -> None:
        """Queue B3's time form over the originals of ``pairs`` that no
        earlier leg counted, read from ``sources`` (the float64 copy of them
        a B1 launch left on the device), and keep the rows for the report:
        one launch, no wait, nothing record-sized allocated. Originals the
        time form does not take (:meth:`_time_series_lengths`), or a launch
        outside its domain, are left to the report's ``metrics_batched``."""
        from repro_torch.kernels import ops

        trs = self._time_series_lengths()
        counted = {d for names, _, _ in self._orig_rows for d in names}
        rows = [d for d, _ in pairs]
        names = [d for d in dict.fromkeys(rows)
                 if d in trs and d not in counted]
        if not names:
            return
        which = [int(sources.row_source[rows.index(d)]) for d in names]
        try:
            hist, mom = ops.original_metrics(sources, which,
                                             max(trs.values()))
        except ops.PallasDomainError:
            return
        self._orig_rows.append((tuple(names), hist, mom))

    def _time_series_lengths(self) -> Dict[str, int]:
        """dataset -> series length of each original that B3's time form
        counts: a non-empty float64 stream without scale stamps, whose
        series fits the int32 histogram (the others go through
        ``metrics_batched``)."""
        from repro_torch.kernels import ops

        if self._time_trs is None:
            self._time_trs = {}
            for d in self.datasets:
                st = self.originals[d]
                if st.scale_stamp is not None or len(st) == 0 or \
                        np.asarray(st.t).dtype != np.float64:
                    continue
                try:
                    self._time_trs[d] = ops.time_series_length(st.t)
                except ops.PallasDomainError:
                    pass
        return self._time_trs

    def _orig_device(self):
        """``(datasets, hist, mom)``: the rows the NSA legs counted on the
        report device in the plan's dataset order, ``hist`` (k, W) int32
        with ``W`` the longest row's series length, ``mom`` (k, 2) f32 (k
        may be 0)."""
        import torch

        if self._orig_dev is None:
            at = {}
            for names, hist, mom in self._orig_rows:
                for i, d in enumerate(names):
                    at.setdefault(d, (hist, mom, i))
            ds = tuple(d for d in self.datasets if d in at)
            if ds:
                w = max(self._time_series_lengths()[d] for d in ds)
                hist = torch.cat([at[d][0][at[d][2]:at[d][2] + 1, :w].to(
                    self.device) for d in ds])
                mom = torch.cat([at[d][1][at[d][2]:at[d][2] + 1].to(
                    self.device) for d in ds])
            else:
                hist = mom = None
            self._orig_dev = (ds, hist, mom)
        return self._orig_dev

    def _tuned(self):
        """The store-backed tuner context of this result's device legs (the
        reference gives the host-group metrics a tuner without the store;
        here its winners persist with the rest of the run's)."""
        from repro_torch.kernels import tuning
        return tuning.tuner_context(self.autotune, store=self.store or None,
                                    device=self.device)

    def _ensure_host_group(self) -> None:
        """The originals' and the cache hits' statistics: the originals the
        NSA legs counted on the device come from one copy of their rows
        and moments (``device_rows``); the other originals and the cache
        hits from one ``metrics_batched`` call (``host_rows``)."""
        import torch

        if self._host_group_done:
            return
        self._host_group_done = True
        datasets = list(self.datasets)
        cached = [s.scenario for s in self.plan.cached]
        dev_ds, hist, mom = self._orig_device()
        host_ds = [d for d in datasets if d not in dev_ds]
        om = {}
        with tracing.span("report.stats", rows=len(datasets) + len(cached),
                          device_rows=len(dev_ds),
                          host_rows=len(host_ds) + len(cached)), \
                self._tuned():
            if dev_ds:
                trs = [self._time_series_lengths()[d] for d in dev_ds]
                w = max(trs)
                both = torch.cat([hist[:, :w], mom.view(torch.int32)],
                                 dim=1).cpu().numpy()
                m = both[:, w:].view(np.float32).astype(np.float64)
                for i, (d, tr) in enumerate(zip(dev_ds, trs)):
                    om[d] = StreamMetrics(
                        both[i, :tr].astype(np.int64),
                        _volatility_from_moments(m[i, 0], m[i, 1], tr))
            if host_ds or cached:
                ms = metrics_batched(
                    [self.originals[d] for d in host_ds] +
                    [self.host_sims[sc] for sc in cached],
                    [None] * len(host_ds) + [mr for _, mr in cached],
                    backend=self.backend, device=self.device)
                om.update(zip(host_ds, ms[:len(host_ds)]))
                self._cached_sm = dict(zip(cached, ms[len(host_ds):]))
        self._om = {d: om[d] for d in datasets}

    # ------------------------------------------------------------- topology
    @property
    def scenarios(self) -> Tuple[Tuple[str, int], ...]:
        """The scenarios THIS process reports: the full grid in a
        single-process run; cached + this process's shard scenarios
        otherwise."""
        return _local_scenarios(self.plan)

    def _scenario_sources(self):
        """scenario -> ("shard", shard_result, row) | ("host", None, None)"""
        src = {sc: ("host", None, None) for sc in self.host_sims}
        for sr in self.shard_results:
            for r, sc in enumerate(sr.pairs):
                src[sc] = ("shard", sr, r)
        return src

    # ---------------------------------------------------------------- stats
    def _ensure_stats(self) -> Dict:
        """Per-scenario report statistics, computed batched on first use.

        Device mode: volatilities come from the O(S) moment scalars; all
        per-pair trend correlations come from one plain-PyTorch chain over
        the device-resident count rows. Host mode: the f64 host statistics.
        """
        if self._stats is None:
            with tracing.span("report.stats", rows=len(self.scenarios)):
                self._stats = self._compute_stats()
        return self._stats

    def _compute_stats(self) -> Dict:
        stats: Dict[Tuple[str, int], Dict] = {}
        if self.mode == "host":
            for sc in self.scenarios:
                stats[sc] = {
                    "volatility": self.sm[sc].volatility,
                    "trend_corr": trend_correlation_from_counts(
                        self.om[sc[0]].counts, self.sm[sc].counts,
                        REPORT_TREND_WINDOW_S),
                }
            return stats

        self._ensure_host_group()
        src = self._scenario_sources()
        scenarios = list(self.scenarios)
        if not scenarios:
            return stats
        for sc in scenarios:
            kind, sr, r = src[sc]
            if kind == "shard":
                vol = _volatility_from_moments(
                    float(sr.mom[r, 0]), float(sr.mom[r, 1]),
                    self.spans.get(sc, sc[1]))
            else:
                vol = self._cached_sm[sc].volatility
            stats[sc] = {"volatility": vol}

        corrs = self._pairwise_trend_corrs(scenarios, src)
        for sc, r in zip(scenarios, corrs):
            stats[sc]["trend_corr"] = float(r)
        return stats

    def _sim_count_rows(self, scenarios, src, width: int):
        """Stack the scenarios' per-second count rows on the report device.

        Shard rows are already device-resident histograms; cache-hit rows
        (host data) upload once as a group. Returns
        ``(qmat (P, width) int32 tensor, lengths, totals)``.
        """
        import torch

        self._ensure_host_group()    # cache-hit rows need host metrics
        groups, order = [], []       # group tensors + scenario positions
        pos = {sc: p for p, sc in enumerate(scenarios)}
        home = self.device
        for sr in self.shard_results:
            rows = [sc for sc in sr.pairs if sc in pos]
            if not rows:
                continue
            take = torch.tensor([sr.pairs.index(sc) for sc in rows],
                                device=sr.hist.device)
            h = sr.hist.index_select(0, take)
            pad = width - h.shape[1]
            if pad > 0:
                h = torch.nn.functional.pad(h, (0, pad))
            groups.append(h[:, :width].to(home))
            order.extend(pos[sc] for sc in rows)
        hosted = [sc for sc in scenarios if src[sc][0] == "host"]
        if hosted:
            hmat = np.zeros((len(hosted), width), np.int32)
            for i, sc in enumerate(hosted):
                q = self._cached_sm[sc].counts
                hmat[i, :min(len(q), width)] = q[:width]
            groups.append(torch.from_numpy(hmat).to(home))
            order.extend(pos[sc] for sc in hosted)
        qmat = torch.cat(groups, dim=0)
        perm = np.argsort(np.array(order), kind="stable")
        qmat = qmat.index_select(0, torch.from_numpy(perm).to(home))
        lengths = np.array([self.spans.get(sc, sc[1]) for sc in scenarios],
                           np.int64)
        totals = np.array(
            [src[sc][1].totals[src[sc][2]] if src[sc][0] == "shard"
             else int(self._cached_sm[sc].counts.sum())
             for sc in scenarios], np.int64)
        return qmat, lengths, totals

    def _orig_count_matrix(self):
        """(D, W) int32 matrix of the originals' count rows on the report
        device (cached) + per-dataset lengths/totals: the rows the NSA legs
        counted on the device as they are, the others in one upload."""
        import torch

        if self._om_mat is not None:
            return self._om_mat
        datasets = list(self.datasets)
        trs = np.array([len(self.om[d].counts) for d in datasets], np.int64)
        W = max(int(trs.max(initial=1)), 1)
        totals = np.array([int(self.om[d].counts.sum())
                           for d in datasets], np.int64)
        dev_ds, hist, _ = self._orig_device()
        if list(dev_ds) == datasets:
            mat = hist[:, :W]
        else:
            host = np.zeros((len(datasets), W), np.int32)
            for i, d in enumerate(datasets):
                if d not in dev_ds:
                    host[i, :trs[i]] = self.om[d].counts
            mat = torch.from_numpy(host).to(self.device)
            if dev_ds:
                rows = hist[:, :W]
                if rows.shape[1] < W:
                    rows = torch.nn.functional.pad(
                        rows, (0, W - rows.shape[1]))
                pos = torch.tensor([datasets.index(d) for d in dev_ds],
                                   device=self.device)
                mat.index_copy_(0, pos, rows)
        self._om_mat = (mat, trs, totals,
                        {d: i for i, d in enumerate(datasets)})
        return self._om_mat

    def _pairwise_trend_corrs(self, scenarios, src) -> np.ndarray:
        """Every report's (original, simulated) trend correlation from one
        chain on the device; falls back to the f64 host loop on domain
        errors."""
        from repro_torch.kernels import ops

        try:
            om_mat, om_trs, om_totals, didx = self._orig_count_matrix()
            rows = np.array([didx[sc[0]] for sc in scenarios])
            width = max(int(self.spans.get(sc, sc[1])) for sc in scenarios)
            qb, lb, sim_totals = self._sim_count_rows(scenarios, src, width)
            totals = np.concatenate([om_totals, sim_totals])
            # unique originals + a_index: each original's full-length
            # trend is computed once per sweep, not once per scenario
            return ops.trend_corr_pairwise(om_mat, om_trs, qb, lb,
                                           REPORT_TREND_WINDOW_S,
                                           totals=totals, a_index=rows)
        except ops.PallasDomainError:
            return np.array([trend_correlation_from_counts(
                self.om[sc[0]].counts, self._counts_host(sc, src),
                REPORT_TREND_WINDOW_S)
                for sc in scenarios])

    def _counts_host(self, sc, src) -> np.ndarray:
        kind, sr, r = src[sc]
        if kind == "host":
            self._ensure_host_group()
            return self._cached_sm[sc].counts
        return sr.hist[r, :self.spans.get(sc, sc[1])].cpu().numpy() \
            .astype(np.int64)

    def count_rows(self, scenarios=None) -> Dict[Tuple[str, int],
                                                 np.ndarray]:
        """Per-second simulated count rows gathered to the host, scenario
        -> int64 array (the export a cross-host fidelity merge reads:
        exact integers, so the merging side can recompute the full S×S
        matrix)."""
        if scenarios is None:
            scenarios = self.scenarios
        if self.mode == "host":
            self._ensure_host_group()
            return {sc: np.asarray(self.sm[sc].counts
                                   if sc in self.sm
                                   else self._cached_sm[sc].counts,
                                   dtype=np.int64)
                    for sc in scenarios}
        src = self._scenario_sources()
        return {sc: self._counts_host(sc, src) for sc in scenarios}

    # ------------------------------------------------------------- fidelity
    def fidelity(self, window_s: int = 60) -> List[FidelityReport]:
        """One S×S trend-correlation matrix per ``max_range`` over
        ``[originals..., sims@max_range...]``.

        Device mode reads the count rows where they already are: the
        originals' rows (one upload per sweep) and the shards' histogram
        rows are stacked on the report device and go through B4 -> trends
        -> resample -> B5 (:func:`~repro_torch.kernels.ops.
        trend_correlation_batched_device`); a domain error falls back to
        the f64 numpy matrix. Host mode runs
        :func:`~repro_torch.streamsim.metrics.trend_correlation_matrix` on
        the host counts with the sweep's backend.
        """
        with tracing.span("fidelity") as sp:
            out = self._fidelity_matrices(window_s)
            sp.count(matrices=len(out))
        return out

    def _fidelity_matrices(self, window_s: int) -> List[FidelityReport]:
        import torch

        from repro_torch.kernels import ops

        datasets = list(self.plan.datasets)
        out = []
        reported = set(self.scenarios)
        src = self._scenario_sources() if self.mode == "device" else {}
        for mr in self.plan.max_ranges:
            scs = [(d, mr) for d in datasets if (d, mr) in reported]
            if not scs:
                continue
            row_ds = [d for d, _ in scs]
            labels = [f"{d}/original" for d in row_ds] + \
                [f"{d}/sim{mr}" for d in row_ds]
            if self.mode == "host":
                with self._tuned():
                    matrix = trend_correlation_matrix(
                        [self.om[d].counts for d in row_ds] +
                        [self.sm[(d, mr)].counts for d in row_ds],
                        window_s=window_s, backend=self.backend,
                        device=self.device)
            else:
                try:
                    om_mat, om_trs, om_totals, didx = \
                        self._orig_count_matrix()
                    sel = np.array([didx[d] for d in row_ds])
                    om_sel = om_mat.index_select(
                        0, torch.from_numpy(sel).to(om_mat.device))
                    w_sc = max(int(self.spans.get(sc2, mr))
                               for sc2 in scs)
                    qb, lb, sim_totals = self._sim_count_rows(
                        scs, src, max(int(om_sel.shape[1]), w_sc))
                    pad = qb.shape[1] - om_sel.shape[1]
                    if pad > 0:
                        om_sel = torch.nn.functional.pad(om_sel, (0, pad))
                    qmat = torch.cat([om_sel, qb], dim=0)
                    lengths = np.concatenate([om_trs[sel], lb])
                    totals = np.concatenate([om_totals[sel], sim_totals])
                    with self._tuned():
                        matrix = ops.trend_correlation_batched_device(
                            qmat, lengths, window_s, totals=totals)
                except ops.PallasDomainError:
                    matrix = trend_correlation_matrix(
                        [self.om[d].counts for d in row_ds] +
                        [self._counts_host((d, mr), src)
                         for d in row_ds],
                        window_s=window_s, backend="numpy")
            out.append(FidelityReport(mr, window_s, labels,
                                      np.asarray(matrix).tolist()))
        return out

    # ---------------------------------------------------------- materialize
    def materialize(self, store=None) -> Dict[Tuple[str, int], Stream]:
        """The single lazy host pass: gather every shard scenario's kept
        payload columns from the device handles, persist the simulated
        streams (``store`` defaults to the plan's store; pass ``False``
        to skip persistence), and return the full scenario → Stream map.
        The gather is idempotent; persistence happens once, and then marks
        the scenarios materialized on the checkpoint, if there is one."""
        store = self.store if store is None else store
        if self._sims is not None and (self._persisted or not store):
            return self._sims
        with tracing.span("materialize") as sp:
            if self._sims is None:
                sims: Dict[Tuple[str, int], Stream] = dict(self.host_sims)
                for sr in self.shard_results:
                    if sr.ss_kept is None:
                        # chunked run: the handles were consumed chunk by
                        # chunk and the streams are already durable —
                        # reassemble them from the store's chunk files
                        # (everything lands on the host; bounded-memory
                        # callers read ``sim_row_counts``)
                        for sc in sr.pairs:
                            sims[sc] = self.store.get(self._store_keys[sc])
                    else:
                        sims.update(materialize_sweep(
                            self.originals, list(sr.pairs), sr.ss_kept,
                            sr.idx, sr.totals))
                self._sims = {sc: sims[sc] for sc in self.scenarios}
                sp.count(records=sum(int(np.sum(sr.totals))
                                     for sr in self.shard_results))
            if store and not self._persisted:
                shard_scs = [sc for sr in self.shard_results
                             for sc in sr.pairs]
                store.put_many(
                    {f"{d}__sim{mr}": self._sims[(d, mr)]
                     for d, mr in shard_scs if (d, mr) in self._sims},
                    {f"{d}__sim{mr}": {"max_range": mr}
                     for d, mr in shard_scs})
                self._persisted = True
                if self.checkpoint is not None:
                    # resume marker: these scenarios' streams are now
                    # durable
                    self.checkpoint.mark_materialized(
                        [s.scenario for s in self.plan.local_missing])
        return self._sims


def _shard_devices(device) -> list:
    """The devices plan shards map onto: every CUDA device for a bare
    ``"cuda"``, else just the given one."""
    import torch

    from repro_torch.kernels import ops

    dev = ops.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def execute_sweep(plan: SweepPlan, originals: Dict[str, Stream], store, *,
                  backend: str = "auto", multiple_mode: str = "time",
                  device=None,
                  checkpoint: Optional[SweepCheckpoint] = None,
                  autotune: Optional[str] = None) -> DeviceSweepResult:
    """Execute a plan's NSA + metrics stages.

    Device mode (resolved ``"torch"``): each shard runs ONE B1 → B2 chain
    on its device (:func:`~repro_torch.streamsim.nsa.nsa_sweep_device`)
    chained straight into ONE B3 call
    (:func:`~repro_torch.kernels.ops.stream_metrics_batched_device`) — the
    kept stamps never visit the host. Any
    :class:`~repro_torch.kernels.ops.PallasDomainError` (or an empty source
    stream) falls back to host mode wholesale.

    Host mode (resolved ``"numpy"``): per-scenario numpy NSA + one
    ``metrics_batched`` call over ``[originals..., sims...]``.

    ``device`` (``None`` means CUDA) is only read in device mode.
    ``checkpoint`` marks the scenarios materialized once their streams are
    durable (at once in host mode, at :meth:`DeviceSweepResult.materialize`
    in device mode). Returns a :class:`DeviceSweepResult`; NSA wall time is
    recorded per scenario (the shared total for co-simulated scenarios, 0.0
    for cache hits) and the simulated streams are **not** yet materialized.
    ``autotune`` is the tile-tuning mode of every device leg, its winners
    persisted under ``store`` (:mod:`repro_torch.kernels.tuning`).
    """
    resolved = _resolve_backend(backend)
    missing = list(plan.local_missing)
    device_ok = (resolved == "torch" and
                 all(len(originals[s.dataset]) > 0 for s in missing))
    result = None
    if device_ok:
        result = _execute_device(plan, originals, store, backend,
                                 multiple_mode, device, autotune)
    if result is None:
        result = _execute_host(plan, originals, store, backend,
                               multiple_mode, device, autotune)
    result.checkpoint = checkpoint
    if checkpoint is not None and result.mode == "host" and store:
        # host mode persists its sims eagerly inside _execute_host
        checkpoint.mark_materialized(
            [s.scenario for s in plan.local_missing])
    return result


def _execute_device(plan, originals, store, backend, multiple_mode,
                    device, autotune=None) -> Optional[DeviceSweepResult]:
    """The kernel path; returns None when a domain error demands the
    wholesale host fallback."""
    from repro_torch.kernels import ops, tuning

    devices = _shard_devices(device)
    result = DeviceSweepResult(plan, originals, store, backend, "device",
                               device=devices[0], autotune=autotune)
    total_nsa = 0.0
    try:
        with tuning.tuner_context(autotune, store=store or None,
                                  device=devices[0]):
            for shard in plan.shards:
                pairs = tuple(s.scenario for s in shard.specs)
                dev = devices[shard.device_index % len(devices)]
                t0 = time.perf_counter()
                with tracing.span("nsa", records_in=sum(
                        len(originals[d]) for d, _ in pairs)) as sp:
                    # the originals' statistics, queued on B1's copy of
                    # them before B2 allocates: nothing keeps the copy
                    # past B1, so B2's buffers never sit beside it
                    ss_kept, idx, totals, _ = nsa_sweep_device(
                        originals, pairs, multiple_mode=multiple_mode,
                        device=dev, on_upload=functools.partial(
                            result.count_originals, pairs))
                    with tracing.span("nsa.kernels"):
                        hist, mom = ops.stream_metrics_batched_device(
                            ss_kept, totals, shard.max_range)
                        mom_host = mom.cpu().numpy().astype(
                            np.float64)  # O(rows)
                    sp.count(kept=int(np.sum(totals)))
                dt = time.perf_counter() - t0
                total_nsa += dt
                result.shard_results.append(ShardResult(
                    shard=shard, pairs=pairs, ss_kept=ss_kept, idx=idx,
                    totals=np.asarray(totals, np.int64), hist=hist,
                    mom=mom_host, nsa_s=dt))
    except ops.PallasDomainError:
        return None   # out-of-domain scenario: host mode, wholesale

    for spec in plan.cached:
        result.host_sims[spec.scenario] = store.get(spec.store_key)
    for sc in (s.scenario for s in plan.scenarios):
        result.nsa_s[sc] = 0.0
    for sr in result.shard_results:
        for sc in sr.pairs:
            result.nsa_s[sc] = total_nsa
    return result


def _execute_host(plan, originals, store, backend, multiple_mode,
                  device, autotune=None) -> DeviceSweepResult:
    """The host path: per-scenario numpy NSA, one batched metrics call.
    The metrics keep the caller's backend (a domain error in NSA alone does
    not demote in-domain torch metrics); only ``backend="numpy"`` gives
    f64 host statistics throughout."""
    result = DeviceSweepResult(plan, originals, store, backend, "host",
                               device=device, autotune=autotune)
    t0 = time.perf_counter()
    for spec in plan.local_missing:
        result.host_sims[spec.scenario] = nsa(
            originals[spec.dataset], spec.max_range,
            multiple_mode=multiple_mode, backend="numpy")
    t_sweep = time.perf_counter() - t0
    if store:
        for spec in plan.local_missing:
            store.put(spec.store_key, result.host_sims[spec.scenario],
                      {"max_range": spec.max_range})
    for spec in plan.cached:
        result.host_sims[spec.scenario] = store.get(spec.store_key)
    for spec in plan.scenarios:
        result.nsa_s[spec.scenario] = \
            0.0 if spec.cached else t_sweep
    scenarios = [sc for sc in (s.scenario for s in plan.scenarios)
                 if sc in result.host_sims]
    _host_stats(result, scenarios, [mr for _, mr in scenarios])
    return result


def _host_stats(result: DeviceSweepResult, scenarios, ranges) -> None:
    """A host-mode result's statistics: ONE ``metrics_batched`` call over
    ``[originals..., sims...]`` (each sim over its range in ``ranges``),
    which also covers the cache hits, and the sims to report."""
    datasets = list(result.datasets)
    ms = metrics_batched(
        [result.originals[d] for d in datasets] +
        [result.host_sims[sc] for sc in scenarios],
        [None] * len(datasets) + list(ranges),
        backend=result.backend, device=result.device)
    result._om = dict(zip(datasets, ms[:len(datasets)]))
    result.sm = dict(zip(scenarios, ms[len(datasets):]))
    result._host_group_done = True   # one call covered everything
    result._sims = {sc: result.host_sims[sc] for sc in scenarios}


# -------------------------------------------------------------- PSDA replay
def _replay(producer, queues: Dict, consumers: Optional[Dict] = None,
            main=None, deadline_s: Optional[float] = None, **counts):
    """The one producer/consumer harness of every replay.

    Inside a ``replay`` span (``counts`` are its opening counts),
    ``producer.run`` (a :class:`Producer` or a :class:`MultiQueueProducer`)
    walks on its own thread under ``replay.produce``; each of
    ``consumers`` (key -> consumer of ``queues[key]``) drains its queue on
    its own thread under ``replay.consume`` (a failed one keeps draining,
    so the walk never blocks on it); and ``main``, if given, runs on the
    CALLING thread, its exceptions propagating at once.

    ``deadline_s`` bounds the consumers' joins: a consumer still running
    at the deadline with buckets available (or its stream closed) is
    *wedged* — its queue is closed (the walk sheds just that scenario) and
    it fails with a named ``TimeoutError`` instead of hanging the replay;
    *starved* consumers (empty open queue — victims of shared backpressure
    behind the wedged sibling) get a 5 s grace join once the walk is done.

    Returns ``(main's result, {key: consumer result}, {key: consumer
    error}, producer status, wall seconds of the replay span)``.
    """
    consumers = consumers or {}
    results: Dict = {}
    errors: Dict[object, BaseException] = {}
    status = [None]
    t0 = time.perf_counter()
    with tracing.span("replay", **counts) as sp:
        within = sp.context()

        def _produce():
            with tracing.span("replay.produce", within=within) as ps:
                status[0] = producer.run()
                n = producer.emitted_buckets
                ps.count(buckets=n if isinstance(n, int)
                         else sum(n.values()))

        def _consume(key):
            with tracing.span("replay.consume", within=within):
                try:
                    results[key] = consumers[key](queues[key])
                except Exception as exc:  # keep the producer walk drainable
                    errors[key] = exc
                    for _ in queues[key]:
                        pass

        prod_th = threading.Thread(target=_produce, daemon=True)
        cons = {key: threading.Thread(target=_consume, args=(key,),
                                      daemon=True) for key in consumers}
        prod_th.start()
        for th in cons.values():
            th.start()
        out = main() if main is not None else None
        deadline = Deadline(deadline_s)
        for th in cons.values():
            th.join(deadline.remaining())    # None remaining == join forever
        for key, th in cons.items():
            q = queues[key]
            if th.is_alive() and (q.qsize() > 0 or q.closed):
                # wedged: buckets available (or stream over) yet not
                # finishing — shed it so the walk and its siblings complete
                errors[key] = _deadline_error(deadline_s, key, consumers[key])
                q.close()
        prod_th.join()
        # post-shed grace: starved consumers (empty queue behind the wedged
        # sibling's backpressure) finish quickly once the producer resumed;
        # already-errored (wedged) threads are abandoned, not re-joined
        grace = Deadline(5.0 if deadline_s is not None else None)
        for key, th in cons.items():
            if key in errors:
                continue
            if th.is_alive():
                th.join(grace.remaining())
            if th.is_alive():
                errors[key] = _deadline_error(deadline_s, key, consumers[key])
                queues[key].close()
        sp.count(buckets=sum(q.buckets_in for q in queues.values()),
                 records=sum(q.records_in for q in queues.values()))
    return out, results, errors, status[0], time.perf_counter() - t0


def _degraded(exc: BaseException, attempts: int, queue, producer_stats,
              **state) -> Dict:
    """The partial per-scenario metrics of a scenario whose consumer failed
    for good (``on_failure="degrade"``): the failure, the attempts, any
    resilience ``state``, and the transport counters."""
    return {"degraded": True, "failed": repr(exc), "attempts": attempts,
            **state, **queue.stats(), **producer_stats}


def _raise_failures(errors: Dict, keys, what: str) -> None:
    """Raise ONE ``RuntimeError`` naming every failed scenario (in ``keys``
    order), the scenario exceptions chained via ``__cause__``, the first
    failure outermost, so no traceback is swallowed."""
    ordered = [(key, errors[key]) for key in keys if key in errors]
    cause = None
    for _, exc in reversed(ordered):  # first failure outermost
        # a consumer exception may already carry its own __cause__ chain —
        # link the NEXT failure to that chain's tail so no failure becomes
        # unreachable
        tail, seen = exc, {id(exc)}
        while tail.__cause__ is not None and id(tail.__cause__) not in seen:
            tail = tail.__cause__
            seen.add(id(tail))
        if tail.__cause__ is None and tail is not cause:
            tail.__cause__ = cause
        cause = exc
    detail = "; ".join(f"{key!r}: {exc!r}" for key, exc in ordered)
    raise RuntimeError(f"{len(ordered)} of {len(keys)} {what} consumer(s) "
                       f"failed: {detail}") from cause


def replay_one(sim: Stream, consumer, queue_size: int, faults=None):
    """Single-scenario PSDA leg (``Controller.run``): a producer thread
    fills a bounded queue under a :class:`VirtualClock`, the consumer
    drains it on the CALLING thread (so the consumer needs no thread
    safety). ``faults`` optionally attaches one scenario's
    :class:`~repro_torch.streamsim.faults.FaultInjector` schedule."""
    queue = StreamQueue(maxsize=queue_size)
    producer = Producer(sim, queue, clock=VirtualClock(), faults=faults)
    consumer_metrics, _, _, status, t_prod = _replay(
        producer, {None: queue}, main=lambda: consumer(queue))
    if status != 0:
        raise RuntimeError("producer reported fault status")
    return ({**consumer_metrics, **queue.stats(), **producer.stats()},
            t_prod)


def consumer_label(consumer) -> Optional[str]:
    """The task name a consumer advertises — ``.task_name``, ``.name``
    (the task tier's consumers) or ``.__name__``, in that order. Surfaced in the deadline errors so a wedged *task* is
    named alongside its scenario (one sweep can interleave many tasks;
    "scenario ('sogouq', 600) timed out" alone does not say WHICH task
    wedged)."""
    for attr in ("task_name", "name", "__name__"):
        label = getattr(consumer, attr, None)
        if isinstance(label, str) and label:
            return label
    return None


def _deadline_error(deadline_s, key, consumer) -> TimeoutError:
    """The wedged-consumer TimeoutError, naming scenario AND task."""
    task = consumer_label(consumer)
    tag = f" running task {task!r}" if task else ""
    return TimeoutError(
        f"consumer deadline ({deadline_s}s) exceeded for {key!r}{tag}")


def _replay_solo(key, sim: Stream, consumer, queue_size: int,
                 deadline_s: Optional[float], faults) -> Dict:
    """One scenario's retry replay (the resilience layer's unit of work):
    fresh bounded queue + producer thread, the consumer on its own
    deadline-joined thread. Returns the merged per-scenario stats or
    raises the consumer's error (``TimeoutError`` on a blown deadline).
    """
    queue = StreamQueue(maxsize=queue_size)
    producer = Producer(sim, queue, clock=VirtualClock(), faults=faults)
    _, results, errors, status, _ = _replay(
        producer, {key: queue}, {key: consumer}, deadline_s=deadline_s)
    if key in errors:
        raise errors[key]
    if status != 0:
        raise RuntimeError("producer reported fault status")
    return {**results[key], **queue.stats(), **producer.stats()}


def replay_many(sims: Dict, consumer, queue_size: int, *,
                fault_plan: Optional[FaultPlan] = None,
                retry_policy: Optional[RetryPolicy] = None,
                breaker_threshold: int = 3,
                consumer_deadline_s: Optional[float] = None,
                on_failure: str = "raise",
                max_bytes: Optional[int] = None,
                retention_policy: str = "block"):
    """Batched PSDA leg: ONE
    :class:`~repro_torch.streamsim.producer.MultiQueueProducer` virtual-time
    loop interleaves every scenario's buckets; each scenario's consumer
    drains its own bounded queue in its own thread (shared backpressure
    makes concurrent drains mandatory — a full sibling queue stalls the
    whole loop). Returns ``({scenario: merged stats}, shared wall time)``
    with per-scenario stats equivalent to sequential :func:`replay_one`
    calls.

    Resilience layer (all off by default; with the defaults the replay is
    a plain fault-free walk):

    - ``fault_plan`` injects the seeded chaos schedule into the producer
      walk and wraps each consumer with its crash schedule.
    - ``consumer_deadline_s`` bounds the joint consumer joins: a consumer
      still running at the deadline with buckets available (or its stream
      closed) is *wedged* — its queue is closed (the producer walk sheds
      just that scenario) and it fails with a named ``TimeoutError``
      instead of hanging the sweep; *starved* consumers (empty open
      queue — victims of shared backpressure behind the wedged sibling)
      get a short post-shed grace join.
    - ``retry_policy`` retries each failed scenario solo with capped
      exponential backoff; each retry rewinds the scenario's fault
      schedule (``FaultInjector.reset``) while the crash-attempt counter
      advances, so a transient injected crash heals deterministically.
    - a per-scenario :class:`~repro_torch.streamsim.resilience.CircuitBreaker`
      (``breaker_threshold`` consecutive failures) stops burning backoff
      budget on a persistently-broken consumer.
    - ``on_failure="degrade"`` converts terminal failures into partial
      per-scenario stats (``degraded``/``failed``/``attempts``/
      ``breaker`` + transport counters) instead of raising, so one broken
      scenario no longer fails the whole sweep.
    - ``max_bytes``/``retention_policy`` put the queue group under a
      shared byte budget (broker retention; see
      :class:`~repro_torch.streamsim.queue.ByteBudget`).

    Raises
    ------
    RuntimeError
        With ``on_failure="raise"`` (default), if ANY scenario's consumer
        terminally fails: every failure is aggregated into one error
        naming the failed scenarios, with the scenario exceptions chained
        via ``__cause__`` (first failure outermost) so no traceback is
        swallowed. Also raised on a producer fault status.
    """
    if on_failure not in ("raise", "degrade"):
        raise ValueError(
            f"on_failure must be 'raise' or 'degrade', got {on_failure!r}")
    group = QueueGroup(sims, maxsize=queue_size, max_bytes=max_bytes,
                       retention_policy=retention_policy)
    producer = MultiQueueProducer(sims, group.queues, clock=VirtualClock(),
                                  fault_plan=fault_plan)
    wrapped = {key: (fault_plan.wrap_consumer(key, consumer)
                     if fault_plan is not None else consumer)
               for key in sims}
    _, results, errors, status, t_prod = _replay(
        producer, group.queues, wrapped, deadline_s=consumer_deadline_s,
        scenarios=len(sims))

    # ---- phase 2: solo retries with backoff, behind the breaker
    attempts = {key: 1 for key in errors}
    breaker_state = {key: "closed" for key in errors}
    # separate dict: an abandoned (wedged) consumer thread may still
    # write ``results[key]`` concurrently; retries must not race it
    solo_results: Dict = {}
    for key in [k for k in sims if k in errors]:
        breaker = CircuitBreaker(breaker_threshold)
        breaker.record_failure()            # the joint-loop failure
        breaker_state[key] = breaker.state
        if retry_policy is None:
            continue
        inj = (fault_plan.injector(key)
               if fault_plan is not None and
               not fault_plan.is_noop_for(key) else None)
        while attempts[key] < retry_policy.max_attempts and breaker.allow():
            time.sleep(retry_policy.delay(attempts[key], key))
            attempts[key] += 1
            if inj is not None:
                inj.reset()                 # same transport schedule;
            try:                            # crash attempts still advance
                merged = _replay_solo(key, sims[key], wrapped[key],
                                      queue_size, consumer_deadline_s, inj)
                merged["retries"] = attempts[key] - 1
                solo_results[key] = merged
                breaker.record_success()
                del errors[key]
                break
            except Exception as retry_exc:
                errors[key] = retry_exc
                breaker.record_failure()
        breaker_state[key] = breaker.state

    # ---- phase 3: assemble / degrade / raise
    all_metrics: Dict = {}
    for key in sims:
        if key in errors:
            continue
        if key in solo_results:             # solo stats already merged
            all_metrics[key] = solo_results[key]
        else:
            all_metrics[key] = {**results[key], **group[key].stats(),
                                **producer.stats(key)}
    if errors and on_failure == "raise":
        _raise_failures(errors, list(sims), "sweep")
    for key in errors:
        all_metrics[key] = _degraded(errors[key], attempts[key], group[key],
                                     producer.stats(key),
                                     breaker=breaker_state[key])
    if status != 0:
        raise RuntimeError("producer reported fault status")
    return all_metrics, t_prod


# ----------------------------------------------------------- report assembly
def build_report(result: DeviceSweepResult, scenario: Tuple[str, int],
                 t_pre: float, t_prod: float,
                 consumer_metrics: Dict) -> SimulationReport:
    """Assemble one scenario's :class:`SimulationReport` from the executed
    sweep's statistics. Degraded replay metrics yield a
    ``status="partial"`` report carrying the terminal failure."""
    with tracing.span("report.build"):
        return _build_report(result, scenario, t_pre, t_prod,
                             consumer_metrics)


def _build_report(result: DeviceSweepResult, scenario: Tuple[str, int],
                  t_pre: float, t_prod: float,
                  consumer_metrics: Dict) -> SimulationReport:
    d, mr = scenario
    stats = result._ensure_stats()[scenario]
    original = result.originals[d]
    if result.sim_row_counts is not None and scenario in \
            result.sim_row_counts:
        # chunked run: the row count was accumulated per chunk — no
        # whole-stream host pass just to measure it
        simulated_rows = int(result.sim_row_counts[scenario])
    else:
        simulated_rows = len(result.materialize()[scenario])
    degraded = bool(consumer_metrics.get("degraded"))
    return SimulationReport(
        dataset=d,
        max_range=mr,
        original_rows=len(original),
        simulated_rows=simulated_rows,
        compression=compression_factor(original, mr),
        original_volatility=result.om[d].volatility,
        simulated_volatility=stats["volatility"],
        trend_corr=stats["trend_corr"],
        preprocess_s=t_pre,
        nsa_s=result.nsa_s[scenario],
        produce_s=t_prod,
        consumer_metrics=consumer_metrics,
        status="partial" if degraded else "ok",
        failure=consumer_metrics.get("failed") if degraded else None,
        attempts=int(consumer_metrics.get(
            "attempts", consumer_metrics.get("retries", 0) + 1)),
    )


def run_sweep(result: DeviceSweepResult, consumer, *,
              queue_size: int = 64, fidelity_window_s: int = 60,
              t_pre: Optional[Dict[str, float]] = None,
              fault_plan: Optional[FaultPlan] = None,
              retry_policy: Optional[RetryPolicy] = None,
              breaker_threshold: int = 3,
              consumer_deadline_s: Optional[float] = None,
              on_failure: str = "raise",
              max_bytes: Optional[int] = None,
              retention_policy: str = "block",
              checkpoint: Optional[SweepCheckpoint] = None,
              on_report=None, fidelity: bool = True
              ) -> Tuple[List[SimulationReport], List[FidelityReport]]:
    """Layer 3: fidelity matrices → materialize → batched replay → reports.

    The full report tail of ``Controller.run_many``, consuming the
    :class:`DeviceSweepResult` directly: fidelity is computed from the
    device-resident count rows BEFORE the single
    :meth:`~DeviceSweepResult.materialize` host pass, every scenario then
    replays through ONE multi-queue virtual-time loop, and one
    :class:`SimulationReport` per scenario is assembled in grid order.
    Persistence of both artifacts stays with the caller (the controller's
    metrics repository). The resilience keywords pass straight through to
    :func:`replay_many`; ``checkpoint`` persists each report's completion
    marker as soon as it is assembled, so a sweep killed after k reports
    resumes with exactly k scenarios done. ``on_report`` (the sweep
    service's publish hook) is called with each report as soon as it is assembled
    — the sweep service uses it to publish result markers per scenario,
    so a worker killed mid-batch loses only its unpublished tail.
    ``fidelity=False`` skips the local matrix entirely (service workers
    publish raw count rows instead and the merger owns the matrix).
    """
    t_pre = t_pre or {}
    fid = result.fidelity(fidelity_window_s) if fidelity else []
    result._ensure_stats()        # device stats before the host pass
    sims = result.materialize()
    all_metrics, t_prod = replay_many(
        sims, consumer, queue_size, fault_plan=fault_plan,
        retry_policy=retry_policy, breaker_threshold=breaker_threshold,
        consumer_deadline_s=consumer_deadline_s, on_failure=on_failure,
        max_bytes=max_bytes, retention_policy=retention_policy)
    reports = []
    for sc in result.scenarios:
        r = build_report(result, sc, t_pre.get(sc[0], 0.0), t_prod,
                         all_metrics[sc])
        if checkpoint is not None:
            checkpoint.mark_report(r)     # marker lands per report, so a
        if on_report is not None:
            on_report(r)
        reports.append(r)                 # kill leaves a clean prefix
    return reports, fid


# ------------------------------------------------------- chunked pipeline
class ChunkedSweepRunner:
    """Chunked, double-buffered sweep execution — the unbounded-stream form.

    Splits every scenario's simulated timeline into ``plan.chunk_s``-second
    chunks and pipelines them through the device: chunk ``k+1``'s B1 → B2
    → B6 launches are queued before chunk ``k``'s host leg (wait for its
    staged copies → gather payload → ``StreamStore.append_chunk`` → feed
    the replay) runs. Dispatch never reads a device value: every size comes
    from the host tables, and each chunk's outputs are copied into pinned
    host memory behind a CUDA event (:meth:`~repro_torch.streamsim.nsa.
    ChunkHandles.to_host`), so the host leg waits for its own chunk only,
    never for the next chunk already queued on the same stream.
    Cross-chunk state stays on the device in a
    :class:`~repro_torch.kernels.ops.ChunkCarry` (running histogram, Kahan
    ``[Σq, Σq²]`` state, prefix-sum tail, trend window tail), so the
    per-chunk outputs compose to the monolithic sweep's answer: counts
    exact, moments within ~1e-5, trend and fidelity within 1e-3.

    Host residency is bounded: per scenario at most the in-flight chunk
    plus the :class:`~repro_torch.streamsim.producer.ChunkFeed` buffer
    (``maxsize=2``) exist on the host at once; the feed's
    ``feed_hwm_chunks`` stat, in every report's ``consumer_metrics``, is
    the proof.

    Resume is chunk-granular: ``append_chunk`` skips chunks already on
    disk, so a killed multi-day run recomputes device work but rewrites
    only the missing chunk files, and scenario-level resume (the
    checkpoint's markers) still prunes completed scenarios from the plan.

    ``backend`` resolution mirrors :func:`execute_sweep`: resolved
    ``"torch"`` runs the device pipeline above on ``device`` (domain
    errors fall back wholesale at CONSTRUCTION, before any chunk state
    exists); resolved ``"numpy"`` runs the host composition — whole-stream
    numpy NSA and f64 statistics — with the same chunked persist and
    chunked replay feed.
    """

    def __init__(self, plan: SweepPlan, originals: Dict[str, Stream],
                 store, *, backend: str = "auto",
                 multiple_mode: str = "time", device=None,
                 checkpoint: Optional[SweepCheckpoint] = None,
                 autotune: Optional[str] = None):
        from repro_torch.kernels import ops

        if plan.chunk_s <= 0:
            raise ValueError(
                "plan has no chunk axis — build it with plan_sweep("
                "chunk_s=...) to use the chunked runner")
        self.plan = plan
        self.originals = originals
        self.store = store
        self.backend = backend
        self.multiple_mode = multiple_mode
        self.device = device
        self.autotune = autotune
        self.checkpoint = checkpoint
        self.chunk_s = int(plan.chunk_s)
        self._specs = {s.scenario: s for s in plan.scenarios}
        self._shard_states: List[Dict] = []
        self._chunk_stats: Dict[str, Dict] = {}
        #: the composed result of the latest :meth:`run`
        self.result: Optional[DeviceSweepResult] = None
        self.mode = "host"
        if _resolve_backend(backend) == "torch" and all(
                len(originals[s.dataset]) > 0 for s in plan.local_missing):
            try:
                self._prep_device()
                self.mode = "device"
            except ops.PallasDomainError:
                self._shard_states = []   # wholesale host fallback

    @property
    def scenarios(self) -> Tuple[Tuple[str, int], ...]:
        """The scenarios THIS process replays and reports (grid order) —
        mirrors :attr:`DeviceSweepResult.scenarios`."""
        return _local_scenarios(self.plan)

    def _prep_device(self) -> None:
        """Upload every shard's tables ONCE; domain errors surface here,
        before any chunk state exists."""
        from repro_torch.kernels import ops

        devices = _shard_devices(self.device)
        for shard in self.plan.shards:
            dev = devices[shard.device_index % len(devices)]
            # no tuner of its own: its chunks run inside run()'s
            # store-backed one
            cn = ChunkedNSA(self.originals,
                            [(s.dataset, s.span_s) for s in shard.specs],
                            multiple_mode=self.multiple_mode, device=dev)
            self._shard_states.append({
                "shard": shard,
                "nsa": cn,
                "carry": ops.chunk_carry_init(
                    len(shard.specs), cn.width,
                    window=REPORT_TREND_WINDOW_S, device=dev),
                "totals": np.zeros(len(shard.specs), np.int64),
            })

    # ------------------------------------------------------------- pipeline
    def run(self, feeds: Optional[Dict[Tuple[str, int], ChunkFeed]] = None
            ) -> DeviceSweepResult:
        """Drive the full chunk pipeline; returns the composed result.

        ``feeds`` (scenario → :class:`ChunkFeed`) receives every chunk
        stream in round order — chunk ``k`` of EVERY scenario lands before
        any scenario's chunk ``k+1`` — and each feed is closed after its
        scenario's last chunk, so the chunked replay walk starts as soon as
        chunk 0 lands. On any error every feed is closed before re-raising
        (the producer side unblocks instead of deadlocking). Every device
        leg runs under the ``autotune`` mode's tuner, its winners persisted
        under the store.
        """
        from repro_torch.kernels import tuning
        try:
            with tuning.tuner_context(self.autotune,
                                      store=self.store or None,
                                      device=self.device):
                self.result = (self._run_device(feeds)
                               if self.mode == "device"
                               else self._run_host(feeds))
            return self.result
        except BaseException:
            if feeds:
                for f in feeds.values():
                    f.close()
            raise

    def _note_chunk(self, key: str, chunk: Stream) -> None:
        """Fold one appended chunk into the manifest stats, so
        ``finalize_chunks`` never re-reads what this process just wrote."""
        st = self._chunk_stats.setdefault(
            key, {"rows": 0, "nbytes": 0, "t_first": None, "t_last": None})
        st["rows"] += len(chunk)
        st["nbytes"] += chunk.nbytes()
        if len(chunk):
            if st["t_first"] is None:
                st["t_first"] = float(chunk.t[0])
            st["t_last"] = float(chunk.t[-1])

    def _manifest_stats(self, key: str) -> Optional[Dict]:
        st = self._chunk_stats.get(key)
        if st is None:
            return None
        return {"rows": st["rows"], "nbytes": st["nbytes"],
                "time_range_s": ((st["t_last"] - st["t_first"])
                                 if st["t_first"] is not None else 0.0)}

    def _feed_chunk(self, feeds, spec, k: int, chunk: Stream) -> None:
        if feeds is None or spec.scenario not in feeds:
            return
        feeds[spec.scenario].put(chunk)
        if k == spec.n_chunks - 1:
            feeds[spec.scenario].close()

    @staticmethod
    def _slice_stream(sim: Stream, lo: int, hi: int) -> Stream:
        """One chunk of an already-materialized sim (host data): its
        scale stamps are sorted, so the chunk is one searchsorted slice."""
        a, b = np.searchsorted(sim.scale_stamp, [lo, hi])
        return Stream(name=sim.name, t=sim.t[a:b],
                      payload={c: v[a:b] for c, v in sim.payload.items()},
                      scale_stamp=sim.scale_stamp[a:b])

    def _host_round(self, result, feeds, k: int,
                    scenarios: List) -> None:
        """Push chunk ``k`` of every HOST-materialized scenario (cache hits
        in device mode; everything in host mode) into the feeds and, for
        store-missing scenarios, append the chunk file."""
        missing = {s.scenario for s in self.plan.local_missing}
        for spec in scenarios:
            if k >= spec.n_chunks:
                continue
            sim = result.host_sims[spec.scenario]
            lo = k * self.chunk_s
            hi = min(lo + self.chunk_s, spec.span_s)
            chunk = self._slice_stream(sim, lo, hi)
            if self.store and spec.scenario in missing:
                self.store.append_chunk(spec.store_key, k, chunk)
                self._note_chunk(spec.store_key, chunk)
            self._feed_chunk(feeds, spec, k, chunk)

    def _dispatch_chunk(self, k: int) -> List[Tuple[Dict, object]]:
        """Queue chunk ``k``'s B1 → B2 → B6 on every shard still inside its
        timeline, and its outputs' copies to pinned host memory; waits for
        nothing."""
        from repro_torch.kernels import ops

        out = []
        for st in self._shard_states:
            lo = k * self.chunk_s
            hi = min(lo + self.chunk_s, st["nsa"].width)
            if lo >= hi:
                continue          # this shard's timeline is over
            h = st["nsa"].chunk(lo, hi)
            st["carry"] = ops.stream_metrics_chunk(
                st["carry"], h.ss_kept, h.totals, lo, hi)
            out.append((st, h.to_host()))
        return out

    def _host_leg(self, result, feeds, cached, handles, k: int) -> None:
        """Chunk ``k``'s host side: wait for its staged copies (its own
        event only), gather the payload, append the chunk files, feed the
        replay; then chunk ``k`` of the cache hits."""
        for st, h in handles:
            with tracing.span("chunk.event_wait", chunk=k):
                self._waited_s += h.wait()
            totals = h.totals.numpy().astype(np.int64)
            if not np.array_equal(totals, h.kept):
                raise RuntimeError(
                    f"chunk {k}: device kept counts {totals.tolist()} differ "
                    f"from the tables' {h.kept.tolist()}")
            chunks = materialize_sweep(self.originals, st["nsa"].pairs,
                                       h.ss_kept, h.idx, totals,
                                       rec_off=h.rec_off)
            for r, spec in enumerate(st["shard"].specs):
                if k >= spec.n_chunks:
                    continue
                chunk = chunks[st["nsa"].pairs[r]]
                st["totals"][r] += int(totals[r])
                if self.store:
                    self.store.append_chunk(spec.store_key, k, chunk)
                    self._note_chunk(spec.store_key, chunk)
                self._feed_chunk(feeds, spec, k, chunk)
        self._host_round(result, feeds, k, cached)

    def _run_device(self, feeds) -> DeviceSweepResult:
        from repro_torch.kernels import ops

        plan = self.plan
        result = DeviceSweepResult(
            plan, self.originals, self.store, self.backend, "device",
            device=self._shard_states[0]["nsa"].device
            if self._shard_states else _shard_devices(self.device)[0],
            autotune=self.autotune)
        result.checkpoint = self.checkpoint
        t0 = time.perf_counter()
        for spec in plan.cached:
            result.host_sims[spec.scenario] = \
                self.store.get(spec.store_key)
        cached = [s for s in plan.scenarios
                  if s.scenario in result.host_sims]

        # the double-buffered loop: dispatch k, THEN chunk k-1's host leg
        # (the extra last pass only drains the final chunk's host leg)
        self._waited_s = 0.0
        dispatch_s = host_s = 0.0
        prev: Optional[Tuple[List, int]] = None
        for k in range(plan.n_chunks + 1):
            t1 = time.perf_counter()
            cur = []
            if k < plan.n_chunks:
                with tracing.span("chunk.dispatch", chunk=k):
                    cur = self._dispatch_chunk(k)
            t2 = time.perf_counter()
            if prev is not None:
                with tracing.span("chunk.host_leg", chunk=prev[1]):
                    self._host_leg(result, feeds, cached, *prev)
            dispatch_s += t2 - t1
            host_s += time.perf_counter() - t2
            prev = (cur, k)
        result.pipeline_s = {"dispatch_s": dispatch_s, "host_leg_s": host_s,
                             "event_wait_s": self._waited_s}
        # the originals' statistics, from the rows ChunkedNSA holds
        for st in self._shard_states:
            result.count_originals(st["nsa"].pairs, st["nsa"].sources)

        # compose: fold each shard's carry into monolithic-shaped stats
        for st in self._shard_states:
            hist, mom2 = ops.chunk_carry_finalize(st["carry"])
            result.shard_results.append(ShardResult(
                shard=st["shard"],
                pairs=tuple(s.scenario for s in st["shard"].specs),
                ss_kept=None, idx=None, totals=st["totals"].copy(),
                hist=hist, mom=mom2.cpu().numpy().astype(np.float64),
                nsa_s=0.0))
        self._finalize_store(result, [spec for st in self._shard_states
                                      for spec in st["shard"].specs])
        total_s = time.perf_counter() - t0
        for sc in (s.scenario for s in plan.scenarios):
            result.nsa_s[sc] = 0.0
        result.sim_row_counts = {}
        for sr in result.shard_results:
            for r, sc in enumerate(sr.pairs):
                result.nsa_s[sc] = total_s
                result.sim_row_counts[sc] = int(sr.totals[r])
        for spec in plan.cached:
            result.sim_row_counts[spec.scenario] = \
                len(result.host_sims[spec.scenario])
        return result

    def _finalize_store(self, result, specs) -> None:
        """Write the chunked streams' manifests (their stats folded in as
        the chunks were appended) and mark them materialized."""
        if not self.store:
            return
        for spec in specs:
            self.store.finalize_chunks(
                spec.store_key, name=self.originals[spec.dataset].name,
                n_chunks=spec.n_chunks,
                extra_meta={"max_range": spec.max_range},
                stats=self._manifest_stats(spec.store_key))
        result._persisted = True
        if self.checkpoint is not None:
            self.checkpoint.mark_materialized(
                [s.scenario for s in self.plan.local_missing])

    def _run_host(self, feeds) -> DeviceSweepResult:
        plan = self.plan
        result = DeviceSweepResult(plan, self.originals, self.store,
                                   self.backend, "host", device=self.device,
                                   autotune=self.autotune)
        result.checkpoint = self.checkpoint
        t0 = time.perf_counter()
        for spec in plan.local_missing:
            result.host_sims[spec.scenario] = nsa(
                self.originals[spec.dataset], spec.span_s,
                multiple_mode=self.multiple_mode, backend="numpy")
        t_sweep = time.perf_counter() - t0
        for spec in plan.cached:
            result.host_sims[spec.scenario] = \
                self.store.get(spec.store_key)
        local = [s for s in plan.scenarios
                 if s.scenario in result.host_sims]
        for k in range(plan.n_chunks):
            self._host_round(result, feeds, k, local)
        self._finalize_store(result, plan.local_missing)
        for spec in plan.scenarios:
            result.nsa_s[spec.scenario] = 0.0 if spec.cached else t_sweep
        scenarios = [sc for sc in (s.scenario for s in plan.scenarios)
                     if sc in result.host_sims]
        _host_stats(result, scenarios,
                    [self._specs[sc].span_s for sc in scenarios])
        result.sim_row_counts = {sc: len(result.host_sims[sc])
                                 for sc in scenarios}
        return result


def run_sweep_chunked(runner: ChunkedSweepRunner, consumer, *,
                      queue_size: int = 64, fidelity_window_s: int = 60,
                      t_pre: Optional[Dict[str, float]] = None,
                      fault_plan: Optional[FaultPlan] = None,
                      on_failure: str = "raise",
                      max_bytes: Optional[int] = None,
                      retention_policy: str = "block",
                      checkpoint: Optional[SweepCheckpoint] = None
                      ) -> Tuple[List[SimulationReport],
                                 List[FidelityReport]]:
    """Layer 3 of the chunked pipeline: compute, persist and REPLAY
    chunk-overlapped.

    The calling thread drives :meth:`ChunkedSweepRunner.run`; the
    :class:`~repro_torch.streamsim.producer.MultiQueueProducer` (chunked
    walk) and the per-scenario consumers run on their own threads,
    consuming each scenario's :class:`~repro_torch.streamsim.producer.
    ChunkFeed` (``maxsize=2``): replay of chunk 0 starts while chunk 1 is
    still on the device, and backpressure chains queue → feed → runner so
    host residency stays bounded end to end.

    Differences from :func:`run_sweep`, by design: no
    ``retry_policy``/``consumer_deadline_s`` — a chunked replay cannot
    rewind a scenario's stream (its chunks are consumed as produced);
    ``on_failure="degrade"`` still converts terminal consumer failures into
    partial reports. Fault injection (``fault_plan``) applies unchanged:
    the producer-side schedule walks the chunked rounds as it walks the
    whole stream.
    """
    if on_failure not in ("raise", "degrade"):
        raise ValueError(
            f"on_failure must be 'raise' or 'degrade', got {on_failure!r}")
    t_pre = t_pre or {}
    scenarios = list(runner.scenarios)
    feeds = {sc: ChunkFeed(maxsize=2) for sc in scenarios}
    group = QueueGroup(feeds, maxsize=queue_size, max_bytes=max_bytes,
                       retention_policy=retention_policy)
    producer = MultiQueueProducer(feeds, group.queues,
                                  clock=VirtualClock(),
                                  fault_plan=fault_plan)
    wrapped = {sc: (fault_plan.wrap_consumer(sc, consumer)
                    if fault_plan is not None else consumer)
               for sc in scenarios}
    result, results, errors, status, t_prod = _replay(
        producer, group.queues, wrapped, main=lambda: runner.run(feeds),
        scenarios=len(scenarios))
    if errors and on_failure == "raise":
        _raise_failures(errors, scenarios, "chunked sweep")
    if status != 0:
        raise RuntimeError("producer reported fault status")

    all_metrics: Dict = {}
    for sc in scenarios:
        if sc in errors:
            all_metrics[sc] = _degraded(errors[sc], 1, group[sc],
                                        producer.stats(sc))
        else:
            all_metrics[sc] = {**results[sc], **group[sc].stats(),
                               **producer.stats(sc)}
    fidelity = result.fidelity(fidelity_window_s)
    result._ensure_stats()
    reports = []
    for sc in result.scenarios:
        r = build_report(result, sc, t_pre.get(sc[0], 0.0), t_prod,
                         all_metrics[sc])
        if checkpoint is not None:
            checkpoint.mark_report(r)
        reports.append(r)
    return reports, fidelity
