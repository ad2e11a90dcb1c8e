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
- **Replay / report** (:func:`replay_one`, :func:`build_report`): the PSDA
  replay and the :class:`SimulationReport`, whose statistics read the
  original streams' metrics (one more B3 call) and the pairwise trend
  correlation (plain PyTorch, :func:`~repro_torch.kernels.ops.
  trend_corr_pairwise`).

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
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.streamsim.metrics import (StreamMetrics, Volatility,
                                           _volatility_from_moments,
                                           metrics_batched,
                                           trend_correlation_from_counts)
from repro_torch.streamsim.nsa import (_resolve_backend, compression_factor,
                                       materialize_sweep, nsa,
                                       nsa_sweep_device)
from repro_torch.streamsim.plan import Shard, SweepPlan
from repro_torch.streamsim.preprocess import Stream
from repro_torch.streamsim.producer import Producer, VirtualClock
from repro_torch.streamsim.queue import StreamQueue

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


# ---------------------------------------------------------------- execution
@dataclasses.dataclass
class ShardResult:
    """One shard's device-resident NSA + metrics output.

    ``ss_kept``/``idx`` are the :func:`~repro_torch.streamsim.nsa.
    nsa_sweep_device` handles and ``hist`` the per-second count matrix,
    all still on the shard's device. Only ``totals`` and ``mom`` — O(rows)
    report scalars — live on the host.
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
    """

    def __init__(self, plan: SweepPlan, originals: Dict[str, Stream],
                 store, backend: str, mode: str, device=None):
        self.plan = plan
        self.originals = originals
        self.store = store
        self.backend = backend
        self.mode = mode
        self.device = device
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
        self._om_mat = None   # cached device upload of the originals' rows
        #: per-scenario EFFECTIVE simulated range (``ScenarioSpec.span_s``)
        self.spans: Dict[Tuple[str, int], int] = {
            s.scenario: s.span_s for s in plan.scenarios}

    @property
    def om(self) -> Dict[str, StreamMetrics]:
        """Per-dataset original-stream metrics, computed lazily (one
        batched metrics call over the originals and the cache-hit sims,
        run only when report statistics are read)."""
        self._ensure_host_group()
        return self._om

    def _ensure_host_group(self) -> None:
        if self._host_group_done:
            return
        self._host_group_done = True
        datasets = list(self.plan.datasets)
        cached = [s.scenario for s in self.plan.cached]
        ms = metrics_batched(
            [self.originals[d] for d in datasets] +
            [self.host_sims[sc] for sc in cached],
            [None] * len(datasets) + [mr for _, mr in cached],
            backend=self.backend, device=self.device)
        self._om = dict(zip(datasets, ms[:len(datasets)]))
        self._cached_sm = dict(zip(cached, ms[len(datasets):]))

    # ------------------------------------------------------------- topology
    @property
    def scenarios(self) -> Tuple[Tuple[str, int], ...]:
        """The scenarios THIS process reports: the full grid in a
        single-process run; cached + this process's shard scenarios
        otherwise."""
        if self.plan.n_hosts == 1:
            return tuple(s.scenario for s in self.plan.scenarios)
        local = {s.scenario for s in self.plan.local_missing} | \
            {s.scenario for s in self.plan.cached}
        return tuple(s.scenario for s in self.plan.scenarios
                     if s.scenario in local)

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
        if self._stats is not None:
            return self._stats
        stats: Dict[Tuple[str, int], Dict] = {}
        if self.mode == "host":
            for sc in self.scenarios:
                stats[sc] = {
                    "volatility": self.sm[sc].volatility,
                    "trend_corr": trend_correlation_from_counts(
                        self.om[sc[0]].counts, self.sm[sc].counts,
                        REPORT_TREND_WINDOW_S),
                }
            self._stats = stats
            return stats

        self._ensure_host_group()
        src = self._scenario_sources()
        scenarios = list(self.scenarios)
        if not scenarios:
            self._stats = stats
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
        self._stats = stats
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
        device (one upload for the whole sweep, cached) + per-dataset
        lengths/totals."""
        import torch

        if self._om_mat is not None:
            return self._om_mat
        datasets = list(self.plan.datasets)
        trs = np.array([len(self.om[d].counts) for d in datasets], np.int64)
        W = max(int(trs.max(initial=1)), 1)
        mat = np.zeros((len(datasets), W), np.int32)
        for i, d in enumerate(datasets):
            mat[i, :trs[i]] = self.om[d].counts
        totals = np.array([int(self.om[d].counts.sum())
                           for d in datasets], np.int64)
        self._om_mat = (torch.from_numpy(mat).to(self.device), trs, totals,
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

    # ---------------------------------------------------------- materialize
    def materialize(self, store=None) -> Dict[Tuple[str, int], Stream]:
        """The single lazy host pass: gather every shard scenario's kept
        payload columns from the device handles, persist the simulated
        streams (``store`` defaults to the plan's store; pass ``False``
        to skip persistence), and return the full scenario → Stream map.
        The gather is idempotent; persistence happens once."""
        store = self.store if store is None else store
        if self._sims is None:
            sims: Dict[Tuple[str, int], Stream] = dict(self.host_sims)
            for sr in self.shard_results:
                sims.update(materialize_sweep(
                    self.originals, list(sr.pairs), sr.ss_kept, sr.idx,
                    sr.totals))
            self._sims = {sc: sims[sc] for sc in self.scenarios}
        if store and not self._persisted:
            shard_scs = [sc for sr in self.shard_results
                         for sc in sr.pairs]
            store.put_many(
                {f"{d}__sim{mr}": self._sims[(d, mr)]
                 for d, mr in shard_scs if (d, mr) in self._sims},
                {f"{d}__sim{mr}": {"max_range": mr}
                 for d, mr in shard_scs})
            self._persisted = True
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

    ``device`` (``None`` means CUDA) is only read in device mode. Returns a
    :class:`DeviceSweepResult`; NSA wall time is recorded per scenario (the
    shared total for co-simulated scenarios, 0.0 for cache hits) and the
    simulated streams are **not** yet materialized.
    """
    from repro_torch.kernels import ops

    ops.check_autotune(autotune)
    resolved = _resolve_backend(backend)
    missing = list(plan.local_missing)
    device_ok = (resolved == "torch" and
                 all(len(originals[s.dataset]) > 0 for s in missing))
    result = None
    if device_ok:
        result = _execute_device(plan, originals, store, backend,
                                 multiple_mode, device)
    if result is None:
        result = _execute_host(plan, originals, store, backend,
                               multiple_mode, device)
    return result


def _execute_device(plan, originals, store, backend, multiple_mode,
                    device) -> Optional[DeviceSweepResult]:
    """The kernel path; returns None when a domain error demands the
    wholesale host fallback."""
    from repro_torch.kernels import ops

    devices = _shard_devices(device)
    result = DeviceSweepResult(plan, originals, store, backend, "device",
                               device=devices[0])
    total_nsa = 0.0
    try:
        for shard in plan.shards:
            pairs = tuple(s.scenario for s in shard.specs)
            dev = devices[shard.device_index % len(devices)]
            t0 = time.perf_counter()
            ss_kept, idx, totals, _ = nsa_sweep_device(
                originals, pairs, multiple_mode=multiple_mode, device=dev)
            hist, mom = ops.stream_metrics_batched_device(
                ss_kept, totals, shard.max_range)
            mom_host = mom.cpu().numpy().astype(np.float64)  # O(rows)
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
                  device) -> DeviceSweepResult:
    """The host path: per-scenario numpy NSA, one batched metrics call.
    The metrics keep the caller's backend (a domain error in NSA alone does
    not demote in-domain torch metrics); only ``backend="numpy"`` gives
    f64 host statistics throughout."""
    result = DeviceSweepResult(plan, originals, store, backend, "host",
                               device=device)
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
    datasets = list(plan.datasets)
    ms = metrics_batched(
        [originals[d] for d in datasets] +
        [result.host_sims[sc] for sc in scenarios],
        [None] * len(datasets) + [mr for _, mr in scenarios],
        backend=backend, device=device)
    result._om = dict(zip(datasets, ms[:len(datasets)]))
    result.sm = dict(zip(scenarios, ms[len(datasets):]))
    result._host_group_done = True   # one call covered everything
    result._sims = {sc: result.host_sims[sc] for sc in scenarios}
    return result


# -------------------------------------------------------------- PSDA replay
def replay_one(sim: Stream, consumer, queue_size: int, faults=None):
    """Single-scenario PSDA leg (``Controller.run``): a producer thread
    fills a bounded queue under a :class:`VirtualClock`, the consumer
    drains it on the CALLING thread (so the consumer needs no thread
    safety). ``faults`` optionally attaches one scenario's
    :class:`~repro_torch.streamsim.faults.FaultInjector` schedule."""
    queue = StreamQueue(maxsize=queue_size)
    producer = Producer(sim, queue, clock=VirtualClock(), faults=faults)
    t0 = time.perf_counter()
    status = [None]

    def _produce():
        status[0] = producer.run()

    th = threading.Thread(target=_produce, daemon=True)
    th.start()
    consumer_metrics = consumer(queue)
    th.join()
    t_prod = time.perf_counter() - t0
    if status[0] != 0:
        raise RuntimeError("producer reported fault status")
    return ({**consumer_metrics, **queue.stats(), **producer.stats()},
            t_prod)


# ----------------------------------------------------------- report assembly
def build_report(result: DeviceSweepResult, scenario: Tuple[str, int],
                 t_pre: float, t_prod: float,
                 consumer_metrics: Dict) -> SimulationReport:
    """Assemble one scenario's :class:`SimulationReport` from the executed
    sweep's statistics. Degraded replay metrics yield a
    ``status="partial"`` report carrying the terminal failure."""
    d, mr = scenario
    stats = result._ensure_stats()[scenario]
    original = result.originals[d]
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
