"""Controller — the user-side core component (paper §4).

The paper's controller has three functions, mirrored here:
  (1) control the producer to load + simulate a user-defined time range;
  (2) collect physical/workload metrics of the stream processing system;
  (3) manage metrics of different stream data for viewing.

The controller is a thin layer: :meth:`Controller.run` and
:meth:`Controller.run_many` build a :class:`~repro_torch.streamsim.plan.
SweepPlan` and hand it to the sweep engine (:mod:`repro_torch.streamsim.
engine`). What remains here is the paper-side surface: the store, the
metrics repository (a JSON directory, with the per-sweep fidelity matrices
under ``fidelity/``), and the per-dataset preprocessing timer.

``Controller(store_dir, device=None)``: the torch backend runs on
``device`` (``None`` means CUDA, and raises where CUDA is unavailable);
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.distributed import process_topology
from repro_torch.streamsim import engine
from repro_torch.streamsim.datasets import make_stream
from repro_torch.streamsim.engine import FidelityReport, SimulationReport
from repro_torch.streamsim.faults import FaultPlan
from repro_torch.streamsim.nsa import _resolve_backend, nsa
from repro_torch.streamsim.plan import DAY_S, plan_sweep
from repro_torch.streamsim.preprocess import Stream, preprocess
from repro_torch.streamsim.queue import StreamQueue
from repro_torch.streamsim.resilience import RetryPolicy, SweepCheckpoint
from repro_torch.streamsim.service import (merge_fidelity, pack_counts,
                                           run_service_sweep,
                                           scenario_marker)
from repro_torch.streamsim.store import StreamStore


class Controller:
    def __init__(self, store_dir: str, metrics_dir: Optional[str] = None,
                 device=None):
        self.store = StreamStore(store_dir)
        self.metrics_dir = Path(metrics_dir or (Path(store_dir) / "_metrics"))
        self.metrics_dir.mkdir(parents=True, exist_ok=True)
        self.fidelity_dir = self.metrics_dir / "fidelity"
        self.device = device
        self._metrics_seq = itertools.count()
        #: the executed sweep of the latest :meth:`run` or :meth:`run_many`
        #: (its ``mode`` says whether the kernel chain ran or the host
        #: fallback did)
        self.last_result: Optional[engine.DeviceSweepResult] = None
        #: the per-sweep S×S fidelity matrices of the latest
        #: :meth:`run_many` (also persisted under ``fidelity_dir``)
        self.last_fidelity: List[FidelityReport] = []

    # ----------------------------------------------------- (1) simulate/run
    def prepare(self, dataset: str, *, scale: float = 1.0, seed: int = 0,
                force: bool = False) -> Stream:
        """POSD once, persist (preprocessing is a one-time job — paper §3.1)."""
        key = f"{dataset}__orig"
        if self.store.exists(key) and not force:
            return self.store.get(key)
        raw = make_stream(dataset, scale=scale, seed=seed)
        stream = preprocess(raw)
        self.store.put(key, stream, {"scale": scale, "seed": seed})
        return stream

    def simulate(self, dataset: str, max_range: int, *, scale: float = 1.0,
                 seed: int = 0, force: bool = False,
                 backend: str = "auto") -> Stream:
        """NSA once per (dataset, max_range), persist (paper §3.2). Every
        backend is bit-identical, so the store cache is backend-agnostic."""
        key = f"{dataset}__sim{max_range}"
        if self.store.exists(key) and not force:
            return self.store.get(key)
        original = self.prepare(dataset, scale=scale, seed=seed, force=force)
        sim = nsa(original, max_range, backend=backend, device=self.device)
        self.store.put(key, sim, {"max_range": max_range})
        return sim

    def _prepare_all(self, datasets: Sequence[str], scale: float,
                     seed: int, duration_s: int = 0) -> tuple:
        """POSD every dataset, timing each.

        ``duration_s > 0`` prepares the MULTI-DAY original instead
        (:meth:`_prepare_multiday`)."""
        originals, t_pre = {}, {}
        with tracing.span("prepare", datasets=len(datasets)):
            for d in datasets:
                t0 = time.perf_counter()
                if duration_s > 0:
                    originals[d] = self._prepare_multiday(d, scale, seed,
                                                          duration_s)
                else:
                    originals[d] = self.prepare(d, scale=scale, seed=seed)
                t_pre[d] = time.perf_counter() - t0
        return originals, t_pre

    def _prepare_multiday(self, dataset: str, scale: float, seed: int,
                          duration_s: int) -> Stream:
        """One preprocessed day per 86 400 s of ``duration_s`` (day ``d``
        generated with ``seed + d``, so days carry distinct traffic), each
        rebased onto ``[d·86400, (d+1)·86400)`` so the diurnal cycle stays
        aligned, concatenated and trimmed to ``duration_s``. Cached under
        ``<dataset>__orig__d<duration>``. Traced as the span
        ``prepare.multiday`` (``days``, ``records``, and ``cached``: 1 when
        read from the store, 0 when built)."""
        key = f"{dataset}__orig__d{duration_s}"
        n_days = -(-int(duration_s) // DAY_S)
        with tracing.span("prepare.multiday", days=n_days) as sp:
            cached = self.store.exists(key)
            stream = self.store.get(key) if cached else \
                self._build_multiday(dataset, scale, seed, duration_s, n_days)
            sp.count(records=len(stream), cached=int(cached))
        return stream

    def _build_multiday(self, dataset: str, scale: float, seed: int,
                        duration_s: int, n_days: int) -> Stream:
        key = f"{dataset}__orig__d{duration_s}"
        ts, payloads = [], []
        for day in range(n_days):
            st = preprocess(make_stream(dataset, scale=scale, seed=seed + day))
            # rebase the day onto its slot; clip a day running past
            # 86 400 s to the slot boundary so the concatenation stays
            # chronological
            t_day = np.minimum(st.t - st.t[0], float(DAY_S))
            ts.append(t_day + day * float(DAY_S))
            payloads.append(st.payload)
        t = np.concatenate(ts)
        payload = {c: np.concatenate([p[c] for p in payloads])
                   for c in payloads[0]}
        keep = t < float(duration_s)     # trim the partial last day
        stream = Stream(name=dataset, t=t[keep],
                        payload={c: v[keep] for c, v in payload.items()},
                        scale_stamp=None)
        self.store.put(key, stream, {"scale": scale, "seed": seed,
                                     "duration_s": int(duration_s)})
        return stream

    def run(self, dataset: str, max_range: int,
            consumer: Callable[[StreamQueue], Dict], *,
            scale: float = 1.0, seed: int = 0,
            queue_size: int = 64, backend: str = "auto",
            autotune: Optional[str] = None) -> SimulationReport:
        """Full pipeline: POSD -> NSA -> PSDA -> consumer (the SPS task).

        Parameters
        ----------
        dataset : str
            Dataset name (see :func:`repro_torch.streamsim.datasets.
            make_stream`).
        max_range : int
            Simulated time range for NSA.
        consumer : callable
            Drains the queue on the calling thread and returns its own
            metrics dict.
        scale, seed :
            Synthetic-dataset shape parameters (store-cache keyed).
        queue_size : int, default 64
            Bounded-queue capacity; the producer honours backpressure.
        backend : {"auto", "numpy", "torch"}
            ``"torch"`` (and ``"auto"``) runs NSA and metrics through the
            kernels on the controller's device; ``"numpy"`` on the host.
            NSA output is bit-identical across backends; out-of-domain
            inputs fall back to numpy automatically.
        autotune : {None, "off", "cached", "force"}, optional
            Kernel tile-tuning mode for every device leg
            (:mod:`repro_torch.kernels.tuning`). ``None``/``"off"`` keep
            the shipped tiles; ``"cached"`` reuses (or measures once and
            persists under the store) a winner per shape; ``"force"``
            re-measures. An unknown mode raises ``ValueError``.

        Returns
        -------
        SimulationReport
            Also persisted as JSON (function (3): the metrics repository).

        Raises
        ------
        RuntimeError
            If the producer reports a non-zero fault status, or the torch
            backend is asked for CUDA where CUDA is unavailable.
        """
        with tracing.call(entry="run", scenarios=1):
            originals, t_pre = self._prepare_all([dataset], scale, seed)
            plan = plan_sweep(self.store, [dataset], [max_range],
                              {dataset: len(originals[dataset])},
                              scale=scale, seed=seed, n_hosts=1,
                              host_index=0, n_devices=1)
            result = engine.execute_sweep(plan, originals, self.store,
                                          backend=backend,
                                          device=self.device,
                                          autotune=autotune)
            self.last_result = result
            sim = result.materialize()[(dataset, max_range)]
            consumer_metrics, t_prod = engine.replay_one(sim, consumer,
                                                         queue_size)
            report = engine.build_report(result, (dataset, max_range),
                                         t_pre[dataset], t_prod,
                                         consumer_metrics)
            self.save_metrics(report)
            return report

    def run_many(self, datasets: Sequence[str], max_ranges: Sequence[int],
                 consumer: Callable[[StreamQueue], Dict], *,
                 scale: float = 1.0, seed: int = 0, queue_size: int = 64,
                 backend: str = "auto", fidelity_window_s: int = 60,
                 n_devices: Optional[int] = None,
                 host_index: Optional[int] = None,
                 n_hosts: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker_threshold: int = 3,
                 consumer_deadline_s: Optional[float] = None,
                 on_failure: str = "raise",
                 max_bytes: Optional[int] = None,
                 retention_policy: str = "block",
                 checkpoint: bool = False,
                 chunk_s: int = 0,
                 duration_s: int = 0,
                 service: bool = False,
                 lease_ttl_s: float = 60.0,
                 service_poll_s: float = 0.2,
                 lease_batch: int = 1,
                 worker_id: Optional[str] = None,
                 service_deadline_s: Optional[float] = None,
                 autotune: Optional[str] = None
                 ) -> List[SimulationReport]:
        """The Tables 1-3 scenario sweep (datasets × time ranges), planned
        and executed by the sweep engine on the controller's device.

        :func:`~repro_torch.streamsim.plan.plan_sweep` resolves store cache
        hits and packs the missing scenarios into per-device shards; each
        shard runs B1 -> B2 -> B3 once
        (:func:`~repro_torch.streamsim.engine.execute_sweep`); one S×S
        fidelity matrix per ``max_range`` comes from the device-resident
        count rows through B4 and B5; the sims are materialized and stored
        once; and every scenario replays through ONE
        :class:`~repro_torch.streamsim.producer.MultiQueueProducer` loop
        (:func:`~repro_torch.streamsim.engine.run_sweep`). With ``chunk_s``
        the same sweep runs chunk by chunk instead (B1 -> B2 -> B6 per
        chunk; see ``chunk_s`` below).

        Parameters
        ----------
        datasets, max_ranges :
            The sweep grid is their cross product.
        consumer : callable
            Drains one scenario's queue and returns its metrics dict.
            Scenario consumers run CONCURRENTLY (one thread per scenario:
            the shared backpressure of the batched replay requires it), so
            a consumer shared across scenarios must be thread-safe.
        scale, seed, queue_size :
            As in :meth:`run`.
        backend : {"auto", "numpy", "torch"}
            ``"torch"`` (and ``"auto"``) runs the kernel chain on the
            controller's device; ``"numpy"`` reproduces the sequential
            per-scenario reports on the host. NSA output is bit-identical;
            statistics and fidelity matrices agree within 1e-3.
        fidelity_window_s : int, default 60
            Sliding-mean window of the fidelity matrices.
        n_devices, host_index, n_hosts : int, optional
            Plan-partition overrides (default:
            :func:`~repro_torch.distributed.process_topology`, the
            ``torch.distributed`` rank and world size and this process's
            CUDA device count). In a static multi-host run every host
            builds the same plan, runs and reports only its own slice
            (and the store's cache hits), publishes its exact count rows
            to the shared store, and the run that completes the grid gets
            the merged FULL S×S matrices on :attr:`last_fidelity`.
        fault_plan, retry_policy, breaker_threshold, consumer_deadline_s,
        on_failure, max_bytes, retention_policy :
            The replay's chaos and resilience knobs, passed through to
            :func:`~repro_torch.streamsim.engine.replay_many`.
        checkpoint : bool, default False
            Persist per-scenario completion markers through the stream
            store (namespace: :attr:`~repro_torch.streamsim.plan.SweepPlan.
            sweep_id`). A killed sweep re-invoked with the same arguments
            resumes: finished scenarios' reports load from their markers,
            only the remainder is planned and run, and the markers are
            cleared once the whole sweep completes (its fidelity matrices
            then cover the resumed subset).
        chunk_s : int, default 0
            ``> 0`` routes the sweep through the chunked double-buffered
            pipeline (:class:`~repro_torch.streamsim.engine.
            ChunkedSweepRunner` + :func:`~repro_torch.streamsim.engine.
            run_sweep_chunked`): each scenario's timeline is computed,
            persisted and replayed in ``chunk_s``-second chunks (B1, B2 and
            B6 per chunk) with the cross-chunk carry on the device, so host
            residency stays bounded (at most 2 chunks per scenario
            buffered; ``feed_hwm_chunks`` in each report's
            ``consumer_metrics``) while the reports compose to the
            monolithic answer. ``chunk_s`` does not enter the store key:
            chunked and monolithic runs share simulated streams. Not with
            ``retry_policy``/``consumer_deadline_s`` (a consumed chunk
            cannot be rewound); ``on_failure="degrade"`` still applies.
        duration_s : int, default 0
            ``> 0`` simulates a MULTI-DAY source: one preprocessed day per
            86 400 s (:meth:`_prepare_multiday`), every scenario's
            effective range growing to ``max_range`` per day
            (``ScenarioSpec.span_s``). Requires ``chunk_s > 0``.
        service : bool, default False
            Run the sweep through the lease-based sweep service
            (:mod:`repro_torch.streamsim.service`) instead of static host
            partitioning: scenarios go to a durable work queue in the
            store; every participant (each ``run_many(service=True)``
            pointed at the same store and sweep) leases, executes on this
            controller's device and publishes them; expired leases of dead
            workers are requeued (and quarantined as
            ``status="poisoned"`` after ``breaker_threshold`` worker deaths
            on one scenario); and EVERY participant returns the full
            grid's reports plus the merged full S×S fidelity matrices on
            :attr:`last_fidelity`. Incompatible with ``chunk_s`` and
            ``checkpoint``.
        lease_ttl_s, service_poll_s, lease_batch, worker_id, \
service_deadline_s :
            The service's knobs: lease time-to-live (must comfortably
            exceed one batch's runtime; heartbeats renew it while the
            worker lives), idle poll interval, scenarios leased per claim,
            this participant's id (default ``host<index>-<pid>``), and an
            overall give-up deadline (``TimeoutError``).
        autotune : {None, "off", "cached", "force"}, optional
            Kernel tile-tuning mode for the monolithic and chunked sweeps'
            device legs, as in :meth:`run` (the service mode runs its
            batches with the shipped tiles, as the reference's does).

        Returns
        -------
        list of SimulationReport
            One per (dataset, max_range), in ``for dataset: for max_range``
            order; ``nsa_s`` is the sweep's shared NSA time (0.0 for cache
            hits) and ``produce_s`` the shared replay time. Each report is
            also persisted as JSON; the fidelity matrices are on
            :attr:`last_fidelity` and under :attr:`fidelity_dir`.
        """
        if duration_s and not chunk_s:
            raise ValueError(
                "duration_s requires chunk_s > 0 — multi-day sweeps run "
                "through the chunked pipeline")
        if chunk_s and (retry_policy is not None or
                        consumer_deadline_s is not None):
            raise ValueError(
                "retry_policy/consumer_deadline_s are monolithic-replay "
                "features; the chunked pipeline cannot rewind a "
                "scenario's consumed chunks")
        if service and (chunk_s or checkpoint):
            raise ValueError(
                "service mode is incompatible with chunk_s/checkpoint — "
                "the service's durable work queue is its own checkpoint "
                "and leases are scenario-granular")
        with tracing.call(entry="run_many",
                          scenarios=len(datasets) * len(max_ranges)):
            originals, t_pre = self._prepare_all(datasets, scale, seed,
                                                 duration_s)
            if _resolve_backend(backend) == "numpy":
                # host mode ignores the partition: no device topology query
                n_devices = 1 if n_devices is None else n_devices
                host_index = 0 if host_index is None else host_index
                n_hosts = 1 if n_hosts is None else n_hosts
            row_counts = {d: len(originals[d]) for d in datasets}
            if service:
                return self._run_service(
                    datasets, max_ranges, originals, t_pre, consumer,
                    scale=scale, seed=seed, queue_size=queue_size,
                    backend=backend, fidelity_window_s=fidelity_window_s,
                    n_devices=n_devices, host_index=host_index,
                    n_hosts=n_hosts, fault_plan=fault_plan,
                    retry_policy=retry_policy,
                    breaker_threshold=breaker_threshold,
                    consumer_deadline_s=consumer_deadline_s,
                    on_failure=on_failure, max_bytes=max_bytes,
                    retention_policy=retention_policy,
                    lease_ttl_s=lease_ttl_s, service_poll_s=service_poll_s,
                    lease_batch=lease_batch, worker_id=worker_id,
                    service_deadline_s=service_deadline_s)
            plan = plan_sweep(self.store, datasets, max_ranges, row_counts,
                              scale=scale, seed=seed, n_devices=n_devices,
                              host_index=host_index, n_hosts=n_hosts,
                              chunk_s=chunk_s, duration_s=duration_s)
            grid = [s.scenario for s in plan.scenarios]
            if plan.n_hosts > 1:
                # this host reports its own slice and the store's cache hits
                local = {s.scenario for s in plan.local_missing} | \
                    {s.scenario for s in plan.cached}
                grid = [sc for sc in grid if sc in local]
            ckpt: Optional[SweepCheckpoint] = None
            prior: Dict = {}
            if checkpoint:
                ckpt = SweepCheckpoint(self.store, plan.sweep_id)
                done = set(ckpt.done_scenarios()) & set(grid)
                if done:
                    # resume: completed scenarios' reports come straight from
                    # their markers; only the remainder is planned and run
                    prior = {sc: r for sc, r in ckpt.load_reports().items()
                             if sc in done}
                    remaining = [sc for sc in grid if sc not in done]
                    plan = None if not remaining else plan_sweep(
                        self.store, datasets, max_ranges, row_counts,
                        scale=scale, seed=seed, pairs=remaining,
                        n_devices=n_devices, host_index=host_index,
                        n_hosts=n_hosts, chunk_s=chunk_s,
                        duration_s=duration_s)
            new_reports: List[SimulationReport] = []
            if plan is not None:
                if chunk_s:
                    runner = engine.ChunkedSweepRunner(
                        plan, originals, self.store, backend=backend,
                        device=self.device, checkpoint=ckpt, autotune=autotune)
                    new_reports, fidelity = engine.run_sweep_chunked(
                        runner, consumer, queue_size=queue_size,
                        fidelity_window_s=fidelity_window_s, t_pre=t_pre,
                        fault_plan=fault_plan, on_failure=on_failure,
                        max_bytes=max_bytes, retention_policy=retention_policy,
                        checkpoint=ckpt)
                    # run_sweep_chunked leaves the composed result on the
                    # runner
                    self.last_result = runner.result
                else:
                    result = engine.execute_sweep(plan, originals, self.store,
                                                  backend=backend,
                                                  device=self.device,
                                                  checkpoint=ckpt,
                                                  autotune=autotune)
                    self.last_result = result
                    new_reports, fidelity = engine.run_sweep(
                        result, consumer, queue_size=queue_size,
                        fidelity_window_s=fidelity_window_s, t_pre=t_pre,
                        fault_plan=fault_plan, retry_policy=retry_policy,
                        breaker_threshold=breaker_threshold,
                        consumer_deadline_s=consumer_deadline_s,
                        on_failure=on_failure, max_bytes=max_bytes,
                        retention_policy=retention_policy, checkpoint=ckpt)
                    if plan.n_hosts > 1:
                        # publish this host's exact count rows and, once every
                        # host's rows are in the store, replace the partial
                        # per-host matrices with the merged full matrices
                        merged = self._publish_and_merge_fidelity(
                            result, plan, fidelity_window_s)
                        if merged is not None:
                            fidelity = merged
                self.last_fidelity = fidelity
                for fr in fidelity:
                    self.save_fidelity(fr)
            by_sc = dict(prior)
            by_sc.update({(r.dataset, r.max_range): r for r in new_reports})
            reports = [by_sc[sc] for sc in grid]
            for report in reports:
                self.save_metrics(report)
            if ckpt is not None:
                ckpt.clear()     # sweep complete: the next run starts fresh
            return reports

    def _run_service(self, datasets, max_ranges, originals, t_pre,
                     consumer, *, scale, seed, queue_size, backend,
                     fidelity_window_s, n_devices, host_index, n_hosts,
                     fault_plan, retry_policy, breaker_threshold,
                     consumer_deadline_s, on_failure, max_bytes,
                     retention_policy, lease_ttl_s, service_poll_s,
                     lease_batch, worker_id,
                     service_deadline_s) -> List[SimulationReport]:
        """The ``run_many(service=True)`` leg: one participant of the
        lease-based sweep service, executing its batches on this
        controller's device. Every participant gets the full grid's
        reports back; only the reports THIS worker computed land in its
        metrics repository (the shared store carried them to every peer
        already)."""
        if n_hosts is None or host_index is None or n_devices is None:
            pidx, pcount, local = process_topology()
            n_hosts = pcount if n_hosts is None else n_hosts
            host_index = pidx if host_index is None else host_index
            n_devices = local if n_devices is None else n_devices
        if worker_id is None:
            worker_id = f"host{host_index}-{os.getpid()}"
        reports, fidelity, mine = run_service_sweep(
            self.store, datasets, max_ranges, originals, consumer,
            scale=scale, seed=seed, t_pre=t_pre, queue_size=queue_size,
            backend=backend, fidelity_window_s=fidelity_window_s,
            n_devices=n_devices, lease_ttl_s=lease_ttl_s,
            poll_s=service_poll_s, lease_batch=lease_batch,
            breaker_threshold=breaker_threshold, worker_id=worker_id,
            n_participants=n_hosts, deadline_s=service_deadline_s,
            device=self.device, fault_plan=fault_plan,
            retry_policy=retry_policy,
            consumer_deadline_s=consumer_deadline_s,
            on_failure=on_failure, max_bytes=max_bytes,
            retention_policy=retention_policy)
        self.last_fidelity = fidelity
        for fr in fidelity:
            self.save_fidelity(fr)
        own = set(mine)
        for report in reports:
            if scenario_marker(report.dataset, report.max_range) in own:
                self.save_metrics(report)
        return reports

    def _publish_and_merge_fidelity(self, result, plan, window_s):
        """Cross-host fidelity merge for STATIC multi-host sweeps.

        Publishes the original count rows of the datasets this host reports
        and then its exact per-scenario count rows under the host-independent
        ``sweep_group_id`` namespace, then runs the sweep service's
        count-row merge. Returns the merged full-grid
        :class:`FidelityReport` list, or None while peers' rows are still
        missing (the caller keeps its partial per-host matrices until the
        last host closes the sweep)."""
        gid = plan.sweep_group_id
        ns = f"{gid}/fidelity"
        worker = f"host{plan.host_index}"
        for d in result.datasets:
            name = f"orig__{d}"
            if not self.store.has_marker(ns, name):
                self.store.put_marker(ns, name, {
                    "counts": pack_counts(result.om[d].counts),
                    "worker": worker})
        for (d, mr), row in result.count_rows().items():
            name = f"sim__{scenario_marker(d, mr)}"
            # first writer wins: rows are deterministic, and keeping the
            # first writer keeps true provenance (a later host reporting
            # a cache hit must not claim the row it never computed)
            if not self.store.has_marker(ns, name):
                self.store.put_marker(ns, name,
                                      {"counts": pack_counts(row),
                                       "worker": worker})
        merged = merge_fidelity(self.store, gid, plan.datasets,
                                plan.max_ranges, window_s=window_s)
        D = len(plan.datasets)
        complete = len(merged) == len(plan.max_ranges) and \
            all(len(fr.labels) == 2 * D for fr in merged)
        return merged if complete else None

    # -------------------------------------------------- (3) metrics manager
    def _unique_path(self, directory: Path, stem: str) -> Path:
        """ms stamp + a monotonic per-controller sequence number, so two
        reports landing in the same millisecond never overwrite each
        other."""
        path = directory / f"{stem}_{next(self._metrics_seq):06d}.json"
        while path.exists():
            path = directory / f"{stem}_{next(self._metrics_seq):06d}.json"
        return path

    def save_metrics(self, report: SimulationReport) -> Path:
        stem = (f"{report.dataset}_max{report.max_range}_"
                f"{int(time.time() * 1e3)}")
        path = self._unique_path(self.metrics_dir, stem)
        with open(path, "w") as f:
            json.dump(report.to_json(), f, indent=2, default=_np_default)
        return path

    def save_fidelity(self, report: FidelityReport) -> Path:
        """Persist one sweep's S×S fidelity matrix under ``fidelity_dir``
        (outside ``metrics_dir`` proper, so :meth:`list_metrics` keeps its
        one-file-per-scenario contract). NaN entries are written as
        ``null``."""
        self.fidelity_dir.mkdir(parents=True, exist_ok=True)
        stem = f"fidelity_max{report.max_range}_{int(time.time() * 1e3)}"
        path = self._unique_path(self.fidelity_dir, stem)
        with open(path, "w") as f:
            json.dump(report.to_json(), f, indent=2, default=_np_default)
        return path

    def list_fidelity(self) -> List[Path]:
        return sorted(self.fidelity_dir.glob("*.json"))

    def load_fidelity(self) -> List[Dict]:
        out = []
        for p in self.list_fidelity():
            with open(p) as f:
                out.append(json.load(f))
        return out

    def list_metrics(self) -> List[Path]:
        return sorted(self.metrics_dir.glob("*.json"))

    def load_metrics(self) -> List[Dict]:
        out = []
        for p in self.list_metrics():
            with open(p) as f:
                out.append(json.load(f))
        return out


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
