"""Fault-tolerant distributed sweep service: leased work queue + merge.

Counterpart of ``repro/streamsim/service.py``. Any number of
participants (processes, hosts) pointed at one shared
:class:`~repro_torch.streamsim.store.StreamStore` serve one sweep
through a lease-based work queue arbitrated by the store's atomic marker
primitives; there is no coordinator process to keep alive. Each leased
batch runs through the ordinary plan → engine → replay path
(:func:`~repro_torch.streamsim.engine.execute_sweep` on the service's
``device``, then :func:`~repro_torch.streamsim.engine.run_sweep` with
``fidelity=False``), so on the torch backend every batch launches B1, B2
and B3 on that device.

Marker layout (all under ``_markers/<group>/`` where ``group`` is
:attr:`~repro_torch.streamsim.plan.SweepPlan.sweep_group_id`, the
host-independent sweep identity), byte-compatible with the reference's,
so participants of either package can serve one queue::

    meta/      claimant.json, ready.json      publisher election
    queue/     <dataset>__<max_range>.json    unclaimed scenarios
    leases/    <dataset>__<max_range>.json    Lease payloads (live claims)
    results/   <dataset>__<max_range>.json    report + worker provenance
    poison/    <dataset>__<max_range>.json    quarantined scenarios
    fidelity/  orig__<d>.json, sim__<d>__<mr>.json    exact count rows
    done/      <worker>.json                  finalization barrier

Protocol (``docs/robustness.md`` documents it in full):

1. **Publish**: one process wins the ``meta/claimant`` exclusive-create
   election, enqueues every unresolved grid scenario, then writes
   ``meta/ready``; everyone else waits for ``ready`` (with a
   dead-publisher takeover after a timeout, safe because nobody claims
   before ``ready`` exists).
2. **Claim**: a worker *moves* ``queue/<item>`` to ``leases/<item>`` (one
   ``os.replace``: of N racing claimants exactly one wins), then rewrites
   the lease with its :class:`~repro_torch.streamsim.resilience.Lease`. A
   background :class:`~repro_torch.streamsim.resilience.Heartbeat` renews
   the deadline while the batch executes.
3. **Publish results**: each report is published the moment it is
   assembled (``run_sweep(on_report=...)``), with the scenario's exact
   per-second count row, so a worker killed mid-batch loses only its
   unpublished tail.
4. **Reap**: every worker doubles as reaper. An expired lease means a
   dead worker; it is requeued behind a
   :class:`~repro_torch.streamsim.resilience.CircuitBreaker`: a scenario
   whose lease count reaches ``breaker_threshold`` is quarantined to
   ``poison/`` and surfaces as a ``status="poisoned"`` report.
5. **Merge**: finalization recomputes the FULL S×S fidelity matrix from
   the published count rows (exact integers) with the numpy reduction a
   single-host numpy run uses, so the merged matrix equals that
   artifact. ``FidelityReport.provenance`` names each row's worker.

Execution is at-least-once: a lease that expires while its worker is
merely slow lets a second worker re-run the scenario (deterministic, and
results are last-writer-wins markers), which is why ``lease_ttl_s``
should comfortably exceed a batch's runtime.
"""

from __future__ import annotations

import base64
import os
import socket
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.streamsim import engine
from repro_torch.streamsim.engine import FidelityReport, SimulationReport
from repro_torch.streamsim.metrics import (Volatility,
                                          trend_correlation_matrix)
from repro_torch.streamsim.plan import plan_sweep
from repro_torch.streamsim.resilience import CircuitBreaker, Heartbeat, Lease

__all__ = [
    "SweepService",
    "run_service_sweep",
    "merge_fidelity",
    "scenario_marker",
    "pack_counts",
    "unpack_counts",
]

#: how long ``ready``-waiters allow the elected publisher before assuming
#: it died mid-publish and taking over (takeover is idempotent: nobody
#: claims until ``ready`` exists, so no queue item can be in flight)
PUBLISH_TAKEOVER_S = 30.0


def pack_counts(counts) -> str:
    """``"<dtype>:<base64>"`` of the row as little-endian ints — exact
    (count rows are integers) and ~20x cheaper to round-trip through a
    JSON marker than a list of Python ints, which is what keeps the
    fidelity-row publication cheap enough for the service-overhead
    gate. Rows are day-long per-second vectors, so the int32/int64
    choice halves most payloads."""
    a = np.asarray(counts)
    code = "<i4" if (a.size == 0 or
                     (np.iinfo(np.int32).min <= int(a.min()) and
                      int(a.max()) <= np.iinfo(np.int32).max)) else "<i8"
    a = np.ascontiguousarray(a.astype(code))
    return f"{code}:" + base64.b64encode(a.tobytes()).decode("ascii")


def unpack_counts(counts) -> np.ndarray:
    """Inverse of :func:`pack_counts`; also accepts a plain int list (or
    an ndarray) so hand-written marker payloads and in-memory local rows
    merge identically."""
    if isinstance(counts, str):
        code, _, b64 = counts.partition(":")
        raw = base64.b64decode(b64.encode("ascii"))
        return np.frombuffer(raw, dtype=code).astype(np.int64)
    return np.asarray(counts, dtype=np.int64)


def scenario_marker(dataset: str, max_range: int) -> str:
    """Queue/lease/result marker name for one scenario. Dataset names
    must not contain ``"__"`` (the same naming contract
    :class:`~repro_torch.streamsim.resilience.SweepCheckpoint` relies on);
    payloads carry the authoritative ``dataset``/``max_range`` anyway."""
    return f"{dataset}__{int(max_range)}"


def default_worker_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"


class SweepService:
    """One worker's view of a lease-based sweep over a shared store.

    All coordination state lives in the store; any number of
    ``SweepService`` instances (across processes and hosts) pointed at
    the same store directory and the same sweep configuration cooperate
    on — and survive each other's deaths during — one sweep.

    ``device`` is where the torch backend runs each batch (``None``
    means CUDA, and raises where CUDA is unavailable; ``"cpu"`` runs the
    kernels' plain versions). The reference has no such argument: JAX
    places its arrays itself. A batch that raises (a CUDA error
    included) is struck back to the queue and, after
    ``breaker_threshold`` strikes, surfaces as a ``"poisoned"`` report.
    """

    def __init__(self, store, datasets: Sequence[str],
                 max_ranges: Sequence[int], *,
                 scale: float = 1.0, seed: int = 0,
                 lease_ttl_s: float = 60.0, poll_s: float = 0.2,
                 lease_batch: int = 1, breaker_threshold: int = 3,
                 worker_id: Optional[str] = None,
                 clock: Callable[[], float] = time.time, device=None):
        if lease_ttl_s <= 0:
            raise ValueError("lease_ttl_s must be > 0")
        if lease_batch < 1:
            raise ValueError("lease_batch must be >= 1")
        self.store = store
        self.datasets = list(datasets)
        self.max_ranges = [int(m) for m in max_ranges]
        self.scale = float(scale)
        self.seed = int(seed)
        self.ttl_s = float(lease_ttl_s)
        self.poll_s = float(poll_s)
        self.lease_batch = int(lease_batch)
        self.breaker_threshold = int(breaker_threshold)
        self.worker_id = worker_id or default_worker_id()
        self._clock = clock
        #: where the torch backend runs each batch (``None`` means CUDA)
        self.device = device
        #: fidelity rows THIS worker published, kept in memory so
        #: :meth:`finalize` merges them without re-reading its own
        #: markers (peers' rows still come from the store)
        self._local_rows: Dict[str, Dict] = {}
        # the group id is host-independent by construction, so a probe
        # plan with any host slot yields the shared namespace key
        probe = plan_sweep(store, self.datasets, self.max_ranges,
                           {d: 1 for d in self.datasets},
                           scale=self.scale, seed=self.seed,
                           n_devices=1, host_index=0, n_hosts=1)
        self.group = probe.sweep_group_id
        self.grid: List[Tuple[str, int]] = [
            (d, mr) for d in self.datasets for mr in self.max_ranges]

    # ------------------------------------------------------------ namespaces
    @property
    def ns_meta(self) -> str:
        return f"{self.group}/meta"

    @property
    def ns_queue(self) -> str:
        return f"{self.group}/queue"

    @property
    def ns_leases(self) -> str:
        return f"{self.group}/leases"

    @property
    def ns_results(self) -> str:
        return f"{self.group}/results"

    @property
    def ns_poison(self) -> str:
        return f"{self.group}/poison"

    @property
    def ns_fidelity(self) -> str:
        return f"{self.group}/fidelity"

    @property
    def ns_done(self) -> str:
        return f"{self.group}/done"

    # --------------------------------------------------------------- publish
    def publish_queue(self, *, wait_s: float = PUBLISH_TAKEOVER_S) -> bool:
        """Ensure the work queue exists; returns True if THIS worker
        published it. One exclusive-create election picks the publisher;
        losers block until ``meta/ready`` appears. A waiter that outlives
        ``wait_s`` assumes the publisher died mid-publish and publishes
        itself — idempotent, because no worker claims before ``ready``
        exists, so no queue item can be moving concurrently."""
        if self.store.has_marker(self.ns_meta, "ready"):
            return False
        won = self.store.put_marker(self.ns_meta, "claimant",
                                    {"worker": self.worker_id},
                                    exclusive=True)
        if not won:
            t0 = time.monotonic()
            while not self.store.has_marker(self.ns_meta, "ready"):
                if time.monotonic() - t0 > wait_s:
                    break                      # dead publisher: take over
                time.sleep(min(self.poll_s, 0.05))
            else:
                return False
            if self.store.has_marker(self.ns_meta, "ready"):
                return False
        resolved = set(self.store.list_markers(self.ns_results)) \
            | set(self.store.list_markers(self.ns_poison)) \
            | set(self.store.list_markers(self.ns_queue)) \
            | set(self.store.list_markers(self.ns_leases))
        for d, mr in self.grid:
            name = scenario_marker(d, mr)
            if name not in resolved:
                self.store.put_marker(self.ns_queue, name, {
                    "dataset": d, "max_range": mr, "attempts": 0})
        self.store.put_marker(self.ns_meta, "ready",
                              {"worker": self.worker_id})
        return True

    # ----------------------------------------------------------------- claim
    def claim_batch(self, n: Optional[int] = None) -> Dict[str, Lease]:
        """Lease up to ``n`` queued scenarios (atomic queue→lease moves;
        losing a race on an item just skips it). Returns marker name →
        :class:`Lease` for every item won."""
        n = self.lease_batch if n is None else n
        claimed: Dict[str, Lease] = {}
        for name in self.store.list_markers(self.ns_queue):
            if len(claimed) >= n:
                break
            if not self.store.claim_marker(self.ns_queue, name,
                                           self.ns_leases, name):
                continue
            payload = self.store.get_marker(self.ns_leases, name)
            lease = Lease(worker=self.worker_id,
                          dataset=payload["dataset"],
                          max_range=int(payload["max_range"]),
                          ttl_s=self.ttl_s,
                          deadline=self._clock() + self.ttl_s,
                          attempts=int(payload.get("attempts", 0)) + 1)
            self.store.put_marker(self.ns_leases, name, lease.to_json())
            claimed[name] = lease
        return claimed

    # ------------------------------------------------------------------ reap
    def _quarantine(self, name: str, payload: Dict,
                    error: Optional[str]) -> None:
        # move (atomic: one of N racing reapers wins) then normalize
        if self.store.claim_marker(self.ns_leases, name,
                                   self.ns_poison, name):
            self.store.put_marker(self.ns_poison, name, {
                "dataset": payload["dataset"],
                "max_range": int(payload["max_range"]),
                "attempts": int(payload.get("attempts", 0)),
                "last_worker": payload.get("worker"),
                "error": error,
            })

    def _requeue(self, name: str, payload: Dict,
                 error: Optional[str]) -> None:
        if self.store.claim_marker(self.ns_leases, name,
                                   self.ns_queue, name):
            self.store.put_marker(self.ns_queue, name, {
                "dataset": payload["dataset"],
                "max_range": int(payload["max_range"]),
                "attempts": int(payload.get("attempts", 0)),
                "error": error,
            })

    def _strike(self, name: str, payload: Dict,
                error: Optional[str]) -> None:
        """Requeue-or-poison one failed lease: the scenario's lease
        count replays into a fresh breaker, so ``breaker_threshold``
        worker deaths on the same scenario open it → quarantine."""
        breaker = CircuitBreaker(
            failure_threshold=self.breaker_threshold)
        for _ in range(max(1, int(payload.get("attempts", 0)))):
            breaker.record_failure()
        if breaker.allow():
            self._requeue(name, payload, error)
        else:
            self._quarantine(name, payload, error)

    def reap(self) -> List[str]:
        """One reaper pass: requeue (or quarantine) every expired lease.
        Every worker calls this each loop iteration — there is no
        dedicated reaper process to die. Returns the reaped names."""
        reaped = []
        now = self._clock()
        for name in self.store.list_markers(self.ns_leases):
            if self.store.has_marker(self.ns_results, name):
                # worker published then died before releasing: the
                # result stands, the lease is garbage
                self.store.remove_marker(self.ns_leases, name)
                continue
            try:
                payload = self.store.get_marker(self.ns_leases, name)
            except FileNotFoundError:
                continue                      # released under our feet
            if "deadline" in payload:
                expired = now > float(payload["deadline"])
            else:
                # claim window: the queue→lease move landed but the
                # claimant died before writing its Lease; judge by file
                # age against the service TTL
                mtime = self.store.marker_mtime(self.ns_leases, name)
                expired = mtime is not None and now > mtime + self.ttl_s
                payload = dict(payload)
                payload["attempts"] = int(payload.get("attempts", 0)) + 1
            if not expired:
                continue
            self._strike(name, payload, "lease expired (worker dead?)")
            reaped.append(name)
        return reaped

    # ------------------------------------------------------------- lifecycle
    def outstanding(self) -> List[Tuple[str, int]]:
        """Grid scenarios not yet resolved (no result and no poison)."""
        done = set(self.store.list_markers(self.ns_results)) \
            | set(self.store.list_markers(self.ns_poison))
        return [sc for sc in self.grid
                if scenario_marker(*sc) not in done]

    def run_batch(self, leases: Dict[str, Lease], originals, consumer, *,
                  t_pre: Optional[Dict[str, float]] = None,
                  queue_size: int = 64, backend: str = "auto",
                  n_devices: int = 1, **replay_kw) -> List[str]:
        """Execute one claimed batch through the ordinary plan → engine →
        replay path and publish each result the moment its report exists.
        Returns the marker names actually published (a lease the reaper
        reclaimed mid-run is skipped — the rival owns the scenario now).
        Exceptions propagate AFTER the unpublished remainder is struck
        back to the queue/poison, so a deterministic per-scenario crash
        converges to quarantine instead of looping forever."""
        t_pre = t_pre or {}
        row_counts = {d: len(originals[d]) for d in self.datasets}
        pairs = [(l.dataset, l.max_range) for l in leases.values()]
        by_sc = {(l.dataset, l.max_range): (name, l)
                 for name, l in leases.items()}
        plan = plan_sweep(self.store, self.datasets, self.max_ranges,
                          row_counts, scale=self.scale, seed=self.seed,
                          pairs=pairs, n_devices=n_devices,
                          host_index=0, n_hosts=1)
        published: List[str] = []
        with Heartbeat(self.store, self.ns_leases, leases) as hb:
            try:
                result = engine.execute_sweep(plan, originals, self.store,
                                              backend=backend,
                                              device=self.device)
                counts = result.count_rows()
                self._publish_originals(result)

                def _publish(report: SimulationReport) -> None:
                    sc = (report.dataset, report.max_range)
                    name, lease = by_sc[sc]
                    if name in hb.lost:
                        return        # reaped: a rival owns this lease
                    self.store.put_marker(self.ns_results, name, {
                        "report": report.to_json(),
                        "worker": self.worker_id,
                        "attempts": lease.attempts,
                    })
                    row = {"counts": np.asarray(counts[sc]),
                           "worker": self.worker_id}
                    self.store.put_marker(
                        self.ns_fidelity, f"sim__{name}",
                        {"counts": pack_counts(row["counts"]),
                         "worker": self.worker_id})
                    self._local_rows[f"sim__{name}"] = row
                    published.append(name)

                engine.run_sweep(result, consumer, queue_size=queue_size,
                                 t_pre=t_pre, fidelity=False,
                                 on_report=_publish, **replay_kw)
            except BaseException as exc:
                hb.stop()
                for name, lease in leases.items():
                    if name in published or name in hb.lost:
                        continue
                    self._strike(name, lease.to_json(), repr(exc))
                raise
        # release leases we still own (lost ones belong to their reaper)
        for name in leases:
            if name not in hb.lost:
                self.store.remove_marker(self.ns_leases, name)
        return published

    def _publish_originals(self, result) -> None:
        """Exact per-dataset original count rows — the merge's left-hand
        block — of the datasets the batch reports (published before any of
        their sim rows, so the merge never meets a sim row without its
        original). Idempotent: originals are deterministic per (scale,
        seed), so a rewrite by another worker carries identical content."""
        for d in result.datasets:
            name = f"orig__{d}"
            if not self.store.has_marker(self.ns_fidelity, name):
                row = {"counts": np.asarray(result.om[d].counts),
                       "worker": self.worker_id}
                self.store.put_marker(self.ns_fidelity, name, {
                    "counts": pack_counts(row["counts"]),
                    "worker": self.worker_id})
                self._local_rows[name] = row

    def work(self, originals, consumer, *,
             t_pre: Optional[Dict[str, float]] = None,
             queue_size: int = 64, backend: str = "auto",
             n_devices: int = 1, deadline_s: Optional[float] = None,
             **replay_kw) -> None:
        """The worker loop: publish (or wait for) the queue, then
        reap → claim → execute until every grid scenario has a result
        or a poison marker. Raises TimeoutError past ``deadline_s``."""
        self.publish_queue()
        t0 = time.monotonic()
        while True:
            self.reap()
            leases = self.claim_batch()
            if leases:
                try:
                    self.run_batch(leases, originals, consumer,
                                   t_pre=t_pre, queue_size=queue_size,
                                   backend=backend, n_devices=n_devices,
                                   **replay_kw)
                except Exception:
                    # the batch was struck back to queue/poison; keep
                    # serving — quarantine bounds the retry budget
                    pass
                continue
            if not self.outstanding():
                return
            if deadline_s is not None and \
                    time.monotonic() - t0 > deadline_s:
                raise TimeoutError(
                    f"sweep service: {len(self.outstanding())} "
                    f"scenario(s) unresolved after {deadline_s}s")
            time.sleep(self.poll_s)

    # --------------------------------------------------------------- collect
    def collect(self) -> Tuple[List[SimulationReport], List[str]]:
        """The full grid's reports in grid order (poisoned scenarios get
        a quarantine stub), plus the marker names THIS worker produced
        (the controller persists only its own reports to its local
        metrics repository)."""
        reports, mine = [], []
        for d, mr in self.grid:
            name = scenario_marker(d, mr)
            if self.store.has_marker(self.ns_results, name):
                payload = self.store.get_marker(self.ns_results, name)
                r = SimulationReport.from_json(payload["report"])
                if payload.get("worker") == self.worker_id:
                    mine.append(name)
            elif self.store.has_marker(self.ns_poison, name):
                p = self.store.get_marker(self.ns_poison, name)
                vol0 = Volatility(average=0.0, variance=0.0,
                                  std_variance=0.0, time_range=int(mr))
                r = SimulationReport(
                    dataset=d, max_range=int(mr), original_rows=0,
                    simulated_rows=0, compression=0.0,
                    original_volatility=vol0, simulated_volatility=vol0,
                    trend_corr=0.0, preprocess_s=0.0, nsa_s=0.0,
                    produce_s=0.0,
                    consumer_metrics={"poisoned": True},
                    status="poisoned", failure=p.get("error"),
                    attempts=int(p.get("attempts", 0)))
            else:
                raise RuntimeError(
                    f"scenario {(d, mr)} neither resolved nor poisoned "
                    "— collect() called before work() finished?")
            reports.append(r)
        return reports, mine

    def finalize(self, *, n_participants: int = 1,
                 fidelity_window_s: int = 60
                 ) -> Tuple[List[SimulationReport], List[FidelityReport],
                            List[str]]:
        """Collect + cross-host merge + cooperative cleanup. Every
        participant collects BEFORE announcing itself done, and only an
        observer that sees all ``n_participants`` done markers clears the
        namespace — so nobody can clear state a peer still reads.
        (``clear_markers`` is atomic and concurrent-clear-safe, so two
        last observers racing is fine.)"""
        reports, mine = self.collect()
        fidelity = merge_fidelity(self.store, self.group, self.datasets,
                                  self.max_ranges,
                                  window_s=fidelity_window_s,
                                  local=self._local_rows)
        self.store.put_marker(self.ns_done, self.worker_id,
                              {"t": time.time()})
        if len(self.store.list_markers(self.ns_done)) >= n_participants:
            self.store.clear_markers(self.group)
        return reports, fidelity, mine


def merge_fidelity(store, group: str, datasets: Sequence[str],
                   max_ranges: Sequence[int], *, window_s: int = 60,
                   local: Optional[Dict[str, Dict]] = None
                   ) -> List[FidelityReport]:
    """Recompute the FULL S×S fidelity matrix per ``max_range`` from the
    published exact count rows (``fidelity/orig__*`` + ``fidelity/sim__*``
    markers), regardless of which worker/host produced each row.

    Count rows are integers carried exactly (packed little-endian int64
    via :func:`pack_counts`, or a plain int list), and the reduction is
    the numpy :func:`~repro_torch.streamsim.metrics.
    trend_correlation_matrix` a single-host numpy run uses — so the
    merged matrix EQUALS the single-host artifact (torch-produced rows
    agree within the documented 1e-3 backend tolerance). Rows whose
    scenario is poisoned or still unpublished are omitted; ``labels``
    record the subset and ``provenance`` the producing worker per row.

    ``local`` is an optional overlay of rows the CALLER itself published
    (marker name -> ``{"counts", "worker"}`` with in-memory counts):
    those skip the store read-back entirely, so a worker that computed a
    row never pays to re-parse its own marker. Rows are deterministic,
    so an overlay row always matches what any rival published."""
    ns = f"{group}/fidelity"
    local = local or {}

    def _payload(name: str) -> Optional[Dict]:
        if name in local:
            return local[name]
        if store.has_marker(ns, name):
            return store.get_marker(ns, name)
        return None

    orig: Dict[str, Dict] = {}
    for d in datasets:
        p = _payload(f"orig__{d}")
        if p is not None:
            orig[d] = p
    out: List[FidelityReport] = []
    for mr in max_ranges:
        rows = []
        for d in datasets:
            p = _payload(f"sim__{scenario_marker(d, mr)}")
            if d in orig and p is not None:
                rows.append((d, p))
        if not rows:
            continue
        labels = [f"{d}/original" for d, _ in rows] + \
            [f"{d}/sim{mr}" for d, _ in rows]
        provenance = [orig[d].get("worker") for d, _ in rows] + \
            [p.get("worker") for _, p in rows]
        counts = [unpack_counts(orig[d]["counts"]) for d, _ in rows] + \
            [unpack_counts(p["counts"]) for _, p in rows]
        matrix = trend_correlation_matrix(counts, window_s=window_s,
                                          backend="numpy")
        out.append(FidelityReport(int(mr), int(window_s), labels,
                                  np.asarray(matrix).tolist(),
                                  provenance=provenance))
    return out


def run_service_sweep(store, datasets: Sequence[str],
                      max_ranges: Sequence[int], originals, consumer, *,
                      scale: float = 1.0, seed: int = 0,
                      t_pre: Optional[Dict[str, float]] = None,
                      queue_size: int = 64, backend: str = "auto",
                      fidelity_window_s: int = 60, n_devices: int = 1,
                      lease_ttl_s: float = 60.0, poll_s: float = 0.2,
                      lease_batch: int = 1, breaker_threshold: int = 3,
                      worker_id: Optional[str] = None,
                      n_participants: int = 1,
                      deadline_s: Optional[float] = None,
                      device=None,
                      **replay_kw
                      ) -> Tuple[List[SimulationReport],
                                 List[FidelityReport], List[str]]:
    """One participant's complete service run: publish/join the queue,
    serve until the grid is resolved, then finalize (collect + merged
    fidelity + cooperative cleanup). Returns ``(reports, fidelity,
    own_marker_names)`` — reports cover the FULL grid on every
    participant; ``own_marker_names`` identifies the subset this worker
    computed. ``device`` is :class:`SweepService`'s."""
    svc = SweepService(store, datasets, max_ranges, scale=scale,
                       seed=seed, lease_ttl_s=lease_ttl_s, poll_s=poll_s,
                       lease_batch=lease_batch,
                       breaker_threshold=breaker_threshold,
                       worker_id=worker_id, device=device)
    svc.work(originals, consumer, t_pre=t_pre, queue_size=queue_size,
             backend=backend, n_devices=n_devices, deadline_s=deadline_s,
             **replay_kw)
    return svc.finalize(n_participants=n_participants,
                        fidelity_window_s=fidelity_window_s)
