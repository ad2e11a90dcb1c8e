"""Sweep planning — the plan layer of the scenario-sweep architecture.

``Controller.run_many`` used to be a monolith that hand-interleaved store
lookups, NSA dispatch, per-scenario host gathers, metrics, fidelity, and
replay for ONE process's scenarios. This module makes the sweep an explicit
*plan* that the engine (:mod:`repro_torch.streamsim.engine`) then executes:

1. **Enumerate** — the (dataset × max_range) grid at a given
   (scale, seed), in the report order ``for dataset: for max_range``
   (:class:`ScenarioSpec` per cell).
2. **Resolve** — scenarios whose simulated stream already sits in the
   :class:`~repro_torch.streamsim.store.StreamStore` become cache *hits*
   (no NSA work); the rest are *missing* and must be simulated.
3. **Partition** — missing scenarios are sharded twice:

   - across **hosts** (the ``torch.distributed`` world size when a process
     group is initialized; 1 in a single-process run): hosts take strided
     slices of the size-sorted scenario list, so every host gets a similar
     record-count mix;
   - across this host's **devices**: a contiguous linear partition of the
     size-sorted list into at most ``n_devices`` :class:`Shard` s,
     minimizing the maximum *range-padded* shard cost. A shard's kernel
     cost is ``len(shard) × padded_rows(shard)`` — every row of a batched
     NSA launch is padded to the shard's longest stream — so grouping
     similar-length scenarios both balances devices AND shrinks total
     padded area versus one monolithic launch padded to the global
     maximum.

The plan is pure data (no device work): cheap to build, easy to test, and
printable. ``Controller.run`` /
``run_many`` are thin layers over ``plan_sweep`` + the engine.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

from repro_torch.distributed import process_topology

#: record-tile width of the batched NSA kernels — the quantum a shard's
#: row length is padded to (kept in sync with ``repro_torch.kernels.ops``
#: TILE)
ROW_TILE = 1024

#: one day of wall-clock seconds — the native timeline of every dataset
#: (kept in sync with ``repro_torch.streamsim.datasets.DAY``)
DAY_S = 86_400


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One (dataset × max_range) cell of the sweep grid."""

    dataset: str
    max_range: int
    scale: float
    seed: int
    rows: int      #: source-stream record count (the shard-cost input)
    cached: bool   #: simulated stream already in the store (no NSA work)
    #: time axis: 0 keeps the monolithic single-dispatch path.
    #: ``chunk_s`` slices the scale-stamp timeline into fixed chunks;
    #: ``duration_s`` stretches the scenario past one day (0 = the
    #: dataset's native range, i.e. ``max_range``).
    chunk_s: int = 0
    duration_s: int = 0

    @property
    def store_key(self) -> str:
        # chunk_s deliberately does NOT enter the key: chunked and
        # monolithic runs produce bit-equal simulated streams, so they
        # share the cache. A non-default duration is a different stream.
        base = f"{self.dataset}__sim{self.max_range}"
        if self.duration_s:
            base += f"__d{self.duration_s}"
        return base

    @property
    def scenario(self) -> Tuple[str, int]:
        """The (dataset, max_range) report key."""
        return (self.dataset, self.max_range)

    @property
    def n_days(self) -> int:
        """Days of original data the scenario covers (1 when
        ``duration_s`` is 0 — the native one-day stream)."""
        if self.duration_s <= 0:
            return 1
        return -(-self.duration_s // DAY_S)

    @property
    def span_s(self) -> int:
        """Seconds of simulated (scale-stamp) timeline this scenario
        covers: each original day compresses into ``max_range`` simulated
        seconds, so multi-day runs keep the per-day compression ratio and
        diurnal cycles stay aligned across days."""
        return int(self.max_range) * self.n_days

    @property
    def n_chunks(self) -> int:
        """Number of time chunks (1 when ``chunk_s`` is 0/monolithic)."""
        if self.chunk_s <= 0:
            return 1
        return -(-self.span_s // self.chunk_s)


@dataclasses.dataclass(frozen=True)
class Shard:
    """One device's slice of the store-missing scenarios.

    ``device_index`` is a *local* device slot (a CUDA device index); the
    engine places the shard's whole NSA→metrics chain there and runs it as
    ONE dispatch per kernel stage.
    """

    device_index: int
    specs: Tuple[ScenarioSpec, ...]

    @property
    def padded_rows(self) -> int:
        """Row length every spec pads to inside this shard's launch."""
        if not self.specs:
            return 0
        longest = max(s.rows for s in self.specs)
        return -(-max(longest, 1) // ROW_TILE) * ROW_TILE

    @property
    def cost(self) -> int:
        """Padded kernel area = rows of the batched launch × padded width."""
        return len(self.specs) * self.padded_rows

    @property
    def max_range(self) -> int:
        """The range the shard's bucket tables pad to (its own maximum —
        NOT the sweep-wide maximum, which is the monolith's padding)."""
        return max((s.max_range for s in self.specs), default=0)

    @property
    def span_s(self) -> int:
        """Simulated-timeline width the shard's chunk grid covers — the
        per-spec :attr:`ScenarioSpec.span_s` maximum (equals
        :attr:`max_range` for single-day sweeps)."""
        return max((s.span_s for s in self.specs), default=0)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """A fully resolved sweep: grid + cache hits + per-device shards."""

    datasets: Tuple[str, ...]
    max_ranges: Tuple[int, ...]
    scale: float
    seed: int
    scenarios: Tuple[ScenarioSpec, ...]  #: full grid, report order
    cached: Tuple[ScenarioSpec, ...]     #: store-cache hits (no NSA)
    missing: Tuple[ScenarioSpec, ...]    #: all store-missing scenarios
    shards: Tuple[Shard, ...]            #: THIS host's device shards
    host_index: int
    n_hosts: int
    n_devices: int
    chunk_s: int = 0      #: time-chunk size in seconds (0 = monolithic)
    duration_s: int = 0   #: timeline length in seconds (0 = native range)

    @property
    def local_missing(self) -> Tuple[ScenarioSpec, ...]:
        """The store-missing scenarios this host's shards cover."""
        return tuple(s for sh in self.shards for s in sh.specs)

    @property
    def n_chunks(self) -> int:
        """Chunk rounds the engine runs — the max over scenarios (chunked
        runs keep the whole sweep on one aligned chunk grid; scenarios
        with a shorter timeline simply finish early)."""
        return max((s.n_chunks for s in self.scenarios), default=1)

    @property
    def sweep_id(self) -> str:
        """Stable identity of the sweep *configuration* (grid + scale +
        seed + host slot) — the checkpoint namespace key. Deliberately
        independent of cache-hit state: a restarted run whose first
        attempt already materialized some scenarios must still find its
        own markers. The time axis enters the hash only when non-default,
        so every pre-existing sweep keeps its id."""
        import hashlib
        ident = repr((tuple(self.datasets), tuple(self.max_ranges),
                      self.scale, self.seed, self.host_index, self.n_hosts))
        if self.chunk_s or self.duration_s:
            ident += repr((self.chunk_s, self.duration_s))
        return hashlib.sha256(ident.encode()).hexdigest()[:16]

    @property
    def sweep_group_id(self) -> str:
        """Host-independent sweep identity — :attr:`sweep_id` minus the
        host slot. Every host of a distributed run hashes the SAME value,
        which is what makes it the *shared* marker namespace: the
        service's work queue / leases / results and the cross-host
        fidelity rows all live under this key, while per-host
        checkpoints keep using :attr:`sweep_id`."""
        import hashlib
        ident = repr((tuple(self.datasets), tuple(self.max_ranges),
                      self.scale, self.seed))
        if self.chunk_s or self.duration_s:
            ident += repr((self.chunk_s, self.duration_s))
        return "g" + hashlib.sha256(ident.encode()).hexdigest()[:16]

    def padded_area(self) -> int:
        """Σ shard cost — the kernel work the plan actually dispatches."""
        return sum(sh.cost for sh in self.shards)

    def monolithic_area(self) -> int:
        """The cost of the unplanned shape: ONE launch over all of
        this host's missing scenarios, padded to their global maximum."""
        specs = self.local_missing
        if not specs:
            return 0
        width = -(-max(s.rows for s in specs) // ROW_TILE) * ROW_TILE
        return len(specs) * width

    def summary(self) -> str:
        cells = len(self.scenarios)
        return (f"SweepPlan: {cells} scenarios ({len(self.cached)} cached, "
                f"{len(self.missing)} missing), host {self.host_index}/"
                f"{self.n_hosts} runs {len(self.shards)} shard(s) on "
                f"{self.n_devices} device(s), padded area "
                f"{self.padded_area()} vs monolithic "
                f"{self.monolithic_area()}")


def _partition_min_max_cost(sorted_specs: List[ScenarioSpec],
                            n_shards: int) -> List[List[ScenarioSpec]]:
    """Contiguous partition of a rows-descending spec list into at most
    ``n_shards`` groups minimizing the maximum padded group cost.

    Classic linear-partition DP (O(S²·R) — sweep grids are small). Because
    the list is sorted by record count descending, a contiguous group's
    padded width is its FIRST element's, so grouping neighbours both
    balances shards and minimizes padding waste.
    """
    S = len(sorted_specs)
    n = min(n_shards, S)
    if n <= 1:
        return [list(sorted_specs)] if S else []

    def width(i: int) -> int:  # padded row length of group starting at i
        return -(-max(sorted_specs[i].rows, 1) // ROW_TILE) * ROW_TILE

    def cost(i: int, j: int) -> int:  # group = specs[i:j]
        return (j - i) * width(i)

    INF = float("inf")
    # best[k][j] = minimal max-cost splitting specs[:j] into k groups
    best = [[INF] * (S + 1) for _ in range(n + 1)]
    cut = [[0] * (S + 1) for _ in range(n + 1)]
    best[0][0] = 0
    for k in range(1, n + 1):
        for j in range(k, S + 1):
            for i in range(k - 1, j):
                c = max(best[k - 1][i], cost(i, j))
                if c < best[k][j]:
                    best[k][j], cut[k][j] = c, i
    groups: List[List[ScenarioSpec]] = []
    j = S
    for k in range(n, 0, -1):
        i = cut[k][j]
        groups.append(list(sorted_specs[i:j]))
        j = i
    groups.reverse()
    return [g for g in groups if g]


def plan_sweep(store, datasets: Sequence[str], max_ranges: Sequence[int],
               row_counts: Mapping[str, int], *,
               scale: float = 1.0, seed: int = 0, force: bool = False,
               pairs: Optional[Sequence[Tuple[str, int]]] = None,
               n_devices: Optional[int] = None,
               host_index: Optional[int] = None,
               n_hosts: Optional[int] = None,
               chunk_s: int = 0, duration_s: int = 0) -> SweepPlan:
    """Build the :class:`SweepPlan` for a (datasets × max_ranges) sweep.

    Parameters
    ----------
    store : StreamStore
        Cache-hit resolution: scenarios with ``store.exists`` become
        :attr:`SweepPlan.cached` (skipped by the engine's NSA stage).
    datasets, max_ranges :
        The sweep grid axes; the grid is their cross product unless
        ``pairs`` overrides it.
    row_counts : mapping of dataset -> int
        Source-stream record counts (drives shard balancing and padding).
    scale, seed :
        Recorded on every spec (the synthetic-dataset cache key).
    force : bool
        Treat every scenario as store-missing (``Controller.simulate``'s
        ``force=True`` semantics).
    pairs : sequence of (dataset, max_range), optional
        Explicit scenario subset instead of the cross product.
    n_devices, host_index, n_hosts :
        Partition geometry. Default to :func:`~repro_torch.distributed.
        process_topology`: this
        process's CUDA device count and its ``torch.distributed`` rank and
        world size (0 and 1 when no process group is initialized) — so
        every process of a distributed run plans the SAME sweep and takes
        only its own strided slice of the missing scenarios. Override
        for tests (e.g. forcing 4 shards on 1 device) or external
        schedulers.
    chunk_s, duration_s :
        Time axis. ``chunk_s > 0`` routes execution through the chunked
        pipeline (``ChunkedSweepRunner``) in ``chunk_s``-second slices;
        ``duration_s > 0`` extends each scenario's timeline past its
        native range. Defaults keep the monolithic behavior, store keys,
        and sweep ids unchanged.

    Returns
    -------
    SweepPlan
        Pure data; the engine executes it. Shards never split a scenario.
    """
    if pairs is None:
        pairs = [(d, int(mr)) for d in datasets for mr in max_ranges]
    else:
        pairs = [(d, int(mr)) for d, mr in pairs]
    if any(mr <= 0 for _, mr in pairs):
        raise ValueError("max_range must be positive")
    chunk_s, duration_s = int(chunk_s), int(duration_s)
    if chunk_s < 0:
        raise ValueError("chunk_s must be >= 0")
    if duration_s < 0:
        raise ValueError("duration_s must be >= 0")
    if n_devices is None or host_index is None or n_hosts is None:
        pidx, pcount, local = process_topology()
        if n_devices is None:
            n_devices = local
        if n_hosts is None:
            n_hosts = pcount
        if host_index is None:
            host_index = pidx
    if not (0 <= host_index < n_hosts):
        raise ValueError(f"host_index {host_index} outside [0, {n_hosts})")
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")

    def _key(d: str, mr: int) -> str:
        return (f"{d}__sim{mr}__d{duration_s}" if duration_s
                else f"{d}__sim{mr}")

    specs = tuple(
        ScenarioSpec(dataset=d, max_range=mr, scale=scale, seed=seed,
                     rows=int(row_counts[d]),
                     cached=bool(not force and store.exists(_key(d, mr))),
                     chunk_s=chunk_s, duration_s=duration_s)
        for d, mr in pairs)
    cached = tuple(s for s in specs if s.cached)
    missing = tuple(s for s in specs if not s.cached)

    # hosts take strided slices of the size-sorted list: similar record
    # mix per host, deterministic across processes (same plan everywhere)
    by_size = sorted(missing, key=lambda s: (-s.rows, s.dataset,
                                             s.max_range))
    mine = by_size[host_index::n_hosts]
    groups = _partition_min_max_cost(mine, n_devices)
    shards = tuple(Shard(device_index=i, specs=tuple(g))
                   for i, g in enumerate(groups))
    return SweepPlan(datasets=tuple(datasets),
                     max_ranges=tuple(int(m) for m in max_ranges),
                     scale=scale, seed=seed, scenarios=specs, cached=cached,
                     missing=missing, shards=shards, host_index=host_index,
                     n_hosts=n_hosts, n_devices=n_devices,
                     chunk_s=chunk_s, duration_s=duration_s)
