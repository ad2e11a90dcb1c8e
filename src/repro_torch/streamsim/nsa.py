"""NSA — Normalizing and Sampling Stream Data (paper Algorithm 1).

Semantics
---------
Given a bounded stream ``B`` with timestamps ``t`` spanning ``T`` seconds and
a user time range ``max`` (the paper's symbol; here ``max_range``):

1. **Normalize** (Min-Max, paper formula (1), ``min = 0``)::

       scale_stamp_i = floor( (t_i - t_min) / (t_max - t_min) * max_range )

2. **Sample** (systematic, per scale-stamp bucket): compression multiplies
   the per-second arrival rate by ``multiple = T / max_range``; sampling
   divides it back. Each bucket keeps ``len(bucket) / multiple`` records,
   chosen every-``multiple``-th, so the simulated per-second rate matches
   the *original* per-second rate (paper Tables 1-3).

   The paper's pseudocode computes ``multiple = Len(B)/max``; ``Len(B)``
   must denote the stream's *time length* for Tables 1-3 to hold, so
   ``multiple_mode='time'`` (the default) implements that reading and
   ``multiple_mode='records'`` the pseudocode-literal one.

Implementations
---------------
- :func:`nsa_paper` — faithful per-record Python loop (the paper-written
  algorithm).
- :func:`nsa` — vectorized numpy (same output bit-for-bit).
- :func:`nsa` with ``backend="torch"`` — normalize + keep mask (kernel B1,
  :func:`repro_torch.kernels.ops.stream_sample_batched`) and mask
  compaction (kernel B2, :func:`repro_torch.kernels.ops.
  compact_mask_batched`) on the device; only the O(max_range) per-bucket
  tables and the final column gather touch the host. Bit-identical to the
  numpy path (the kernel snaps its f32 buckets to exact f64 tables).
- :func:`nsa_batched` and :func:`nsa_sweep` — many streams at one range,
  or a (stream × max_range) scenario grid, as ONE launch of each kernel
  and one host gather; :func:`nsa_sweep_device` is their device leg,
  which leaves the kept stamps on the device for the metrics kernel.
- :class:`ChunkedNSA` — the same grid served one time chunk at a time
  (one B1 and one B2 launch per chunk over just the chunk's records),
  for the chunked pipeline; :func:`materialize_sweep_chunk` is its host
  gather.

Backend selection rules
-----------------------
``backend`` is ``"numpy" | "torch" | "auto"``; ``"auto"`` means
``"torch"``. The torch backend runs on ``device`` (``None`` means CUDA):
the CUDA kernels on a CUDA device, their plain PyTorch versions on
``device="cpu"``. Asking for CUDA without a usable CUDA runtime raises;
nothing falls back to the CPU. Every backend produces bit-identical output.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.streamsim.preprocess import Stream

BACKENDS = ("auto", "numpy", "torch")


def _resolve_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return "torch" if backend == "auto" else backend


def scale_stamps(t: np.ndarray, max_range: int) -> np.ndarray:
    """Min-Max normalize timestamps into integer buckets [0, max_range).

    Paper formula (1) with min=0, floored to the containing simulated second.
    """
    t = np.asarray(t, dtype=np.float64)
    if len(t) == 0:
        return np.zeros(0, dtype=np.int64)
    t_min, t_max = float(t[0]), float(t[-1])
    span = t_max - t_min
    if span <= 0.0:
        return np.zeros(len(t), dtype=np.int64)
    ss = np.floor((t - t_min) / span * max_range).astype(np.int64)
    # the record at t_max lands exactly on max_range -> clamp into last bucket
    np.clip(ss, 0, max_range - 1, out=ss)
    return ss


def _multiple(stream_len_records: int, time_range_s: float, max_range: int,
              mode: str) -> float:
    if mode == "time":       # the reading consistent with Tables 1-3
        return max(time_range_s / max_range, 1.0)
    elif mode == "records":  # pseudocode-literal reading, kept for comparison
        return max(stream_len_records / max_range, 1.0)
    raise ValueError(f"multiple_mode must be 'time'|'records', got {mode!r}")


def systematic_keep_mask(ss: np.ndarray, max_range: int, multiple: float,
                         *, keep: str = "systematic") -> np.ndarray:
    """Per-record boolean keep mask implementing the per-bucket sampling.

    ``ss`` must be non-decreasing. Within bucket ``b`` with ``c`` records,
    keep ``k = round(c / multiple)`` records (>=1 if the bucket is
    non-empty):

    - ``keep='systematic'`` — Bresenham-even selection: record with in-bucket
      rank ``r`` survives iff ``(r*k) % c < k``; exactly ``k`` survive.
    - ``keep='first'``      — keep ranks ``< k`` (the paper pseudocode's
      ``if i > rs then remove`` reading).
    """
    n = len(ss)
    if n == 0:
        return np.zeros(0, dtype=bool)
    counts = np.bincount(ss, minlength=max_range).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(n, dtype=np.int64) - starts[ss]
    c = counts[ss]
    k = np.rint(c / multiple).astype(np.int64)
    k = np.clip(k, 1, None)  # non-empty buckets keep at least one record
    if keep == "systematic":
        return (rank * k) % np.maximum(c, 1) < k
    elif keep == "first":
        return rank < k
    raise ValueError(f"keep must be 'systematic'|'first', got {keep!r}")


def nsa(stream: Stream, max_range: int, *, keep: str = "systematic",
        multiple_mode: str = "time", backend: str = "numpy",
        device=None, autotune: Optional[str] = None) -> Stream:
    """Vectorized NSA (Algorithm 1): normalize + sample -> simulated stream.

    Parameters
    ----------
    stream : Stream
        Preprocessed (chronological) original stream.
    max_range : int
        Target simulated time range in seconds; must be positive.
    keep : {"systematic", "first"}
        In-bucket sampling rule. The kernel implements only
        ``"systematic"``; ``"first"`` always takes the numpy path.
    multiple_mode : {"time", "records"}
        How the compression multiple is derived.
    backend : {"numpy", "torch", "auto"}
        ``"torch"`` (and ``"auto"``) runs normalize → keep mask →
        compaction on ``device``.
    device : torch device, optional
        Where the torch backend runs; ``None`` means CUDA.
    autotune : {None, "off", "cached", "force"}, optional
        Tile-tuning mode for the device dispatches
        (:mod:`repro_torch.kernels.tuning`); ``None``/``"off"`` keep the
        shipped tiles. An unknown mode raises ``ValueError`` on the torch
        backend.

    Returns
    -------
    Stream
        The simulated stream; **bit-identical across backends**.

    Notes
    -----
    Streams outside the kernels' exactness domain (int32 keep-rule
    overflow, ``max_range`` past the ±1-snap guarantee) raise
    :class:`repro_torch.kernels.ops.PallasDomainError` inside the ops
    layer; this function catches it and falls back to the numpy path.
    """
    from repro_torch.kernels import ops

    if max_range <= 0:
        raise ValueError("max_range must be positive")
    m = _multiple(len(stream), stream.time_range, max_range, multiple_mode)
    if (_resolve_backend(backend) == "torch" and keep == "systematic"
            and len(stream) > 0):
        try:
            handles = nsa_sweep_device({stream.name: stream},
                                       [(stream.name, max_range)],
                                       multiple_mode=multiple_mode,
                                       device=device, autotune=autotune)
        except ops.PallasDomainError:
            pass  # stream outside the kernel's exactness domain
        else:
            ss_kept, idx, totals, _ = handles
            return materialize_sweep({stream.name: stream},
                                     [(stream.name, max_range)],
                                     ss_kept, idx, totals)[
                (stream.name, max_range)]
    ss = scale_stamps(stream.t, max_range)
    mask = systematic_keep_mask(ss, max_range, m, keep=keep)
    return Stream(
        name=stream.name,
        t=stream.t[mask],
        payload={k: v[mask] for k, v in stream.payload.items()},
        scale_stamp=ss[mask],
    )


def nsa_batched(streams: Dict[str, Stream], max_range: int, *,
                multiple_mode: str = "time", backend: str = "auto",
                device=None, autotune: Optional[str] = None
                ) -> Dict[str, Stream]:
    """NSA over many named streams at one ``max_range``.

    On the torch backend every stream is one row of ONE B1 launch and ONE
    B2 launch on ``device`` (``None`` means CUDA); the reference runs one
    batched B1 dispatch and then compacts each stream on its own. Returns
    ``{name: Stream}``, **bit-identical** to ``{name: nsa(s, max_range,
    backend="numpy")}``. A batch with an empty stream, or with a stream
    outside the kernels' domain (:class:`~repro_torch.kernels.ops.
    PallasDomainError`), runs the numpy path wholesale, as the
    reference's does. Raises ``ValueError`` if ``max_range <= 0``.
    """
    if max_range <= 0:
        raise ValueError("max_range must be positive")
    sims = nsa_sweep(streams, [max_range], multiple_mode=multiple_mode,
                     backend=backend, device=device, autotune=autotune)
    return {name: sims[(name, int(max_range))] for name in streams}


def nsa_sweep(streams: Dict[str, Stream], max_ranges: Sequence[int], *,
              pairs: Optional[Sequence[Tuple[str, int]]] = None,
              multiple_mode: str = "time", backend: str = "auto",
              device=None, autotune: Optional[str] = None
              ) -> Dict[Tuple[str, int], Stream]:
    """NSA over a (stream × max_range) scenario grid: on the torch backend
    ONE B1 launch and ONE B2 launch on ``device`` for every scenario
    (:func:`nsa_sweep_device`), then one host gather
    (:func:`materialize_sweep`).

    ``pairs`` (``(name, max_range)`` entries) replaces the cross product
    ``streams × max_ranges`` when given. Returns ``{(name, max_range):
    Stream}``, **bit-identical** to ``nsa(streams[name], max_range,
    backend="numpy")`` for every scenario. A grid with an empty stream, or
    with a scenario outside the kernels' domain, runs the numpy path
    wholesale. Raises ``ValueError`` if a ``max_range`` is not positive.
    """
    from repro_torch.kernels import ops

    if pairs is None:
        pairs = [(name, mr) for name in streams for mr in max_ranges]
    pairs = [(name, int(mr)) for name, mr in pairs]
    if any(mr <= 0 for _, mr in pairs):
        raise ValueError("max_range must be positive")

    def _host() -> Dict[Tuple[str, int], Stream]:
        return {(name, mr): nsa(streams[name], mr,
                                multiple_mode=multiple_mode,
                                backend="numpy")
                for name, mr in pairs}

    if _resolve_backend(backend) != "torch" or not pairs or \
            any(len(streams[name]) == 0 for name, _ in pairs):
        return _host()
    try:
        ss_kept, idx, totals, _ = nsa_sweep_device(
            streams, pairs, multiple_mode=multiple_mode, device=device,
            autotune=autotune)
    except ops.PallasDomainError:
        return _host()      # a scenario outside the kernels' domain
    return materialize_sweep(streams, pairs, ss_kept, idx, totals)


def nsa_sweep_device(streams: Dict[str, Stream],
                     pairs: Sequence[Tuple[str, int]], *,
                     multiple_mode: str = "time", device=None,
                     autotune: Optional[str] = None):
    """The device leg of a range-padded sweep — NO host gather.

    Runs ONE ``stream_sample`` launch (B1) plus ONE batched compaction (B2)
    for the scenario rows ``pairs`` (each a ``(stream name, max_range)``;
    the streams must be non-empty) on ``device`` (``None`` means CUDA),
    then gathers each row's kept stamps on the device. ``autotune`` is the
    tile-tuning mode of both launches (:mod:`repro_torch.kernels.tuning`;
    an unknown mode raises ``ValueError``).

    Returns
    -------
    (ss_kept, idx, totals, lengths)
        ``ss_kept`` int32 ``(R, K)`` on the device — row ``r``'s first
        ``totals[r]`` entries are its kept scale stamps; ``K`` is the
        largest total rounded up to ``TILE`` (the reference returns the
        full source width; only the first ``totals[r]`` entries are ever
        read). ``idx`` int32 ``(R, N)`` on the device — kept-record
        indices, sentinel ``N`` past each row's total. ``totals`` int64
        ``(R,)`` host; ``lengths`` int64 ``(R,)`` host source lengths.

    Raises
    ------
    PallasDomainError
        When any scenario falls outside the kernels' exactness domain —
        callers fall back to the numpy path wholesale.
    """
    import torch

    from repro_torch.kernels import ops, tuning

    ts = [streams[name].t for name, _ in pairs]
    mults = [_multiple(len(streams[name]), streams[name].time_range, mr,
                       multiple_mode) for name, mr in pairs]
    with tuning.tuner_context(autotune, device=device):
        ss_b, keep_b, lengths = ops.stream_sample_batched(
            ts, [mr for _, mr in pairs], mults, device=device)
        with tracing.span("nsa.kernels"):
            idx_b, totals = ops.compact_mask_batched(keep_b)
            N = idx_b.shape[1]
            width = min(max(int(-(-int(totals.max(initial=1)) // ops.TILE)
                                * ops.TILE), ops.TILE), N)
            ss_kept = torch.gather(
                ss_b, 1,
                torch.clamp(idx_b[:, :width], 0, max(N - 1, 0)).long())
    return ss_kept, idx_b, totals, lengths


def materialize_sweep(streams: Dict[str, Stream],
                      pairs: Sequence[Tuple[str, int]],
                      ss_kept, idx_b, totals) -> Dict[Tuple[str, int],
                                                      Stream]:
    """The single host pass of the device sweep: gather payload columns.

    Moves the kept stamp / index columns (only the first ``max(totals)``
    of each row) to the host ONCE and fancy-indexes each scenario's
    timestamp and payload columns (which may be float64 or strings).
    """
    with tracing.span("materialize.gather",
                      records=int(np.sum(totals))):
        w = int(np.max(totals, initial=0))
        ss_host = ss_kept[:, :w].cpu().numpy().astype(np.int64)
        idx_host = idx_b[:, :w].cpu().numpy()
        out = {}
        for r, (name, mr) in enumerate(pairs):
            src, total = streams[name], int(totals[r])
            idx = idx_host[r, :total]
            out[(name, mr)] = Stream(
                name=src.name,
                t=src.t[idx],
                payload={k: v[idx] for k, v in src.payload.items()},
                scale_stamp=ss_host[r, :total],
            )
        return out


@dataclasses.dataclass
class ChunkHandles:
    """The outputs of ONE chunk of a chunked sweep (see :class:`ChunkedNSA`).

    ``ss_kept``/``idx``/``totals`` are tensors on the sweep's device until
    :meth:`to_host` stages them; ``idx`` entries are LOCAL to the chunk's
    record slice (add ``rec_off[r]`` for indices into the source stream).
    Both matrices hold the first ``K`` columns of each row, ``K`` the
    ``TILE``-rounded largest kept count the host tables predict (``kept``):
    the reference keeps the whole slice width, of which only the first
    ``totals[r]`` entries are ever read.
    """
    ss_kept: object          # (R, K) int32 — kept scale stamps
    idx: object              # (R, K) int32 — local kept indices
    totals: object           # (R,) int32   — kept counts
    rec_off: np.ndarray      # (R,) int64 host — record slice offsets
    kept: np.ndarray         # (R,) int64 host — kept counts the tables give
    lo: int                  # chunk bucket range [lo, hi)
    hi: int
    #: CUDA event recorded after :meth:`to_host` queued its copies
    ready: object = None

    def to_host(self) -> "ChunkHandles":
        """Queue copies of what the host leg reads into pinned host memory
        and record an event after them, without waiting: the host then
        waits for THIS chunk's work only (:meth:`wait`), not for work queued
        later on the same stream. CPU handles are returned as they are."""
        if self.totals.device.type != "cuda":
            return self
        import torch

        def pinned(x):
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return out.copy_(x, non_blocking=True)

        host = dataclasses.replace(self, ss_kept=pinned(self.ss_kept),
                                   idx=pinned(self.idx),
                                   totals=pinned(self.totals))
        host.ready = torch.cuda.Event()
        host.ready.record(torch.cuda.current_stream(self.totals.device))
        return host

    def wait(self) -> float:
        """Block until the staged copies have landed; returns the seconds
        spent waiting (0.0 for CPU handles)."""
        if self.ready is None:
            return 0.0
        t0 = time.perf_counter()
        self.ready.synchronize()
        return time.perf_counter() - t0


class ChunkedNSA:
    """Per-chunk device NSA over a scenario grid — the unbounded-stream form.

    Uploads each row's full-width bucket tables and rebased f32 timestamps
    to the device ONCE, then serves the timeline chunk by chunk:
    ``chunk(lo, hi)`` runs kernel B1 on just the record slice whose scale
    stamps land in ``[lo, hi)`` and compacts its keep mask with B2, with no
    host synchronisation (every size comes from the host tables).

    Bit-exactness with the monolithic sweep: a chunk's records are a
    CONTIGUOUS slice ``[starts[lo], starts[hi])`` of the sorted stream
    (records never split a bucket), and B1 is launched with the full-width
    tables rebased by the slice offset, so each record sees the same f32
    timestamp, the same snapped bucket and the same in-bucket rank as in
    the monolithic launch. Concatenating the chunks reproduces
    :func:`nsa_sweep_device` exactly.

    Parameters
    ----------
    streams : dict of str -> Stream
        Source streams (non-empty).
    pairs : sequence of (name, eff_range)
        Scenario rows; ``eff_range`` is the row's EFFECTIVE simulated range
        (``ScenarioSpec.span_s``, ``max_range`` per simulated day).
    multiple_mode : {"time", "records"}
        As in :func:`nsa`.
    device : torch device, optional
        Where the tables live and the kernels run (``None`` means CUDA).
    autotune : {None, "off", "cached", "force"}, optional
        Tile-tuning mode of each chunk's B1 and B2 launches, whose config
        is chosen per chunk (an unknown mode raises ``ValueError`` at the
        first chunk).

    Raises
    ------
    PallasDomainError
        At construction, when any row falls outside the kernels' exactness
        domain, so callers fall back to the host path before any chunk
        state exists.
    """

    def __init__(self, streams: Dict[str, Stream],
                 pairs: Sequence[Tuple[str, int]], *,
                 multiple_mode: str = "time", device=None,
                 autotune: Optional[str] = None):
        import torch

        from repro_torch.kernels import ops

        self.autotune = autotune
        self.pairs = [(name, int(rng)) for name, rng in pairs]
        if not self.pairs:
            raise ValueError("need at least one scenario row")
        if any(rng <= 0 for _, rng in self.pairs):
            raise ValueError("ranges must be positive")
        ts = [np.asarray(streams[name].t, np.float64)
              for name, _ in self.pairs]
        if any(len(t) == 0 for t in ts):
            raise ValueError("chunked path requires non-empty streams")
        self.device = ops.resolve_device(device)
        mults = [_multiple(len(streams[name]), streams[name].time_range,
                           rng, multiple_mode)
                 for name, rng in self.pairs]
        t_b, starts_b, counts_b, k_b, scal_b, lengths = \
            ops.stream_sample_inputs(ts, [rng for _, rng in self.pairs],
                                     mults)
        self.lengths = lengths.astype(np.int64)
        self.width = starts_b.shape[1]
        self.N = t_b.shape[1]
        ops._check_metrics_domain(self.N)  # any chunk's kept width <= N
        # host copies for slicing: column lo gives the first record of
        # bucket lo (tail buckets carry starts = n, so rows whose range ends
        # before the sweep's maximum give empty slices), and each bucket
        # keeps exactly min(k, count) records (Bresenham keeps k of c >= k)
        self._starts_np = starts_b.astype(np.int64)
        kept = np.minimum(k_b, counts_b).astype(np.int64)
        self._kept_cum = np.concatenate(
            [np.zeros((len(self.pairs), 1), np.int64),
             np.cumsum(kept, axis=1)], axis=1)
        tables = (t_b, starts_b, counts_b, k_b, scal_b)
        with tracing.span("nsa.upload",
                          bytes=sum(x.nbytes for x in tables)):
            self._t, self._starts, self._counts, self._ktab, self._scal = (
                torch.from_numpy(x).to(self.device) for x in tables)

    def n_chunks(self, chunk_s: int) -> int:
        return -(-self.width // int(chunk_s))

    def _upload(self, x):
        """A small per-chunk host array on the device, without a sync."""
        import torch
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def sample_inputs(self, lo: int, hi: int):
        """B1's six arguments for absolute buckets ``[lo, hi)``: the
        record slice ``[starts[lo], starts[hi])`` of each row, padded to
        whole tiles with the row's last timestamp, the full-width tables
        rebased by the slice offset, and the slice lengths; plus the
        offsets (host int64, one per row). Queues copies, no sync."""
        import torch

        from repro_torch.kernels import ops

        lo, hi = int(lo), int(hi)
        if not 0 <= lo < hi <= self.width:
            raise ValueError(f"bad chunk range [{lo}, {hi}) for width "
                             f"{self.width}")
        a = self._starts_np[:, lo]
        b = self.lengths if hi >= self.width else self._starts_np[:, hi]
        m = b - a
        Nc = _tiles(m.max(), ops.TILE)
        t_slice = torch.empty((len(self.pairs), Nc), dtype=torch.float32,
                              device=self.device)
        for r, off in enumerate(a.tolist()):
            take = min(Nc, self.N - off)
            t_slice[r, :take] = self._t[r, off:off + take]
            if take < Nc:                   # pad with the last timestamp
                t_slice[r, take:] = self._t[r, self.N - 1:]
        # rebase the bucket tables by the slice offset: local rank equals
        # global rank, so the keep bits match the monolithic launch
        starts_reb = self._starts - self._upload(a.astype(np.int32))[:, None]
        return (t_slice, starts_reb, self._counts, self._ktab, self._scal,
                self._upload(m.astype(np.int32))), a

    def chunk(self, lo: int, hi: int) -> ChunkHandles:
        """Launch B1 and B2 for absolute buckets ``[lo, hi)``; returns the
        handles without waiting for the device."""
        import torch

        from repro_torch.kernels import ops, tuning
        from repro_torch.kernels.stream_sample import stream_sample

        b1_in, a = self.sample_inputs(lo, hi)
        lo, hi = int(lo), int(hi)
        Nc = b1_in[0].shape[1]
        kept = self._kept_cum[:, hi] - self._kept_cum[:, lo]
        K = min(_tiles(kept.max(), ops.TILE), Nc)
        end = self.lengths if hi >= self.width else self._starts_np[:, hi]
        with tuning.tuner_context(self.autotune, device=self.device):
            cfg = tuning.config_for(
                "stream_sample", s=len(self.pairs),
                n=max(int((end - a).max()), 1), r=self.width,
                device=self.device)
            ss, keep = stream_sample(*b1_in, config=cfg)
            idx, totals = ops.compact_mask_batched_device(keep)
        idx = idx[:, :K].contiguous()
        ss_kept = torch.gather(ss, 1, torch.clamp(idx, max=Nc - 1).long())
        return ChunkHandles(ss_kept=ss_kept, idx=idx, totals=totals,
                            rec_off=a, kept=kept, lo=lo, hi=hi)


def _tiles(x, tile: int) -> int:
    """``x`` rounded up to whole tiles, at least one."""
    return max(int(-(-int(x) // tile) * tile), tile)


def materialize_sweep_chunk(streams: Dict[str, Stream],
                            pairs: Sequence[Tuple[str, int]],
                            handles: ChunkHandles,
                            totals: np.ndarray) -> List[Stream]:
    """Host gather for ONE chunk: one Stream per scenario row, in ``pairs``
    order. ``totals`` is the host copy of ``handles.totals``; handles staged
    by :meth:`ChunkHandles.to_host` (and waited for) are read without
    touching the device."""
    w = int(np.max(totals, initial=0))
    ss_host = handles.ss_kept[:, :w].cpu().numpy().astype(np.int64)
    idx_host = handles.idx[:, :w].cpu().numpy()
    out = []
    for r, (name, _) in enumerate(pairs):
        src, total = streams[name], int(totals[r])
        gi = idx_host[r, :total].astype(np.int64) + int(handles.rec_off[r])
        out.append(Stream(
            name=src.name,
            t=src.t[gi],
            payload={k: v[gi] for k, v in src.payload.items()},
            scale_stamp=ss_host[r, :total],
        ))
    return out


def nsa_paper(stream: Stream, max_range: int, *, keep: str = "systematic",
              multiple_mode: str = "time") -> Stream:
    """Paper-faithful per-record NSA: literal loops mirroring Algorithm 1.

    Bit-identical output to :func:`nsa`; executable documentation of the
    paper's pseudocode.
    """
    if max_range <= 0:
        raise ValueError("max_range must be positive")
    n = len(stream)
    t = stream.t
    if n == 0:
        return Stream(stream.name, t[:0],
                      {k: v[:0] for k, v in stream.payload.items()},
                      np.zeros(0, dtype=np.int64))
    t_min, t_max = float(t[0]), float(t[-1])
    span = t_max - t_min
    # --- "Normalizing original stream data." (per-record loop) ---
    ss = np.empty(n, dtype=np.int64)
    for i in range(n):  # For s_i in B do
        if span <= 0.0:
            ss[i] = 0
        else:
            v = (t[i] - t_min) / span * max_range  # formula (1), min=0
            ss[i] = min(int(v), max_range - 1)
    # --- "Sampling normalized stream data." (per-bucket loop) ---
    m = _multiple(n, span, max_range, multiple_mode)
    keep_idx = []
    lo = 0
    for b in range(max_range):  # For i <- 0 to max do
        hi = lo
        while hi < n and ss[hi] == b:
            hi += 1
        c = hi - lo  # block = B[scale_stamp == i]
        if c > 0:
            k = max(int(round(c / m)), 1)  # rs = Len(block)/multiple
            for r in range(c):  # For s_i in block do
                if keep == "systematic":
                    if (r * k) % c < k:
                        keep_idx.append(lo + r)
                elif keep == "first":
                    if r < k:  # paper: "If i > rs then remove"
                        keep_idx.append(lo + r)
                else:
                    raise ValueError(f"bad keep {keep!r}")
        lo = hi
    idx = np.asarray(keep_idx, dtype=np.int64)
    return Stream(
        name=stream.name,
        t=t[idx],
        payload={k: v[idx] for k, v in stream.payload.items()},
        scale_stamp=ss[idx],
    )


def compression_factor(stream: Stream, max_range: int) -> float:
    """The task speedup the simulation buys: original range / simulated range.

    The paper's headline: one day into <=1 h  =>  >= 24x (§6).
    """
    return stream.time_range / float(max_range)


def expected_kept(stream: Stream, max_range: int) -> int:
    """Rough expected record count after NSA (for capacity planning)."""
    m = _multiple(len(stream), stream.time_range, max_range, "time")
    return int(math.ceil(len(stream) / m))
