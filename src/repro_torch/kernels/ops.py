"""Public wrappers over the port's kernels.

Counterpart of ``repro/kernels/ops.py``: every name of its ``__all__``
(the batched and 1-D NSA, compaction and metrics wrappers, volatility
moments, trend scans, S×S trend correlation, pairwise trends, chunk
carries, flash decode and the device predicates), and
:func:`original_metrics`, which counts original streams where a B1 launch
left their float64 copy (B3's time form; the reference buckets them on the
host).
Each op builds the host-side tables and layouts,
moves them to the requested device and calls a kernel wrapper, which
launches the CUDA kernel for CUDA tensors and runs the kernel's plain
PyTorch version for CPU tensors. ``device=None`` means CUDA; asking for
CUDA where ``torch.cuda.is_available()`` is False raises, it never falls
back to the CPU.

Inputs outside the kernels' exactness domain raise :class:`PallasDomainError`
(or its :class:`KeepRuleOverflow` subclass) *before* dispatch, on exactly
the inputs the reference refuses, so the NSA and engine layers fall back
to the numpy host path the same way the reference does.

Every kernel dispatch asks the ambient tile tuner
(:func:`repro_torch.kernels.tuning.config_for`, with the reference's shape
arguments and the dispatch device) for its config, as the reference's ops
do. The record axis is padded to ``TILE = 1024`` whatever the config; the
histogram width to a multiple of the config's ``bucket_block`` (512 by
default), and B5's time axis to its quantum, which the returned shapes do
not show.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import tuning
from repro_torch.kernels.compact import compact
from repro_torch.kernels.flash_decode import flash_decode \
    as _flash_decode_kernel
from repro_torch.kernels.metrics_fused import BUCKET_BLOCK, stream_metrics \
    as _stream_metrics_kernel
from repro_torch.kernels.metrics_fused import stream_metrics_carry \
    as _stream_metrics_carry_kernel
from repro_torch.kernels.metrics_fused import stream_metrics_time \
    as _stream_metrics_time_kernel
from repro_torch.kernels.stream_sample import MAX_RANGE_LIMIT, SampleArgs
from repro_torch.kernels.stream_sample import stream_sample \
    as _stream_sample_kernel
from repro_torch.kernels.stream_sample import stream_sample_plain
from repro_torch.kernels.trend_scan import pair_stats as _pair_stats_kernel
from repro_torch.kernels.trend_scan import trend_scan as _trend_scan_kernel
from repro_torch.kernels.trend_scan import trend_scan_carry \
    as _trend_scan_carry_kernel

#: record quantum the record axis is padded to (the reference's TILE)
TILE = 1024
#: time quantum the pair-statistics axis is padded to (the reference's
#: default ``bucket_block``, its pair-stats tile)
PAIR_TILE = 512


# ------------------------------------------------------------------ devices
def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a usable CUDA runtime
    raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(x) -> bool:
    """True when ``x`` (a tensor or a device) is on a CUDA device."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return dev.type == "cuda"


def device_kind(device=None) -> str:
    """The card's name for a CUDA device, ``"cpu"`` otherwise."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def on_tpu() -> bool:
    """The reference's TPU predicate: the port never runs on a TPU."""
    return False


def on_gpu() -> bool:
    """True when a CUDA device is usable. A predicate only: no entry point
    reads it to choose the CPU (``device`` does that)."""
    return torch.cuda.is_available()


def on_accelerator() -> bool:
    """The reference's "TPU or GPU": here the same as :func:`on_gpu`."""
    return on_gpu()


def _host(x) -> np.ndarray:
    """``x`` as a host array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on(x, device) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device``
    names one; anything else goes to ``device`` (``None`` means CUDA)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x).to(resolve_device(device))


class PallasDomainError(ValueError):
    """The inputs fall outside the device kernels' exactness domain.

    Raised by the ops wrappers *before* dispatch; ``nsa(backend="torch")``
    and the sweep engine catch it and fall back to the numpy path, so
    callers only see it when invoking the ops layer directly. (The name is
    the reference's, so code written against either package catches the
    same class name.)
    """


class KeepRuleOverflow(PallasDomainError):
    """The systematic keep rule ``(rank * k) % c`` would overflow int32.

    The kernel computes the Bresenham product in int32, which is exact
    only while ``(c - 1) * k < 2**31`` for every bucket; the wrappers refuse
    streams outside that domain rather than diverge from the int64 numpy
    path.
    """


# --------------------------------------------------------------------- NSA
def _bucket_starts(t64: np.ndarray, t_min: float, span: float,
                   max_range: int) -> np.ndarray:
    """``starts[b]``, the first record ``i`` with ``(t64[i] - t_min) / span
    * max_range >= b``, for every bucket ``b < max_range``: bit-equal to
    ``np.searchsorted((t64 - t_min) / span * max_range, arange(max_range))``
    without that pass over the records.

    The formula is monotone in ``t`` under rounding, so the answer is the
    first record of some distinct timestamp. A binary search on ``t64``
    guesses it for every bucket at once; each guess then steps to the run
    of equal timestamps below it while the formula at that run is still
    ``>= b``, and past the run at it while the formula there is ``< b``,
    evaluating the formula in the reference's operation order."""
    n = len(t64)
    b = np.arange(max_range)

    def v(i):
        return (t64[i] - t_min) / span * max_range

    i = np.searchsorted(t64, t_min + span * (b / max_range))
    while True:                 # the run below still reaches bucket b
        down = np.flatnonzero(i > 0)
        down = down[v(i[down] - 1) >= b[down]]
        if not len(down):
            break
        i[down] = np.searchsorted(t64, t64[i[down] - 1], "left")
    while True:                 # the run at i falls short of bucket b
        up = np.flatnonzero(i < n)
        up = up[v(i[up]) < b[up]]
        if not len(up):
            break
        i[up] = np.searchsorted(t64, t64[i[up]], "right")
    return i


def _nsa_tables(t64: np.ndarray, max_range: int, multiple: float,
                width: Optional[int] = None):
    """Exact per-bucket tables + kernel scalars for one sorted stream.

    Returns (starts, counts, ktab, (t_min, 1/span, n_buckets)), ``t_min``
    the float64 origin B1 rebases the stream's timestamps by. The tables
    come from the float64 host formula ``(t - t_min) / span * max_range``
    that :func:`repro_torch.streamsim.nsa.scale_stamps` floors, so the
    kernel's +-1-snapped stamps are bit-identical to the numpy path; they
    take ``max_range`` binary searches (:func:`_bucket_starts`), no pass
    over the records. ``width`` (default ``max_range``) pads the table axis
    for range-padded sweeps: tail buckets get ``starts = n``, ``counts = 0``
    and a zero keep budget.
    """
    if max_range > MAX_RANGE_LIMIT:
        raise PallasDomainError(
            f"max_range {max_range} exceeds {MAX_RANGE_LIMIT}: the +-1 "
            "bucket snap no longer bounds the f32 normalize error; use the "
            "numpy NSA path")
    width = max_range if width is None else width
    if width < max_range:
        raise ValueError(f"table width {width} < max_range {max_range}")
    n = len(t64)
    t_min, t_max = float(t64[0]), float(t64[-1])
    span = t_max - t_min
    starts = np.full(width, n, np.int32)
    if span <= 0.0:
        # degenerate stream (all timestamps equal): everything is bucket 0
        starts[0] = 0
        inv_span = 0.0
    else:
        starts[:max_range] = _bucket_starts(t64, t_min, span, max_range)
        inv_span = 1.0 / span
    counts = np.zeros(width, np.int32)
    counts[:max_range] = np.diff(np.append(starts[:max_range], n))
    ktab = np.zeros(width, np.int32)
    ktab[:max_range] = np.clip(
        np.rint(counts[:max_range] / multiple), 1, None)
    prod = (counts.astype(np.int64) - 1).clip(0) * ktab.astype(np.int64)
    if prod.max(initial=0) >= 2 ** 31:
        raise KeepRuleOverflow(
            f"bucket with count={counts[prod.argmax()]} and "
            f"k={ktab[prod.argmax()]} overflows the int32 keep rule; "
            "use the numpy NSA path for this stream")
    return starts, counts, ktab, (t_min, inv_span, float(max_range))


def stream_sample_batched(ts, max_range, multiples, *, device=None,
                          on_upload=None):
    """Batched fused NSA inner loop: S streams, one kernel launch.

    ts        : sequence of S sorted 1-D float64 timestamp arrays (ragged
                lengths allowed; rows given the same array share its copy
                on the device).
    max_range : int, or a length-S sequence of per-row time ranges (the
                range-padded sweep form: tables pad to the maximum).
    multiples : per-stream multiple (a scalar broadcasts).
    device    : where the launch runs (``None`` means CUDA).
    on_upload : optional; called with the launch's :class:`Sources` (the
                streams' float64 copy on the device) once B1 is queued, to
                queue another kernel on the same records
                (:func:`original_metrics`) while the copy is alive: it is
                freed when this returns, before the caller's next launch
                allocates.

    Returns ``(ss int32 (S, N), keep bool (S, N), lengths int64 (S,))`` with
    ``N`` the longest row rounded up to ``TILE``; ``keep`` is False past
    each row's length. Per row bit-identical to the reference's
    ``stream_sample_batched``. The tuner's ``grid_split`` splits the rows
    into that many launches (per-row outputs unchanged).
    """
    dev = resolve_device(device)
    inputs = stream_sample_inputs(ts, max_range, multiples)
    S = len(inputs[1])
    cfg = tuning.config_for("stream_sample", s=S,
                            n=int(inputs[-1].max()), r=inputs[3].shape[1],
                            device=dev)
    g = max(1, min(int(cfg.grid_split), S))
    bounds = [round(i * S / g) for i in range(g + 1)]
    args = stream_sample_args(inputs, dev)
    with tracing.span("nsa.kernels"):
        parts = [_stream_sample_kernel(*args.rows(a, b), config=cfg)
                 for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    if on_upload is not None:
        on_upload(Sources.of(inputs, args))
    if len(parts) == 1:
        ss, keep = parts[0]
    else:
        ss = torch.cat([p[0] for p in parts])
        keep = torch.cat([p[1] for p in parts])
    return ss, keep, inputs[-1].astype(np.int64)


def stream_sample_inputs(ts, max_range, multiples):
    """The host-side inputs of kernel B1 for :func:`stream_sample_batched`
    (same arguments): ``(sources, src int32 (S,), t_min float64 (S,),
    starts, counts, ktab int32 (S, W), scalars f32 (S, 2), lengths int32
    (S,))``. ``sources`` are the distinct float64 timestamp arrays, one per
    array object in ``ts`` (rows given the same array share it), and
    ``src`` each row's source. The span ``nsa.host_tables`` counts the
    rows, the sources and the launch's ``TILE``-aligned width."""
    with tracing.span("nsa.host_tables") as sp:
        S = len(ts)
        if S == 0:
            raise ValueError("need at least one stream")
        slot, sources = {}, []
        src = np.empty(S, np.int32)
        for s, t in enumerate(ts):
            if id(t) not in slot:
                slot[id(t)] = len(sources)
                sources.append(np.ascontiguousarray(t, np.float64))
            src[s] = slot[id(t)]
        lengths = np.array([len(sources[k]) for k in src], np.int32)
        if np.any(lengths == 0):
            raise ValueError("batched path requires non-empty streams")
        ranges = np.broadcast_to(np.asarray(max_range, np.int64), (S,))
        if np.any(ranges <= 0):
            raise ValueError("max_range entries must be positive")
        width = int(ranges.max())
        mults = np.broadcast_to(np.asarray(multiples, np.float64), (S,))
        sp.count(rows=S, sources=len(sources),
                 width=_tiles(lengths.max(), TILE))
        t_min = np.empty(S, np.float64)
        starts_b = np.empty((S, width), np.int32)
        counts_b = np.empty((S, width), np.int32)
        k_b = np.empty((S, width), np.int32)
        scal_b = np.empty((S, 2), np.float32)
        for s in range(S):
            starts, counts, ktab, (t0, inv_span, nb) = _nsa_tables(
                sources[src[s]], int(ranges[s]), float(mults[s]), width)
            starts_b[s], counts_b[s], k_b[s] = starts, counts, ktab
            t_min[s], scal_b[s] = t0, (inv_span, nb)
        return sources, src, t_min, starts_b, counts_b, k_b, scal_b, lengths


def _tiles(x, tile: int) -> int:
    """``x`` rounded up to whole tiles, at least one."""
    return max(int(-(-int(x) // tile) * tile), tile)


#: each source starts a multiple of this many records into B1's buffer
#: (256 bytes), so a row's 16-byte loads start aligned
_SOURCE_ALIGN = 32


def _source_offsets(sources) -> np.ndarray:
    """Each source's first record in B1's buffer, and the buffer's length
    last (int64, one more than the sources)."""
    offs = np.zeros(len(sources) + 1, np.int64)
    offs[1:] = np.cumsum([-(-len(x) // _SOURCE_ALIGN) * _SOURCE_ALIGN
                          for x in sources])
    return offs


@dataclasses.dataclass(frozen=True)
class Sources:
    """The distinct streams of a B1 launch where they lie on the device.

    ``t`` is B1's float64 buffer (:attr:`SampleArgs.t`), ``arrays`` the
    host arrays copied into it, ``first`` each one's first record in ``t``
    (int64) and ``row_source`` the source of each of B1's rows (int32)."""
    t: torch.Tensor
    arrays: tuple
    first: np.ndarray
    row_source: np.ndarray

    @classmethod
    def of(cls, inputs, args: SampleArgs) -> "Sources":
        """The sources of :func:`stream_sample_inputs`' ``inputs`` in the
        buffer of ``args`` (:func:`stream_sample_args` of them)."""
        return cls(args.t, tuple(inputs[0]),
                   _source_offsets(inputs[0])[:-1], inputs[1])


def stream_sample_args(inputs, device) -> SampleArgs:
    """B1's arguments on ``device`` from :func:`stream_sample_inputs`'
    host arrays: each source copied once into one float64 buffer, each row
    reading from its source's first record, the launch as wide as the
    longest row in ``TILE``s (the span ``nsa.upload``, counting the bytes
    copied)."""
    sources, src, t_min, starts, counts, ktab, scalars, lengths = inputs
    dev = resolve_device(device)
    offs = _source_offsets(sources)
    rows = (offs[:-1][src], t_min, starts, counts, ktab, scalars, lengths)
    with tracing.span("nsa.upload", bytes=sum(
            x.nbytes for x in (*sources, *rows))):
        t = torch.empty(int(offs[-1]), dtype=torch.float64, device=dev)
        for x, o in zip(sources, offs.tolist()):
            t[o:o + len(x)].copy_(torch.from_numpy(x))
        return SampleArgs(t, *(torch.from_numpy(x).to(dev) for x in rows),
                          _tiles(lengths.max(), TILE))


def _sample_one(t, max_range: int, multiple: float, device, plain: bool):
    """One stream through B1 (with the tuner's config) or, with ``plain``,
    its plain version."""
    t64 = np.asarray(_host(t), np.float64).reshape(-1)
    dev = resolve_device(device)
    n = len(t64)
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    args = stream_sample_args(
        stream_sample_inputs([t64], max_range, multiple), dev)
    if plain:
        ss, keep = stream_sample_plain(*args)
    else:
        cfg = tuning.config_for("stream_sample", s=1, n=n, r=max_range,
                                device=dev)
        ss, keep = _stream_sample_kernel(*args, config=cfg)
    return ss[0, :n], keep[0, :n]


def stream_sample(t, max_range: int, multiple: float, *, device=None):
    """The NSA inner loop of one stream (kernel B1 with one row).

    ``t`` is sorted ascending (epoch seconds are rebased in float64 before
    the f32 cast). Returns ``(ss int32 (n,), keep bool (n,))`` on ``device``
    (``None`` means CUDA), bit-identical to the numpy NSA path and to the
    reference's ``stream_sample``. Raises :class:`PallasDomainError` where
    the reference does (``max_range`` past the snap's limit, a keep rule
    past int32)."""
    return _sample_one(t, max_range, multiple, device, plain=False)


def stream_sample_ref(t, max_range: int, multiple: float, *, device=None):
    """:func:`stream_sample` through B1's plain PyTorch version, on any
    device (the reference's oracle with the same signature)."""
    return _sample_one(t, max_range, multiple, device, plain=True)


# -------------------------------------------------------------- compaction
def compact_mask_batched_device(mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kept-record indices for R stacked keep masks, on the mask's device.

    mask : (R, N) boolean/0-1 keep masks (padded tails must be 0).

    Returns ``(idx int32 (R, N), totals int32 (R,))``, both on the mask's
    device: ``idx[r, :totals[r]]`` are row ``r``'s set-entry indices in
    ascending order, the tail is the sentinel ``N``.
    """
    mask = torch.as_tensor(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be (R, N), got shape {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        mask = mask != 0
    R, n = mask.shape
    cfg = tuning.config_for("compact", s=R, n=n, device=mask.device)
    return compact(mask.contiguous(), config=cfg)


def compact_mask_batched(mask) -> Tuple[torch.Tensor, np.ndarray]:
    """:func:`compact_mask_batched_device` with the totals on the host as
    int64 (the reference's ``compact_mask_batched`` contract)."""
    idx, totals = compact_mask_batched_device(mask)
    return idx, totals.cpu().numpy().astype(np.int64).reshape(-1)


def compact_mask(mask, *, device=None) -> Tuple[torch.Tensor, int]:
    """Kept-record indices of one keep mask (kernel B2 with one row).

    ``mask`` is a 1-D boolean/0-1 array or tensor; a tensor stays on its
    device, anything else goes to ``device`` (``None`` means CUDA).
    Returns ``(idx int32 (n,), total)``: ``idx[:total]`` are the set
    indices in ascending order, ``idx[total:]`` are ``n``."""
    m = _on(mask, device).reshape(-1)
    if m.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=m.device), 0
    idx, totals = compact_mask_batched(m[None, :])
    return idx[0], int(totals[0])


# -------------------------------------------------------- metrics engine
# int32 histogram accumulation: exact while every bucket count < 2**31
_HIST_COUNT_LIMIT = 2 ** 31 - 1


def _check_metrics_domain(n_records: int) -> None:
    """A bucket count can at most reach the record count; refuse streams
    whose counts could wrap the int32 accumulator."""
    if n_records > _HIST_COUNT_LIMIT:
        raise PallasDomainError(
            f"{n_records} records could overflow the int32 histogram "
            f"accumulator (limit {_HIST_COUNT_LIMIT}); use the numpy "
            "metrics path")


def _padded_buckets(max_range: int, block: int = BUCKET_BLOCK) -> int:
    return int(-(-max_range // block) * block)


def stream_metrics_batched(ss_seq, max_range: int, *, device=None):
    """Batched fused metrics over host stamp arrays: one kernel call.

    ss_seq: sequence of S 1-D integer scale-stamp arrays (ragged lengths
    allowed; empty streams give all-zero rows), every stamp in
    ``[0, max_range)``. Returns ``(hist int32 (S, max_range), moments f32
    (S, 2), lengths int64 (S,))``, the first two on ``device``.
    """
    dev = resolve_device(device)
    ss_list = [np.asarray(_host(s), np.int32).reshape(-1) for s in ss_seq]
    cfg = tuning.config_for(
        "metrics_fused", s=len(ss_list),
        n=max([len(s) for s in ss_list] + [1]), r=max_range, device=dev)
    ssb, lengths, buckets = stream_metrics_inputs(ss_list, max_range,
                                                  cfg.bucket_block)
    hist, mom = _stream_metrics_kernel(
        torch.from_numpy(ssb).to(dev), torch.from_numpy(lengths).to(dev),
        buckets, config=cfg)
    return hist[:, :max_range], mom, lengths.astype(np.int64)


def stream_metrics_inputs(ss_seq, max_range: int,
                          bucket_block: int = BUCKET_BLOCK):
    """The host-side inputs of kernel B3 for :func:`stream_metrics_batched`
    (same arguments): ``(ss int32 (S, N), lengths int32 (S,), buckets)``
    with rows padded by the id ``buckets`` and ``buckets`` the
    ``bucket_block``-aligned histogram width."""
    ss_list = [np.asarray(_host(s), np.int32).reshape(-1) for s in ss_seq]
    if not ss_list:
        raise ValueError("need at least one stream")
    if max_range <= 0:
        raise ValueError("max_range must be positive")
    S = len(ss_list)
    lengths = np.array([len(s) for s in ss_list], np.int64)
    _check_metrics_domain(int(lengths.max(initial=0)))
    buckets = _padded_buckets(max_range, bucket_block)
    N = max(int(-(-lengths.max(initial=1) // TILE) * TILE), TILE)
    ssb = np.full((S, N), buckets, np.int32)     # padding id >= buckets
    for s, row in enumerate(ss_list):
        if len(row) and (row.min() < 0 or row.max() >= max_range):
            raise ValueError(
                f"stream {s}: scale stamps must lie in [0, {max_range})")
        ssb[s, :len(row)] = row
    return ssb, lengths.astype(np.int32), buckets


def stream_metrics_batched_device(ss, valid_counts, max_range: int):
    """Fused metrics over scale stamps already on the device.

    ss           : (S, N) integer stamps; row ``s``'s entries at columns
                   ``>= valid_counts[s]`` are ignored (any value).
    valid_counts : (S,) per-row count of valid leading entries (host array
                   or tensor).
    max_range    : bucket-axis width; every valid stamp lies in
                   ``[0, max_range)`` (NSA guarantees it; not re-checked).

    Returns ``(hist int32 (S, max_range), moments f32 (S, 2))`` on the
    stamps' device. Raises :class:`PallasDomainError` when ``N`` exceeds
    the int32 histogram domain.
    """
    ss = torch.as_tensor(ss)
    if ss.ndim != 2:
        raise ValueError(f"ss must be (S, N), got shape {tuple(ss.shape)}")
    if max_range <= 0:
        raise ValueError("max_range must be positive")
    S, N = ss.shape
    _check_metrics_domain(N)
    lengths = torch.as_tensor(valid_counts).reshape(S).to(
        device=ss.device, dtype=torch.int32).contiguous()
    cfg = tuning.config_for("metrics_fused", s=S, n=max(N, 1), r=max_range,
                            device=ss.device)
    hist, mom = _stream_metrics_kernel(
        ss.to(torch.int32).contiguous(), lengths,
        _padded_buckets(max_range, cfg.bucket_block), config=cfg)
    return hist[:, :max_range], mom


def time_series_length(t) -> int:
    """The per-second series length of a sorted original stream, as
    :func:`repro_torch.streamsim.metrics._bucket_series` gives it:
    ``floor(t[-1] - t[0]) + 1`` (0 for an empty stream). Raises
    :class:`PallasDomainError` when that is not a finite int32."""
    t = np.asarray(t)
    if len(t) == 0:
        return 0
    last = np.floor(t[-1] - t[0])
    if not np.isfinite(last) or not 0 <= last < _HIST_COUNT_LIMIT:
        raise PallasDomainError(f"a series of {last} + 1 seconds is outside "
                                "the int32 histogram")
    return int(last) + 1


def _pinned(x, dev) -> torch.Tensor:
    """A small host array on ``dev`` without waiting for the device: CUDA
    copies go through pinned memory, queued on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def original_metrics(sources: Sources, which, width: int):
    """Per-second counts and moments of original streams from the copy of
    them a B1 launch left on the device: one launch of B3's time form.

    sources : the :class:`Sources` of the B1 launch
              (:func:`stream_sample_batched`'s ``on_upload``).
    which   : indices of the sources to count (each non-empty, float64,
              sorted).
    width   : the series width the rows are padded to, at least each one's
              :func:`time_series_length`.

    Row ``d`` counts record ``i`` of source ``which[d]`` in bucket
    ``clip(floor(t_i - t_0), 0, tr_d - 1)`` with ``tr_d`` its series
    length: the counts :func:`repro_torch.streamsim.metrics.
    _bucket_series` bins, read in place (nothing record-sized is
    allocated). Returns ``(hist int32 (D, W), moments f32 (D, 2))`` on the
    sources' device, ``W`` the ``width`` rounded up to the tile config's
    ``bucket_block``, queued without waiting for the device. Raises
    :class:`PallasDomainError` where the histogram leaves the int32
    domain.
    """
    arrays = [sources.arrays[k] for k in which]
    if not arrays or any(len(x) == 0 for x in arrays):
        raise ValueError("need at least one non-empty source")
    lengths = np.array([len(x) for x in arrays], np.int64)
    trs = np.array([time_series_length(x) for x in arrays], np.int64)
    if trs.max() > width:
        raise ValueError(f"series of {trs.max()} s wider than {width}")
    _check_metrics_domain(int(lengths.max()))
    dev = sources.t.device
    cfg = tuning.config_for("metrics_fused", s=len(arrays),
                            n=int(lengths.max()), r=width, device=dev)
    buckets = _padded_buckets(width, cfg.bucket_block)
    if len(arrays) * buckets >= 2 ** 31:
        raise PallasDomainError(f"{len(arrays)} x {buckets} buckets "
                                "overflow one launch's histogram")
    return _stream_metrics_time_kernel(
        sources.t, _pinned(sources.first[list(which)], dev),
        _pinned(np.array([x[0] for x in arrays], np.float64), dev),
        _pinned(lengths.astype(np.int32), dev),
        _pinned(trs.astype(np.int32), dev), buckets, int(lengths.max()),
        config=cfg)


def stream_metrics(ss, max_range: int, *, device=None):
    """Fused per-second histogram + count moments of one stamp array:
    ``(hist int32 (max_range,), moments f32 (2,) = [Σq, Σq²])``."""
    hist, mom, _ = stream_metrics_batched([ss], max_range, device=device)
    return hist[0], mom[0]


def bucket_hist(ss, max_range: int, *, device=None) -> torch.Tensor:
    """Per-bucket counts of scale stamps in ``[0, max_range)``: B3's
    int32 histogram ``(max_range,)`` on ``device``, exact up to 2**31 per
    bucket (:class:`PallasDomainError` beyond)."""
    return stream_metrics(ss, max_range, device=device)[0]


def volatility_moments(q, *, device=None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``(Σq, Σq²)`` in float32 over a materialized count series, on
    ``q``'s device for a tensor, else on ``device`` (``None`` means CUDA).
    Plain PyTorch, as the reference's is plain XLA; for series that come
    from scale stamps, :func:`stream_metrics` gives both in B3's pass."""
    qf = _on(q, device).reshape(-1).to(torch.float32)
    return qf.sum(), (qf * qf).sum()


def volatility_stats(q, *, device=None) -> Tuple[torch.Tensor,
                                                 torch.Tensor,
                                                 torch.Tensor]:
    """(average, variance, std) of a count series from its float32
    moments (paper formulas (2)-(4)); 0-d tensors."""
    n = len(q)
    s, s2 = volatility_moments(q, device=device)
    avg = s / n
    var = torch.clamp(s2 / n - avg * avg, min=0.0)
    return avg, var, torch.sqrt(var)


# ------------------------------------------------------- trend & correlation
# int32 prefix-sum accumulation: exact while a stream's total record count
# stays below 2**31
_TREND_TOTAL_LIMIT = 2 ** 31 - 1


def _check_trend_domain(q_list) -> None:
    """Refuse count series outside the int32 scan's exactness domain.

    Both violations raise :class:`PallasDomainError` (not ``ValueError``)
    so the metrics layer falls back to the numpy path for any input the
    device path cannot take."""
    for s, q in enumerate(q_list):
        if len(q) and int(q.min()) < 0:
            raise PallasDomainError(
                f"stream {s}: negative counts are outside the device trend "
                "domain; use the numpy trend path")
        if int(q.sum(dtype=np.int64)) > _TREND_TOTAL_LIMIT:
            raise PallasDomainError(
                f"stream {s}: total count exceeds the int32 prefix-sum "
                f"domain (limit {_TREND_TOTAL_LIMIT}); use the numpy trend "
                "path")


def _check_totals(totals) -> None:
    if totals is not None and np.any(
            np.asarray(totals, np.int64) > _TREND_TOTAL_LIMIT):
        raise PallasDomainError(
            "total count exceeds the int32 prefix-sum domain "
            f"(limit {_TREND_TOTAL_LIMIT}); use the numpy trend path")


def _window_tables(lengths: np.ndarray, window: int):
    """Per-stream effective window + half-width (the sliding-mean clamp
    ``w_eff = clip(min(window, n), 1)``)."""
    w_eff = np.maximum(np.minimum(window, lengths), 1).astype(np.int32)
    half = ((w_eff - 1) // 2).astype(np.int32)
    return w_eff, half


def _trend_from_prefix(psum, lengths, w_eff, half):
    """Windowed sliding mean from inclusive int32 prefix sums: two clamped
    gathers and one f32 divide per entry (all tensors on one device)."""
    S, N = psum.shape
    i = torch.arange(N, dtype=torch.int32, device=psum.device)[None, :]
    n = lengths.to(torch.int32)[:, None]
    w = w_eff.to(torch.int32)[:, None]
    h = half.to(torch.int32)[:, None]
    zero = torch.zeros((), dtype=torch.int32, device=psum.device)
    hi = torch.minimum(torch.maximum(i + h + 1, zero), n)
    lo = torch.minimum(torch.maximum(i + h + 1 - w, zero), n)

    def cex(j):                             # c[j] = sum(q[:j]); c[0] = 0
        g = torch.gather(psum, 1, torch.clamp(j - 1, min=0).long())
        return torch.where(j > 0, g, zero)

    win = (cex(hi) - cex(lo)).to(torch.float32)
    out = win / w.to(torch.float32)
    return torch.where(i < n, out, torch.zeros((), device=psum.device))


def _pad_cols(x, quantum: int):
    """Zero-pad the last axis to a multiple of ``quantum`` (a whole
    ``quantum`` when it is empty), as the reference pads before its
    kernels."""
    pad = (-x.shape[1]) % quantum
    if pad or x.shape[1] == 0:
        x = torch.cat([x, torch.zeros((x.shape[0], pad or quantum),
                                      dtype=x.dtype, device=x.device)], 1)
    return x.contiguous()


def _trends(qmat, lengths: np.ndarray, window: int, n: int):
    """Kernel B4 on a TILE-padded (S, N) int32 count matrix (tuned for a
    time axis of ``n``), then the sliding-mean tail on the same device."""
    dev = qmat.device
    cfg = tuning.config_for("trend_scan", s=qmat.shape[0], n=max(n, 1),
                            device=dev)
    psum = _trend_scan_kernel(qmat, config=cfg)
    w_eff, half = _window_tables(lengths, window)
    return _trend_from_prefix(psum, *(torch.from_numpy(a).to(dev)
                                      for a in (lengths, w_eff, half)))


def trend_scan_batched(qs, window: int, *, device=None):
    """Windowed sliding-mean trends of S count series, one B4 launch.

    qs     : sequence of 1-D integer count series (ragged lengths allowed;
             empty series give all-zero rows).
    window : sliding-mean window; per series it clamps to
             ``max(min(window, n), 1)`` (the host ``sliding_mean``
             semantics).
    device : where the launch runs (``None`` means CUDA).

    Returns ``(trend float32 (S, N) on the device, lengths int64 (S,))``
    with ``N`` the longest series rounded up to ``TILE``; entries past a
    series' length are 0. Window sums are int32-exact, the divide is f32.

    Raises :class:`PallasDomainError` for negative counts or a total past
    2³¹ − 1, and ``ValueError`` for ``window < 1`` or no series.
    """
    if window < 1:
        raise ValueError("window must be >= 1")
    q_list = [np.asarray(q).reshape(-1) for q in qs]
    if not q_list:
        raise ValueError("need at least one count series")
    _check_trend_domain(q_list)
    lengths = np.array([len(q) for q in q_list], np.int64)
    N = max(int(-(-lengths.max(initial=1) // TILE) * TILE), TILE)
    qb = np.zeros((len(q_list), N), np.int32)
    for s, q in enumerate(q_list):
        qb[s, :len(q)] = q
    dev = resolve_device(device)
    return _trends(torch.from_numpy(qb).to(dev), lengths, window,
                   int(lengths.max(initial=1))), lengths


def trend_scan(q, window: int, *, device=None):
    """Windowed sliding-mean trend of one count series: a float32 ``(n,)``
    tensor on ``device``; the guards of :func:`trend_scan_batched`."""
    trend, lengths = trend_scan_batched([q], window, device=device)
    return trend[0, :int(lengths[0])]


def trend_scan_batched_device(qmat, lengths, window: int, totals=None):
    """Device-input form of :func:`trend_scan_batched`.

    qmat    : (S, N) integer count series already on a device, zero past
              each row's true length (the metrics kernel's histograms are
              this shape).
    lengths : true series lengths (host).
    totals  : per-row total counts for the int32 domain guard (O(S) host
              scalars the caller already has); ``None`` skips the guard.

    Returns ``(trend f32 (S, N') on qmat's device, lengths int64 (S,))``
    with ``N'`` the width rounded up to ``TILE``.
    """
    if window < 1:
        raise ValueError("window must be >= 1")
    qmat = torch.as_tensor(qmat)
    if qmat.ndim != 2:
        raise ValueError(f"qmat must be (S, N), got shape {tuple(qmat.shape)}")
    lengths = np.asarray(lengths, np.int64).reshape(-1)
    if len(lengths) != qmat.shape[0]:
        raise ValueError("lengths must align with qmat rows")
    _check_totals(totals)
    q32 = _pad_cols(qmat.to(torch.int32), TILE)
    return _trends(q32, lengths, window, qmat.shape[1]), lengths


def trend_pair_stats(x):
    """All-pairs Pearson sufficient statistics of stacked trends, one B5
    launch on ``x``'s device.

    x : (S, K) float32 trends on a common grid (zero tails contribute
        nothing). Returns ``(sums f32 (S, 1), gram f32 (S, S))``.
    """
    x = torch.as_tensor(x).to(torch.float32)
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError("x must be (S, K) with S >= 1")
    cfg = tuning.config_for("pair_stats", s=x.shape[0], n=max(x.shape[1], 1),
                            device=x.device)
    return _pair_stats_kernel(_pad_cols(x, cfg.bucket_block), config=cfg)


def _resample_uniform(x, lengths, n_points: int):
    """Linear resample of each (ragged) trend row onto ``n_points``: the
    lerp at position ``i·(n−1)/(K−1)``, op for op as the reference's
    ``_resample_uniform`` (``x`` and the int ``lengths`` on one device)."""
    dev = x.device
    n = lengths.to(torch.float32)[:, None]
    i = torch.arange(n_points, dtype=torch.float32, device=dev)[None, :]
    scale = (n - 1.0) / float(max(n_points - 1, 1))
    pos = i * scale
    n_int = lengths.to(torch.int32)[:, None]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    j = torch.floor(pos).to(torch.int32)
    j = torch.minimum(torch.maximum(j, zero), torch.clamp(n_int - 2, min=0))
    frac = pos - j.to(torch.float32)
    x0 = torch.gather(x, 1, j.long())
    x1 = torch.gather(x, 1, torch.minimum(
        j + 1, torch.clamp(n_int - 1, min=0)).long())
    return x0 * (1.0 - frac) + x1 * frac


def _corr_from_gram(gram, live, S: int) -> np.ndarray:
    """Normalize a centered Gram matrix into the S×S Pearson matrix on the
    host, in float64: exact symmetry, clip to [-1, 1], unit diagonal for
    non-zero variance, NaN rows for empty or zero-variance series. Shared
    with the f64 numpy mirror (``metrics._corr_matrix_numpy``). ``live``
    indexes the non-empty series ``gram`` covers."""
    corr = np.full((S, S), np.nan)
    g = np.asarray(gram, np.float64)
    g = (g + g.T) / 2.0                       # exact symmetry
    d = np.sqrt(np.clip(np.diag(g), 0.0, None))
    denom = np.outer(d, d)
    with np.errstate(invalid="ignore", divide="ignore"):
        sub = np.where(denom > 0, g / np.where(denom > 0, denom, 1.0),
                       np.nan)
    np.clip(sub, -1.0, 1.0, out=sub)
    np.fill_diagonal(sub, np.where(d > 0, 1.0, np.nan))
    corr[np.ix_(live, live)] = sub
    return corr


def _corr_from_trends(trend, lengths: np.ndarray,
                      n_points: Optional[int]) -> np.ndarray:
    """Trends -> common-grid resample -> centering -> B5 -> host f64
    normalization (the shared tail of the S×S matrix paths)."""
    S = len(lengths)
    live = np.flatnonzero(lengths > 0)
    if len(live) == 0:
        return np.full((S, S), np.nan)
    K = int(n_points) if n_points is not None else int(lengths[live].min())
    if K < 1:
        raise ValueError("n_points must be >= 1")
    dev = trend.device
    z = _resample_uniform(trend.index_select(0, torch.from_numpy(live).to(dev)),
                          torch.from_numpy(lengths[live]).to(dev), K)
    z = z - z.mean(dim=1, keepdim=True)
    _, gram = trend_pair_stats(z)
    return _corr_from_gram(gram.cpu().numpy(), live, S)


def trend_correlation_batched(qs, window: int,
                              n_points: Optional[int] = None, *,
                              device=None) -> np.ndarray:
    """S×S trend-correlation matrix of host count series: counts -> B4 ->
    trends -> resample -> centering -> B5 on ``device`` (``None`` means
    CUDA), then the O(S²) f64 normalization on the host.

    ``n_points`` (default: the shortest non-empty series' length) is the
    common grid; for S = 2 the default reproduces the pairwise host
    convention. Returns float64 ``(S, S)``: symmetric, clipped to [-1, 1],
    unit diagonal, NaN rows for empty or zero-variance series. Raises
    :class:`PallasDomainError` as :func:`trend_scan_batched` does.
    """
    trend, lengths = trend_scan_batched(qs, window, device=device)
    return _corr_from_trends(trend, lengths, n_points)


def trend_correlation_batched_device(qmat, lengths, window: int,
                                     n_points: Optional[int] = None,
                                     totals=None) -> np.ndarray:
    """:func:`trend_correlation_batched` over count series already on a
    device (the sweep engine's histogram rows), guarded by ``totals`` as in
    :func:`trend_scan_batched_device`."""
    trend, lengths = trend_scan_batched_device(qmat, lengths, window,
                                               totals=totals)
    return _corr_from_trends(trend, lengths, n_points)


# ------------------------------------------------- pairwise trend correlation
def _pairwise_corr(qa, la, wa, ha, ai, qb, lb, wb, hb, kk, k_max: int):
    """P (left, right) pairs -> P Pearson r's in float32 (the reference's
    ``_pairwise_corr_jit``): int32 prefix sums -> sliding-mean trends ->
    both sides resampled onto the pair's own ``min(n_a, n_b)``-point grid ->
    masked centering -> Pearson."""
    dev = qa.device
    ta_u = _trend_from_prefix(torch.cumsum(qa, dim=1, dtype=torch.int32),
                              la, wa, ha)
    tb = _trend_from_prefix(torch.cumsum(qb, dim=1, dtype=torch.int32),
                            lb, wb, hb)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def grid(n, k):
        nf = n.to(torch.float32)[:, None]
        kf = k.to(torch.float32)[:, None]
        i = torch.arange(k_max, dtype=torch.float32, device=dev)[None, :]
        pos = i * (nf - 1.0) / torch.clamp(kf - 1.0, min=1.0)
        nn = n.to(torch.int32)[:, None]
        j = torch.minimum(torch.maximum(pos.to(torch.int32), zero),
                          torch.clamp(nn - 2, min=0))
        frac = pos - j.to(torch.float32)
        j1 = torch.minimum(j + 1, torch.clamp(nn - 1, min=0))
        return j, j1, frac

    i_lane = torch.arange(k_max, dtype=torch.int32, device=dev)[None, :]
    kkc = kk.to(torch.int32)[:, None]
    valid = i_lane < kkc

    ja, ja1, fa = grid(la[ai], kk)
    rows = ai[:, None]
    ra = ta_u[rows, ja.long()] * (1.0 - fa) + ta_u[rows, ja1.long()] * fa
    jb, jb1, fb = grid(lb, kk)
    rb = torch.gather(tb, 1, jb.long()) * (1.0 - fb) + \
        torch.gather(tb, 1, jb1.long()) * fb
    fzero = torch.zeros((), dtype=torch.float32, device=dev)
    ra = torch.where(valid, ra, fzero)
    rb = torch.where(valid, rb, fzero)

    denom_k = torch.clamp(kkc.to(torch.float32), min=1.0)
    ra = torch.where(valid, ra - ra.sum(dim=1, keepdim=True) / denom_k,
                     fzero)
    rb = torch.where(valid, rb - rb.sum(dim=1, keepdim=True) / denom_k,
                     fzero)
    num = (ra * rb).sum(dim=1)
    den = (ra * ra).sum(dim=1) * (rb * rb).sum(dim=1)
    r = num / torch.sqrt(den)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)
    return torch.where((den > 0.0) & (kk > 0), torch.clamp(r, -1.0, 1.0),
                       nan)


def trend_corr_pairwise(qa, lengths_a, qb, lengths_b, window: int,
                        totals=None, a_index=None) -> np.ndarray:
    """Pairwise trend correlations for P (original, simulated) pairs, in
    plain PyTorch on the count rows' device (the reference is plain XLA
    with no Pallas kernel).

    qa : (D, Na) int32 unique left-side count rows (zero-padded tails).
    qb : (P, Nb) int32 right-side count rows, one per pair (same device).
    lengths_a, lengths_b : true series lengths per row (host).
    window : sliding-mean window shared by both sides (>= 1).
    totals : optional per-row total counts for the int32 domain guard
             (raises :class:`PallasDomainError` when exceeded).
    a_index : pair -> left-row map; ``None`` is the identity.

    Returns float64 ``(P,)`` Pearson r per pair, NaN for empty or
    zero-variance pairs, within 1e-3 of the f64 host convention.
    """
    if window < 1:
        raise ValueError("window must be >= 1")
    la = np.asarray(lengths_a, np.int64).reshape(-1)
    lb = np.asarray(lengths_b, np.int64).reshape(-1)
    qa, qb = torch.as_tensor(qa), torch.as_tensor(qb)
    if a_index is None:
        a_index = np.arange(len(la))
    ai = np.asarray(a_index, np.int64).reshape(-1)
    if qa.ndim != 2 or qb.ndim != 2 or len(ai) != qb.shape[0] or \
            len(la) != qa.shape[0] or len(lb) != qb.shape[0]:
        raise ValueError("qa/qb must be 2-D with aligned lengths/index")
    if qa.device != qb.device:
        raise ValueError(f"qa on {qa.device}, qb on {qb.device}")
    if len(ai) and (ai.min() < 0 or ai.max() >= len(la)):
        raise ValueError("a_index out of range")
    _check_totals(totals)
    kk = np.minimum(la[ai], lb)
    k_max = max(int(kk.max(initial=1)), 1)
    wa, ha = _window_tables(la, window)
    wb, hb = _window_tables(lb, window)
    dev = qa.device

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    r = _pairwise_corr(qa.to(torch.int32), up(la), up(wa), up(ha), up(ai),
                       qb.to(torch.int32), up(lb), up(wb), up(hb), up(kk),
                       k_max)
    return r.cpu().numpy().astype(np.float64)


# ------------------------------------------------------------- chunk carry
@dataclasses.dataclass
class ChunkCarry:
    """Device-resident cross-chunk state of the chunked sweep.

    The chunked pipeline splits each scenario's simulated timeline into
    fixed-size scale-stamp chunks (chunk ``k`` owns the absolute bucket
    range ``[k·chunk_s, (k+1)·chunk_s)``); because chunks partition the
    bucket axis, per-chunk outputs compose exactly:

    ``hist``       (S, width) int32 — the running absolute-bucket histogram;
                   each chunk's slice lands at its own columns, so the
                   finalized histogram equals the monolithic kernel's.
    ``mom``        (S, 4) float32 — the Kahan moment state
                   ``[s1, c1, s2, c2]``, folded by kernel B6 chunk by chunk
                   (carrying the compensations keeps the documented ~1e-5).
    ``psum_tail``  (S,) int32 — the inclusive prefix total through the last
                   folded bucket (kernel B7's carry-in).
    ``trend_tail`` (S, w-1) int32 — the last ``w-1`` bucket counts, the
                   history a ``w``-second sliding window still needs.

    All four live on the carry's device; ``window``/``next_lo`` are host
    bookkeeping. Unlike the reference, whose arrays are immutable,
    :func:`stream_metrics_chunk` writes each chunk's counts into ``hist``
    IN PLACE (the returned carry shares that tensor) and replaces the other
    three; a new sweep starts from a new :func:`chunk_carry_init`.
    """

    hist: torch.Tensor
    mom: torch.Tensor
    psum_tail: torch.Tensor
    trend_tail: torch.Tensor
    window: int
    next_lo: int = 0


def chunk_carry_init(n_rows: int, width: int, window: int = 1, *,
                     device=None) -> ChunkCarry:
    """Fresh all-zero carry for ``n_rows`` scenario rows and a
    ``width``-bucket axis on ``device`` (``None`` means CUDA). Each
    scenario row has its own carry lane; a new sweep starts from a new
    carry, never a reused one."""
    if n_rows < 1 or width < 1:
        raise ValueError("need n_rows >= 1 and width >= 1")
    dev = resolve_device(device)
    w = max(int(window), 1)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return ChunkCarry(hist=zeros(n_rows, width),
                      mom=zeros(n_rows, 4, dtype=torch.float32),
                      psum_tail=zeros(n_rows),
                      trend_tail=zeros(n_rows, w - 1), window=w)


def stream_metrics_chunk(carry: ChunkCarry, ss, valid_counts, lo: int,
                         hi: int) -> ChunkCarry:
    """Fold one chunk's kept scale stamps into the carry, on its device:
    one launch of kernel B6.

    carry        : the state after the previous chunk
                   (:func:`chunk_carry_init` for the first).
    ss           : (S, N) integer ABSOLUTE stamps of this chunk's kept
                   records; row ``s``'s entries past ``valid_counts[s]`` may
                   hold anything. Valid stamps lie in ``[lo, hi)`` (NSA
                   guarantees it; not re-checked, which would need a sync).
    valid_counts : (S,) kept-record counts; a tensor on the carry's device
                   keeps the call free of host synchronisation.
    lo, hi       : the chunk's absolute bucket range (ragged last chunk
                   allowed); consecutive calls must tile the axis in order.

    B6 rebases the stamps by ``lo`` itself and reads only each row's kept
    prefix. Its histogram lands at columns ``[lo, hi)`` of ``carry.hist``
    (in place); ``mom`` is B6's updated Kahan state; ``psum_tail`` and
    ``trend_tail`` advance for :func:`trend_scan_chunk`. Returns the new
    :class:`ChunkCarry`.
    """
    ss = torch.as_tensor(ss)
    if ss.ndim != 2:
        raise ValueError(f"ss must be (S, N), got shape {tuple(ss.shape)}")
    lo, hi = int(lo), int(hi)
    cw = hi - lo
    if cw <= 0:
        raise ValueError(f"empty chunk range [{lo}, {hi})")
    if lo != carry.next_lo:
        raise ValueError(
            f"chunk [{lo}, {hi}) out of order: carry expects lo == "
            f"{carry.next_lo} (chunks must tile the bucket axis in order)")
    if hi > carry.hist.shape[1]:
        raise ValueError(f"chunk [{lo}, {hi}) exceeds the carry's "
                         f"{carry.hist.shape[1]}-bucket axis")
    S, N = ss.shape
    _check_metrics_domain(N)
    dev = carry.hist.device
    lengths = torch.as_tensor(valid_counts).reshape(S).to(
        device=dev, dtype=torch.int32).contiguous()
    cfg = tuning.config_for("metrics_fused", s=S, n=max(N, 1), r=cw,
                            device=dev)
    hist_c, mom = _stream_metrics_carry_kernel(
        ss.to(device=dev, dtype=torch.int32).contiguous(), lengths,
        _padded_buckets(cw, cfg.bucket_block), carry.mom, lo, config=cfg)
    chunk_q = hist_c[:, :cw]
    carry.hist[:, lo:hi] = chunk_q
    psum_tail = carry.psum_tail + chunk_q.sum(dim=1, dtype=torch.int32)
    w = carry.window
    trend_tail = carry.trend_tail
    if w > 1:
        trend_tail = torch.cat([trend_tail, chunk_q], dim=1)[
            :, -(w - 1):].contiguous()
    return dataclasses.replace(carry, mom=mom, psum_tail=psum_tail,
                               trend_tail=trend_tail, next_lo=hi)


def chunk_carry_finalize(carry: ChunkCarry) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``(hist int32 (S, width), moments float32 (S, 2))`` — the monolithic
    engine's output shapes from a fully folded carry: counts equal to one
    whole-timeline B3 launch, moments within the documented ~1e-5 (the fold
    sees the same buckets in the same order, cut into other blocks)."""
    return carry.hist, carry.mom[:, ::2].contiguous()


def trend_scan_chunk(q_chunk, window: int, *, tail=None, psum_carry=None,
                     lo: int = 0, is_last: bool = False):
    """Streaming sliding-mean trend: the positions one chunk completes, one
    launch of kernel B7.

    A centered ``w``-window at position ``p`` reaches ``half = (w-1)//2``
    buckets past ``p``, so after folding buckets ``[lo, lo+c)`` the
    positions ``[max(lo-half, 0), lo+c-half)`` have their whole window
    (``is_last=True`` flushes the final ``half`` positions). Window sums are
    int32-exact (B7 seeds its running total from ``psum_carry``), so the
    emitted segments concatenated over all chunks equal the monolithic
    trend bit for bit, provided the whole series is at least ``window``
    long (the monolithic path clamps ``w`` for shorter series, which a
    stream cannot know in advance).

    q_chunk    : (S, c) int32 — this chunk's bucket counts, on a device.
    window     : sliding-mean window ``w`` (>= 1).
    tail       : (S, w-1) int32 — the previous call's ``new_tail``
                 (``None``: zeros, the first chunk).
    psum_carry : (S,) int32 — the previous call's ``new_total``
                 (``None``: zeros).
    lo         : the chunk's first absolute bucket.
    is_last    : flush the final ``half`` positions.

    Returns ``(seg float32 (S, m), start, new_tail, new_total)``: ``seg``
    covers trend positions ``[start, start + m)`` (``m`` may be 0 for a tiny
    first chunk); ``new_tail``/``new_total`` feed the next call.
    """
    w = int(window)
    if w < 1:
        raise ValueError("window must be >= 1")
    q_chunk = torch.as_tensor(q_chunk)
    if q_chunk.ndim != 2:
        raise ValueError(f"q_chunk must be (S, c), got "
                         f"{tuple(q_chunk.shape)}")
    q_chunk = q_chunk.to(torch.int32)
    S, c = q_chunk.shape
    dev = q_chunk.device
    if tail is None:
        tail = torch.zeros((S, w - 1), dtype=torch.int32, device=dev)
    tail = torch.as_tensor(tail).to(device=dev, dtype=torch.int32)
    if tuple(tail.shape) != (S, w - 1):
        raise ValueError(f"tail must be (S, {w - 1}), got "
                         f"{tuple(tail.shape)}")
    if psum_carry is None:
        psum_carry = torch.zeros(S, dtype=torch.int32, device=dev)
    psum_carry = torch.as_tensor(psum_carry).to(
        device=dev, dtype=torch.int32).reshape(S)

    # ext covers global buckets [lo - (w-1), lo + c): every window an
    # emittable position needs. Leading zeros (first chunks) reproduce the
    # monolithic clamp at 0 exactly: zero counts add nothing to a window.
    ext = torch.cat([tail, q_chunk], dim=1).contiguous()    # (S, w-1+c)
    base = (psum_carry - tail.sum(dim=1, dtype=torch.int32)).contiguous()
    cfg = tuning.config_for("trend_scan", s=S, n=max(ext.shape[1], 1),
                            device=dev)
    # inclusive prefix sums
    cinc, _ = _trend_scan_carry_kernel(ext, base, config=cfg)

    half = (w - 1) // 2
    hi_abs = lo + c
    e0 = max(lo - half, 0)
    e1 = hi_abs if is_last else max(hi_abs - half, e0)
    new_tail = ext[:, ext.shape[1] - (w - 1):] if w > 1 else tail
    new_total = psum_carry + q_chunk.sum(dim=1, dtype=torch.int32)
    m = e1 - e0
    if m <= 0:
        return (torch.zeros((S, 0), dtype=torch.float32, device=dev), e0,
                new_tail, new_total)
    p = torch.arange(e0, e1, dtype=torch.int32, device=dev)[None, :]
    # local (ext) indices of the window's exclusive-prefix bounds
    jhi = torch.clamp(p + half + 1, max=hi_abs) - lo + (w - 1)
    jlo = p + half - lo                                   # >= 0 by e0

    def cex(j):                             # exclusive prefix at local j
        jb = j.expand(S, m)
        g = torch.gather(cinc, 1, torch.clamp(jb - 1, min=0).long())
        return torch.where(jb > 0, g, base[:, None])

    win = (cex(jhi) - cex(jlo)).to(torch.float32)
    # divide by a device tensor, as _trend_from_prefix does: CUDA turns a
    # divide by a host scalar into a multiply by its reciprocal, which can
    # round differently from the monolithic trend
    w_dev = torch.full((S, 1), float(w), dtype=torch.float32, device=dev)
    return win / w_dev, e0, new_tail, new_total


# ------------------------------------------------------------ flash decode
def flash_decode(q, k, v, lengths, *, block_s: int = 512):
    """GQA decode attention (kernel B8): q (B, H, D) against the cache
    k, v (B, S, Kh, D), softmax over ``s < min(lengths[b], S)``, f32
    accumulation, output in q's dtype.

    The kernel masks a ragged tail itself, so unlike the reference the
    cache is not padded to a multiple of ``block_s``; the kernel picks its
    split from the shapes and the SM count, so ``block_s`` (the
    reference's knob) does not change the result."""
    return _flash_decode_kernel(q, k, v, lengths, block_s=block_s)


__all__ = [
    "ChunkCarry", "KeepRuleOverflow", "PallasDomainError", "bucket_hist",
    "chunk_carry_finalize", "chunk_carry_init",
    "compact_mask", "compact_mask_batched", "compact_mask_batched_device",
    "device_kind", "flash_decode", "on_accelerator", "on_cuda", "on_gpu",
    "on_tpu", "resolve_device", "stream_metrics", "stream_metrics_chunk",
    "trend_scan_chunk", "stream_metrics_batched",
    "stream_metrics_batched_device", "stream_metrics_inputs",
    "stream_sample", "stream_sample_batched", "stream_sample_inputs",
    "stream_sample_ref", "trend_corr_pairwise", "trend_correlation_batched",
    "trend_correlation_batched_device", "trend_pair_stats", "trend_scan",
    "trend_scan_batched", "trend_scan_batched_device", "volatility_moments",
    "volatility_stats",
]
