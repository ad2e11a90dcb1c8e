"""Public wrappers over the port's kernels.

Counterpart of ``repro/kernels/ops.py`` (the NSA, compaction, metrics and
pairwise-trend parts). Each op builds the host-side tables and layouts,
moves them to the requested device and calls a kernel wrapper, which
launches the CUDA kernel for CUDA tensors and runs the kernel's plain
PyTorch version for CPU tensors. ``device=None`` means CUDA; asking for
CUDA where ``torch.cuda.is_available()`` is False raises, it never falls
back to the CPU.

Inputs outside the kernels' exactness domain raise :class:`PallasDomainError`
(or its :class:`KeepRuleOverflow` subclass) *before* dispatch, on exactly
the inputs the reference refuses, so the NSA and engine layers fall back
to the numpy host path the same way the reference does.

Tiles are fixed (``TILE = 1024`` records, ``BUCKET_BLOCK = 512`` buckets);
``autotune`` other than ``None``/``"off"`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.compact import compact
from repro_torch.kernels.metrics_fused import BUCKET_BLOCK, stream_metrics \
    as _stream_metrics_kernel
from repro_torch.kernels.stream_sample import MAX_RANGE_LIMIT
from repro_torch.kernels.stream_sample import stream_sample \
    as _stream_sample_kernel

#: record quantum the record axis is padded to (the reference's TILE)
TILE = 1024


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


def check_autotune(autotune: Optional[str]) -> None:
    if autotune not in (None, "off"):
        raise NotImplementedError(
            f"autotune={autotune!r}: the port runs fixed tiles "
            "(TILE=1024, BUCKET_BLOCK=512); tile tuning is not ported yet")


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
def _nsa_tables(t64: np.ndarray, max_range: int, multiple: float,
                width: Optional[int] = None):
    """Exact per-bucket tables + kernel inputs for one sorted stream.

    Returns (rebased f32 timestamps, starts, counts, ktab,
    (t_min, 1/span, n_buckets)). The tables come from the float64 host
    formula ``(t - t_min) / span * max_range`` that
    :func:`repro_torch.streamsim.nsa.scale_stamps` floors, so the kernel's
    +-1-snapped stamps are bit-identical to the numpy path. ``width``
    (default ``max_range``) pads the table axis for range-padded sweeps:
    tail buckets get ``starts = n``, ``counts = 0`` and a zero keep budget.
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
    if span <= 0.0:
        # degenerate stream (all timestamps equal): everything is bucket 0
        starts = np.full(width, n, np.int32)
        starts[0] = 0
        inv_span = 0.0
    else:
        v = (t64 - t_min) / span * max_range
        starts = np.full(width, n, np.int32)
        starts[:max_range] = np.searchsorted(v, np.arange(max_range))
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
    t32 = (t64 - t_min).astype(np.float32)
    return t32, starts, counts, ktab, (0.0, inv_span, float(max_range))


def stream_sample_batched(ts, max_range, multiples, *, device=None):
    """Batched fused NSA inner loop: S streams, one kernel launch.

    ts        : sequence of S sorted 1-D float64 timestamp arrays (ragged
                lengths allowed).
    max_range : int, or a length-S sequence of per-row time ranges (the
                range-padded sweep form: tables pad to the maximum).
    multiples : per-stream multiple (a scalar broadcasts).
    device    : where the launch runs (``None`` means CUDA).

    Returns ``(ss int32 (S, N), keep bool (S, N), lengths int64 (S,))`` with
    ``N`` the longest row rounded up to ``TILE``; ``keep`` is False past
    each row's length. Per row bit-identical to the reference's
    ``stream_sample_batched``.
    """
    dev = resolve_device(device)
    inputs = stream_sample_inputs(ts, max_range, multiples)
    ss, keep = _stream_sample_kernel(
        *(torch.from_numpy(x).to(dev) for x in inputs))
    return ss, keep, inputs[-1].astype(np.int64)


def stream_sample_inputs(ts, max_range, multiples):
    """The host-side inputs of kernel B1 for :func:`stream_sample_batched`
    (same arguments): ``(t f32 (S, N), starts, counts, ktab int32 (S, W),
    scalars f32 (S, 3), lengths int32 (S,))`` as numpy arrays, each row
    padded with its last timestamp to the ``TILE``-aligned width ``N``."""
    ts = [np.asarray(t, np.float64) for t in ts]
    S = len(ts)
    if S == 0:
        raise ValueError("need at least one stream")
    lengths = np.array([len(t) for t in ts])
    if np.any(lengths == 0):
        raise ValueError("batched path requires non-empty streams")
    ranges = np.broadcast_to(np.asarray(max_range, np.int64), (S,))
    if np.any(ranges <= 0):
        raise ValueError("max_range entries must be positive")
    width = int(ranges.max())
    mults = np.broadcast_to(np.asarray(multiples, np.float64), (S,))
    N = int(-(-lengths.max() // TILE) * TILE)
    t_b = np.empty((S, N), np.float32)
    starts_b = np.empty((S, width), np.int32)
    counts_b = np.empty((S, width), np.int32)
    k_b = np.empty((S, width), np.int32)
    scal_b = np.empty((S, 3), np.float32)
    for s, t64 in enumerate(ts):
        t32, starts, counts, ktab, scalars = _nsa_tables(
            t64, int(ranges[s]), float(mults[s]), width)
        t_b[s, :len(t32)] = t32
        t_b[s, len(t32):] = t32[-1]          # pad into the last bucket
        starts_b[s], counts_b[s], k_b[s] = starts, counts, ktab
        scal_b[s] = scalars
    return t_b, starts_b, counts_b, k_b, scal_b, lengths.astype(np.int32)


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
    return compact(mask.contiguous())


def compact_mask_batched(mask) -> Tuple[torch.Tensor, np.ndarray]:
    """:func:`compact_mask_batched_device` with the totals on the host as
    int64 (the reference's ``compact_mask_batched`` contract)."""
    idx, totals = compact_mask_batched_device(mask)
    return idx, totals.cpu().numpy().astype(np.int64).reshape(-1)


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


def _padded_buckets(max_range: int) -> int:
    return int(-(-max_range // BUCKET_BLOCK) * BUCKET_BLOCK)


def stream_metrics_batched(ss_seq, max_range: int, *, device=None):
    """Batched fused metrics over host stamp arrays: one kernel call.

    ss_seq: sequence of S 1-D integer scale-stamp arrays (ragged lengths
    allowed; empty streams give all-zero rows), every stamp in
    ``[0, max_range)``. Returns ``(hist int32 (S, max_range), moments f32
    (S, 2), lengths int64 (S,))``, the first two on ``device``.
    """
    dev = resolve_device(device)
    ssb, lengths, buckets = stream_metrics_inputs(ss_seq, max_range)
    hist, mom = _stream_metrics_kernel(
        torch.from_numpy(ssb).to(dev), torch.from_numpy(lengths).to(dev),
        buckets)
    return hist[:, :max_range], mom, lengths.astype(np.int64)


def stream_metrics_inputs(ss_seq, max_range: int):
    """The host-side inputs of kernel B3 for :func:`stream_metrics_batched`
    (same arguments): ``(ss int32 (S, N), lengths int32 (S,), buckets)``
    with rows padded by the id ``buckets`` and ``buckets`` the
    ``BUCKET_BLOCK``-aligned histogram width."""
    ss_list = [np.asarray(s, np.int32).reshape(-1) for s in ss_seq]
    if not ss_list:
        raise ValueError("need at least one stream")
    if max_range <= 0:
        raise ValueError("max_range must be positive")
    S = len(ss_list)
    lengths = np.array([len(s) for s in ss_list], np.int64)
    _check_metrics_domain(int(lengths.max(initial=0)))
    buckets = _padded_buckets(max_range)
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
    hist, mom = _stream_metrics_kernel(
        ss.to(torch.int32).contiguous(), lengths,
        _padded_buckets(max_range))
    return hist[:, :max_range], mom


def stream_metrics(ss, max_range: int, *, device=None):
    """Fused per-second histogram + count moments of one stamp array:
    ``(hist int32 (max_range,), moments f32 (2,) = [Σq, Σq²])``."""
    hist, mom, _ = stream_metrics_batched([ss], max_range, device=device)
    return hist[0], mom[0]


# ------------------------------------------------- pairwise trend correlation
# int32 prefix-sum accumulation: exact while a stream's total record count
# stays below 2**31
_TREND_TOTAL_LIMIT = 2 ** 31 - 1


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
    if totals is not None:
        totals = np.asarray(totals, np.int64).reshape(-1)
        if np.any(totals > _TREND_TOTAL_LIMIT):
            raise PallasDomainError(
                "total count exceeds the int32 prefix-sum domain "
                f"(limit {_TREND_TOTAL_LIMIT}); use the numpy trend path")
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
