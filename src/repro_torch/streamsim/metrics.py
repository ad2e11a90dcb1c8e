"""Volatility & trend metrics (paper §5.2, formulas (2)-(4)).

The paper evaluates simulation quality with three per-second statistics —
Average, Variance, Standard Variance — over the arrival-count series
``q_i`` (records in second ``i``); we implement the standard population
variance/σ, which reproduces the tables' magnitudes.

Backends
--------
Every metric takes the ``backend="numpy|torch|auto"`` knob of
:func:`repro_torch.streamsim.nsa.nsa` (``"auto"`` is ``"torch"``) and a
``device`` (``None`` means CUDA):

- ``"numpy"`` — vectorized host path (one ``bincount`` pass + exact f64
  moments).
- ``"torch"`` — the fused metrics kernel B3
  (:func:`repro_torch.kernels.ops.stream_metrics_batched`): histogram AND
  moments in one call, int32-exact counts.

Counts are **bit-exact** across backends; the kernel's raw ``[Σq, Σq²]``
moments agree with exact f64 within ~1e-5 relative (block partials + Kahan
fold in f32); derived moments (average / variance / σ) keep a 1e-3
relative tolerance (the variance subtraction can amplify the moment error).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.streamsim.nsa import _resolve_backend
from repro_torch.streamsim.preprocess import Stream


@dataclasses.dataclass(frozen=True)
class Volatility:
    average: float
    variance: float
    std_variance: float
    time_range: int

    def as_row(self) -> str:
        return (f"{self.time_range},{self.average:.2f},"
                f"{self.variance:.2f},{self.std_variance:.2f}")


@dataclasses.dataclass(frozen=True)
class StreamMetrics:
    """One stream's reporting bundle from a single metrics pass."""

    counts: np.ndarray          # int64 (time_range,) per-second counts q_i
    volatility: Volatility


# --------------------------------------------------------------- bucketing
def _bucket_series(stream: Stream, time_range: Optional[int],
                   use_scale_stamp: Optional[bool]):
    """Integer bucket per record + the series length (shared by backends).

    For simulated streams the bucket is ``scale_stamp``; for original
    streams it is ``floor(t - t_0)``. Returns ``(buckets int64, time_range)``
    — ``time_range`` 0 means the empty/degenerate series.
    """
    if use_scale_stamp is None:
        use_scale_stamp = stream.scale_stamp is not None
    if use_scale_stamp:
        if stream.scale_stamp is None:
            raise ValueError("stream has no scale_stamp; run NSA first")
        buckets = np.asarray(stream.scale_stamp, np.int64)
        if time_range is None:
            time_range = int(buckets.max()) + 1 if len(buckets) else 0
        elif len(buckets):
            # the series covers max(tr, max stamp + 1) seconds: a too-small
            # tr expands rather than mis-binning
            time_range = max(time_range, int(buckets.max()) + 1)
    else:
        if len(stream.t) == 0:
            return np.zeros(0, np.int64), (time_range or 0)
        buckets = np.floor(stream.t - stream.t[0]).astype(np.int64)
        if time_range is None:
            time_range = int(buckets.max()) + 1
        buckets = np.clip(buckets, 0, time_range - 1)
    return buckets, time_range


def _volatility_from_moments(s: float, s2: float, tr: int) -> Volatility:
    if tr <= 0:
        return Volatility(0.0, 0.0, 0.0, 0)
    avg = s / tr
    var = max(s2 / tr - avg * avg, 0.0)
    return Volatility(float(avg), float(var), float(np.sqrt(var)), tr)


def _numpy_metrics(buckets: np.ndarray, tr: int) -> StreamMetrics:
    q = np.bincount(buckets, minlength=tr)
    s = float(q.sum())
    s2 = float((q.astype(np.float64) ** 2).sum())
    return StreamMetrics(q, _volatility_from_moments(s, s2, tr))


# ------------------------------------------------------------- public API
def per_second_counts(stream: Stream, time_range: Optional[int] = None,
                      *, use_scale_stamp: Optional[bool] = None,
                      backend: str = "numpy", device=None) -> np.ndarray:
    """Arrival counts q_i per (simulated or original) second.

    ``time_range=None`` infers the series length (``max scale_stamp + 1``
    for simulated streams, the spanned seconds for originals); ``backend``
    ``"torch"`` counts through kernel B3 on ``device``. Returns int64
    ``(time_range,)``, **bit-exact across backends**.
    """
    buckets, tr = _bucket_series(stream, time_range, use_scale_stamp)
    if _resolve_backend(backend) == "torch" and tr > 0:
        from repro_torch.kernels import ops
        hist, _ = ops.stream_metrics(buckets, tr, device=device)
        return hist.cpu().numpy().astype(np.int64)
    return np.bincount(buckets, minlength=tr)


def volatility(stream: Stream, time_range: Optional[int] = None,
               *, backend: str = "numpy", device=None) -> Volatility:
    """Average / Variance / StdVariance of q_i (paper formulas (2)-(4)).

    ``"numpy"`` reduces exact f64 moments on the host; ``"torch"`` reads
    the ``[Σq, Σq²]`` pair kernel B3 produced with the histogram (f32 —
    agrees with numpy within 1e-3 relative).
    """
    buckets, tr = _bucket_series(stream, time_range, None)
    if _resolve_backend(backend) == "torch" and tr > 0:
        from repro_torch.kernels import ops
        _, mom = ops.stream_metrics(buckets, tr, device=device)
        mom = mom.cpu().numpy().astype(np.float64)
        return _volatility_from_moments(mom[0], mom[1], tr)
    return _numpy_metrics(buckets, tr).volatility


def metrics_batched(streams: Sequence[Stream],
                    time_ranges: Sequence[Optional[int]],
                    *, use_scale_stamps: Optional[Sequence[Optional[bool]]]
                    = None, backend: str = "auto", device=None,
                    autotune: Optional[str] = None) -> List[StreamMetrics]:
    """Counts + volatility for S streams from ONE batched kernel call.

    Parameters
    ----------
    streams : sequence of Stream
        Ragged lengths, mixed simulated/original, and empty/degenerate
        members are all allowed.
    time_ranges : sequence of int or None
        Per-stream series length (``None`` infers it). Must align with
        ``streams``.
    use_scale_stamps : sequence of bool or None, optional
        Per-stream ``use_scale_stamp`` override.
    backend : {"numpy", "torch", "auto"}
        On ``"torch"`` all S histograms and moment pairs come from one
        kernel B3 call on ``device``, padded to the largest time range.
        Inputs outside the kernel's int32 domain fall back to numpy
        wholesale (:class:`~repro_torch.kernels.ops.PallasDomainError`).
    device : torch device, optional
        ``None`` means CUDA.
    autotune : None or "off"
        Anything else raises ``NotImplementedError``.

    Returns
    -------
    list of StreamMetrics
        ``counts`` bit-exact across backends; ``volatility`` within 1e-3.
    """
    from repro_torch.kernels import ops

    if len(streams) != len(time_ranges):
        raise ValueError("streams and time_ranges must align")
    ops.check_autotune(autotune)
    if use_scale_stamps is None:
        use_scale_stamps = [None] * len(streams)
    series = [_bucket_series(s, tr, uss)
              for s, tr, uss in zip(streams, time_ranges, use_scale_stamps)]
    resolved = _resolve_backend(backend)
    max_tr = max((tr for _, tr in series), default=0)
    if resolved != "torch" or max_tr == 0 or not series:
        return [_numpy_metrics(b, tr) for b, tr in series]
    try:
        hist, mom, _ = ops.stream_metrics_batched(
            [b for b, _ in series], max_tr, device=device)
    except ops.PallasDomainError:
        return [_numpy_metrics(b, tr) for b, tr in series]
    hist = hist.cpu().numpy().astype(np.int64)
    mom = mom.cpu().numpy().astype(np.float64)
    return [StreamMetrics(hist[s, :tr],
                          _volatility_from_moments(mom[s, 0], mom[s, 1], tr))
            for s, (_, tr) in enumerate(series)]


# ------------------------------------------------------------------- trend
def sliding_mean(q: np.ndarray, window: int) -> np.ndarray:
    """O(n) cumulative-sum sliding mean, same semantics as
    ``np.convolve(q, np.ones(w)/w, mode="same")`` (zero-padded edges,
    constant 1/w weight) but without the O(n·w) inner product."""
    n = len(q)
    if n == 0:
        return q.astype(np.float64)
    w = max(min(window, n), 1)
    half = (w - 1) // 2
    # out[i] = (c[min(i+half+1, n)] - c[max(i+half+1-w, 0)]) / w over the
    # exclusive prefix sums c: clamped head / core / clamped tail
    c = np.empty(n + 1, np.float64)
    c[0] = 0.0
    np.cumsum(q, out=c[1:])
    out = np.empty(n, np.float64)
    head, tail = w - half - 1, half
    np.subtract(c[w:], c[:n + 1 - w], out=out[head:n - tail])
    out[:head] = c[half + 1:w]                       # lo clamped to 0
    np.subtract(c[n], c[n + 1 - w:n + 1 - w + tail],
                out=out[n - tail:])                  # hi clamped to n
    out /= w
    return out


def trend_correlation_from_counts(qa: np.ndarray, qb: np.ndarray,
                                  window_s: int = 60) -> float:
    """Pearson correlation between two count series' trends, resampled to
    the shorter series — quantifies the paper's 'similar trend' claim
    (Fig. 6)."""
    ta = sliding_mean(np.asarray(qa, np.float64), window_s)
    tb = sliding_mean(np.asarray(qb, np.float64), window_s)
    if len(ta) == 0 or len(tb) == 0:
        return float("nan")
    n = min(len(ta), len(tb))
    ra = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, len(ta)), ta)
    rb = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, len(tb)), tb)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else float("nan")
