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
- :func:`nsa_sweep_device` — a (stream × max_range) scenario grid as ONE
  launch of each kernel, leaving the kept stamps on the device for the
  metrics kernel.

Backend selection rules
-----------------------
``backend`` is ``"numpy" | "torch" | "auto"``; ``"auto"`` means
``"torch"``. The torch backend runs on ``device`` (``None`` means CUDA):
the CUDA kernels on a CUDA device, their plain PyTorch versions on
``device="cpu"``. Asking for CUDA without a usable CUDA runtime raises;
nothing falls back to the CPU. Every backend produces bit-identical output.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

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
    autotune : None or "off"
        Tile tuning is not ported; anything else raises
        ``NotImplementedError``.

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
    ops.check_autotune(autotune)
    m = _multiple(len(stream), stream.time_range, max_range, multiple_mode)
    if (_resolve_backend(backend) == "torch" and keep == "systematic"
            and len(stream) > 0):
        try:
            handles = nsa_sweep_device({stream.name: stream},
                                       [(stream.name, max_range)],
                                       multiple_mode=multiple_mode,
                                       device=device)
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


def nsa_sweep_device(streams: Dict[str, Stream],
                     pairs: Sequence[Tuple[str, int]], *,
                     multiple_mode: str = "time", device=None):
    """The device leg of a range-padded sweep — NO host gather.

    Runs ONE ``stream_sample`` launch (B1) plus ONE batched compaction (B2)
    for the scenario rows ``pairs`` (each a ``(stream name, max_range)``;
    the streams must be non-empty) on ``device`` (``None`` means CUDA),
    then gathers each row's kept stamps on the device.

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

    from repro_torch.kernels import ops

    ts = [streams[name].t for name, _ in pairs]
    mults = [_multiple(len(streams[name]), streams[name].time_range, mr,
                       multiple_mode) for name, mr in pairs]
    ss_b, keep_b, lengths = ops.stream_sample_batched(
        ts, [mr for _, mr in pairs], mults, device=device)
    idx_b, totals = ops.compact_mask_batched(keep_b)
    N = idx_b.shape[1]
    width = min(max(int(-(-int(totals.max(initial=1)) // ops.TILE)
                        * ops.TILE), ops.TILE), N)
    ss_kept = torch.gather(
        ss_b, 1, torch.clamp(idx_b[:, :width], 0, max(N - 1, 0)).long())
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
