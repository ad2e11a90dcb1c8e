"""Kernels B3 and B6: fused batched stream metrics — per-row int32
histogram of scale stamps and its moments ``[Σq, Σq²]``, over the whole
timeline (B3) or one time chunk at a time with a carried moment state (B6).

Counterparts of ``repro/kernels/metrics_fused.py``:

- :func:`stream_metrics` (B3, ``stream_metrics_pallas``);
- :func:`stream_metrics_carry` (B6, ``stream_metrics_carry_pallas``): the
  same histogram over one chunk's stamps, counted in bucket ``ss - base``,
  and the moment fold seeded from a per-row Kahan state
  ``[s1, c1, s2, c2]``; it returns the updated state;
- :func:`stream_metrics_time`, B3's time form (no TPU counterpart: the
  reference buckets an original stream on the host): the same histogram
  and moments of original streams read as float64 timestamps where they
  already lie on the device, each record bucketed as
  ``clip(floor(t - t0), 0, tr - 1)``, the host's ``_bucket_series`` of
  :mod:`repro_torch.streamsim.metrics`.

Each wrapper launches ``csrc/metrics_fused.cu`` for CUDA tensors (one
launch per call: the histogram's zeroing, the counting and the moment
fold in one kernel, with its span words and done-tickets kept in a
per-stream workspace) and runs its plain version for CPU tensors. Counts
are exact; moments are f32 partials over ``bucket_block``-bucket blocks
(``BUCKET_BLOCK`` = 512 unless a tile config says otherwise) folded with
Kahan compensation (``repro/kernels/metrics_fused.py:118-132``), within
1e-5 relative of f64. Kernel and plain version add the partials in
different orders, so their moments agree to that tolerance, not bit for
bit; within each, B6 with a zero carry gives B3's result bit for bit.

A tile config (:class:`repro_torch.kernels.tuning.TileConfig`) chooses the
kernel's instance: ``record_tile`` records a tile, one of
:data:`RECORD_TILES` (no output changes), and ``bucket_block`` buckets a
moment partial, one of :data:`BUCKET_BLOCKS` (the moments change in their
last bits; the plain versions take the same ``bucket_block``). The
histogram width must be a multiple of the config's ``bucket_block``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

BUCKET_BLOCK = 512

#: the kernel's instances: records a tile and buckets a moment partial
#: (the default library's are 4096 and ``BUCKET_BLOCK``)
RECORD_TILES = (2048, 4096, 8192)
BUCKET_BLOCKS = (256, 512, 1024)
DEFAULT_RECORD_TILE = 4096


def bucket_block_of(config) -> int:
    """The moment partial width ``config`` asks for (``None``: the
    default)."""
    return BUCKET_BLOCK if config is None else int(config.bucket_block)


def defines(config) -> tuple:
    """The ``-D`` macros of ``config``'s instance (``()``: the default
    library); raises for a tile that has no instance."""
    if config is None:
        return ()
    rt, bb = config.record_tile, config.bucket_block
    if rt not in RECORD_TILES or bb not in BUCKET_BLOCKS:
        raise ValueError(f"metrics_fused: ({rt}, {bb}) has no instance; "
                         f"record_tile in {RECORD_TILES}, bucket_block in "
                         f"{BUCKET_BLOCKS}")
    out = []
    if rt != DEFAULT_RECORD_TILE:
        out.append(("REPRO_RECORD_TILE", rt))
    if bb != BUCKET_BLOCK:
        out.append(("REPRO_BUCKET_BLOCK", bb))
    return tuple(out)


def _kahan_fold(hist, state, block: int = BUCKET_BLOCK):
    """Fold the block partials of q and q² (f32, ``block``-bucket blocks)
    into the per-row Kahan state ``(S, 4)`` float32 ``[s1, c1, s2, c2]``,
    in block order; returns the updated state."""
    S, B = hist.shape
    q = hist.to(torch.float32).reshape(S, B // block, block)
    p1, p2 = q.sum(dim=2), (q * q).sum(dim=2)
    s1, c1, s2, c2 = state.to(torch.float32).unbind(dim=1)
    for blk in range(B // block):
        y1 = p1[:, blk] - c1
        t1 = s1 + y1
        c1 = (t1 - s1) - y1
        s1 = t1
        y2 = p2[:, blk] - c2
        t2 = s2 + y2
        c2 = (t2 - s2) - y2
        s2 = t2
    return torch.stack([s1, c1, s2, c2], dim=1)


def _kahan_moments(hist, block: int = BUCKET_BLOCK):
    """``[Σq, Σq²]`` of each row, ``(S, 2)`` float32: the fold from a zero
    state."""
    zero = torch.zeros((hist.shape[0], 4), dtype=torch.float32,
                       device=hist.device)
    return _kahan_fold(hist, zero, block)[:, ::2].contiguous()


def _histogram(ss, lengths, buckets: int, base: int = 0,
               block: int = BUCKET_BLOCK):
    """Per-row int32 histogram: record ``i`` of row ``s`` counts in bucket
    ``ss - base`` iff ``i < lengths[s]`` and ``0 <= ss - base < buckets``."""
    if buckets % block:
        raise ValueError(f"buckets {buckets} must be a multiple of "
                         f"{block}")
    S, n = ss.shape
    i = torch.arange(n, device=ss.device)[None, :]
    local = ss.long() - int(base)
    valid = (i < lengths.to(ss.device)[:, None].long()) & (local >= 0) & \
        (local < buckets)
    slot = torch.where(valid, local, torch.full_like(local, buckets))
    hist = torch.zeros((S, buckets + 1), dtype=torch.int32, device=ss.device)
    hist.scatter_add_(1, slot, torch.ones_like(ss, dtype=torch.int32))
    return hist[:, :buckets].contiguous()


def _time_buckets(t, first, t0, lengths, tr, buckets: int):
    """The time form's bucket of every record, ``(S, N)`` int64 with
    ``buckets`` past each row's length: ``floor(t - t0)`` in float64,
    clamped to ``[0, tr - 1]`` (NaN to 0, as the host's int cast and clip
    put it)."""
    lens, firsts, trs = lengths.tolist(), first.tolist(), tr.tolist()
    ss = torch.full((len(lens), max(lens + [1])), buckets, dtype=torch.int64,
                    device=t.device)
    for s, (a, m, top) in enumerate(zip(firsts, lens, trs)):
        d = torch.floor(t[a:a + m] - t0[s])
        d = torch.where(d >= 0, d, torch.zeros_like(d))
        ss[s, :m] = d.clamp_(max=max(top, 1) - 1).to(torch.int64)
    return ss


def stream_metrics_time_plain(t, first, t0, lengths, tr, buckets: int, *,
                              bucket_block: int = BUCKET_BLOCK):
    """Plain PyTorch version of B3's time form (any device).

    t       : (T,) float64 timestamps, the rows' records end to end.
    first   : (S,) int64, each row's first record in ``t``.
    t0      : (S,) float64, each row's base (its stream's ``t[0]``).
    lengths : (S,) int32, each row's records.
    tr      : (S,) int32, each row's series length (at least 1).
    buckets : histogram width, a multiple of ``bucket_block``.
    bucket_block : buckets a moment partial.

    Record ``i`` of row ``s`` counts in bucket ``min(max(floor(t[first[s] +
    i] - t0[s]), 0), tr[s] - 1)`` when that is below ``buckets``. Returns
    ``(hist int32 (S, buckets), mom float32 (S, 2))``: the histogram of
    those buckets and its moments, as :func:`stream_metrics_plain` gives
    them on the same histogram.
    """
    ss = _time_buckets(t, first, t0, lengths, tr, buckets)
    hist = _histogram(ss, lengths, buckets, block=bucket_block)
    return hist, _kahan_moments(hist, bucket_block)


def stream_metrics_plain(ss, lengths, buckets: int, *,
                         bucket_block: int = BUCKET_BLOCK):
    """Plain PyTorch version of B3 (any device).

    ss      : (S, N) int32 scale stamps (any order).
    lengths : (S,) int32; record ``i`` of row ``s`` counts iff
              ``i < lengths[s]`` and ``0 <= ss[s, i] < buckets``.
    buckets : histogram width, a multiple of ``bucket_block``.
    bucket_block : buckets a moment partial.

    Returns ``(hist int32 (S, buckets), mom float32 (S, 2))``.
    """
    hist = _histogram(ss, lengths, buckets, block=bucket_block)
    return hist, _kahan_moments(hist, bucket_block)


def stream_metrics_carry_plain(ss, lengths, buckets: int, mcar, base=0, *,
                               bucket_block: int = BUCKET_BLOCK):
    """Plain PyTorch version of B6 (any device).

    ss      : (S, N) int32 stamps of one chunk; record ``i`` of row ``s``
              counts in bucket ``ss - base`` iff ``i < lengths[s]`` and
              ``0 <= ss - base < buckets``.
    lengths : (S,) int32.
    buckets : chunk histogram width, a multiple of ``bucket_block``.
    mcar    : (S, 4) float32 Kahan state ``[s1, c1, s2, c2]`` carried from
              the previous chunk (zeros for the first).
    base    : the chunk's first absolute bucket (the rebase).
    bucket_block : buckets a moment partial.

    Returns ``(hist int32 (S, buckets), mom float32 (S, 4))``: the chunk's
    histogram and the state with its buckets folded in (``mom[:, 0]`` and
    ``mom[:, 2]`` are the running ``Σq`` and ``Σq²``).
    """
    hist = _histogram(ss, lengths, buckets, base, bucket_block)
    return hist, _kahan_fold(hist, mcar, bucket_block)


@functools.lru_cache(maxsize=None)
def _entry(defs):
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    return _build.bind("metrics_fused", "metrics_launch",
                       [p, p, i, i, i, p, p, u, p, p, p], defs)


@functools.lru_cache(maxsize=None)
def _carry_entry(defs):
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    return _build.bind("metrics_fused", "metrics_carry_launch",
                       [p, p, i, i, i, i, p, p, u, p, p, p, p], defs)


@functools.lru_cache(maxsize=None)
def _time_entry(defs):
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    return _build.bind("metrics_fused", "metrics_time_launch",
                       [p, p, p, p, p, i, i, i, p, p, u, p, p, p], defs)


@functools.lru_cache(maxsize=None)
def _limits(defs):
    """(buckets per zeroed span, buckets per moment partial, largest
    epoch), read from the library."""
    return tuple(_build.bind("metrics_fused", name, [], defs)()
                 for name in ("metrics_span_buckets", "metrics_bucket_block",
                              "metrics_max_epoch"))


#: one workspace per (device, CUDA stream), shared by the instances: a
#: word per span and per moment partial of each row's histogram, sized by
#: the calling instance's partial width; the ticket counter and two
#: counters a row (its count and its partials done)
_workspaces = {}


def _launch(lengths, n: int, buckets: int, defs, *, ss=None, mcar=None,
            base: int = 0, time=None):
    """One launch on ``lengths``' device and current stream: B3 on the
    stamps ``ss``, B6 when ``mcar`` is given too, B3's time form when
    ``time`` = ``(t, first, t0, tr)`` is; ``n`` is the stamps' width or the
    longest time row. ``hist`` and ``mom`` are allocated uninitialised; the
    kernel writes them whole."""
    S = lengths.shape[0]
    dev = lengths.device
    hist = torch.empty((S, buckets), dtype=torch.int32, device=dev)
    mom = torch.empty((S, 2 if mcar is None else 4), dtype=torch.float32,
                      device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        span, block, max_epoch = _limits(defs)
        ws, stream = _build.per_stream(
            _workspaces, dev,
            lambda d: _build.LookbackWorkspace(d, max_epoch))
        words, counters, epoch = ws.take(
            S * (-(-buckets // span) + buckets // block), 1 + 2 * S)
        scratch = (p(words), p(counters), epoch, p(hist))
        if time is not None:
            code = _time_entry(defs)(*map(p, time), p(lengths), S, n,
                                     buckets, *scratch, p(mom), stream)
        elif mcar is None:
            code = _entry(defs)(p(ss), p(lengths), S, n, buckets, *scratch,
                                p(mom), stream)
        else:
            code = _carry_entry(defs)(p(ss), p(lengths), int(base), S, n,
                                      buckets, *scratch, p(mcar), p(mom),
                                      stream)
    _build.check(code, "metrics_fused")
    return hist, mom


def _check_inputs(ss, lengths, buckets: int, block: int) -> None:
    """What both CUDA entries take: a CUDA stamp matrix, its lengths on
    the same device, block-aligned buckets, one launch's worth of rows."""
    if ss.device.type != "cuda":
        raise ValueError(f"stream_metrics runs on cuda or cpu, not "
                         f"{ss.device}")
    if ss.dtype != torch.int32 or ss.ndim != 2 or not ss.is_contiguous():
        raise ValueError("ss must be a contiguous 2-D int32 tensor")
    S, n = ss.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (S,) or \
            lengths.device != ss.device or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (S,) int32 tensor on "
                         "the stamps' device")
    if buckets <= 0 or buckets % block:
        raise ValueError(f"buckets {buckets} must be a positive multiple "
                         f"of {block}")
    if S > 65535 or S * n >= 2 ** 31 or S * buckets >= 2 ** 31:
        raise ValueError(f"batch {S} x {n} (x {buckets} buckets) too large "
                         "for one launch")


def stream_metrics(ss, lengths, buckets: int, *, config=None):
    """B3 on the stamps' device: the CUDA kernel for CUDA tensors (the
    instance ``config`` names, ``None`` the default), the plain version for
    CPU tensors (same contract as :func:`stream_metrics_plain`, at
    ``config``'s ``bucket_block``). Each call that launches the kernel (one
    launch: zeroing, histogram and moments) adds one to
    ``stream_metrics.launches``."""
    block = bucket_block_of(config)
    if ss.device.type == "cpu":
        return stream_metrics_plain(ss, lengths, buckets,
                                    bucket_block=block)
    defs = defines(config)
    _check_inputs(ss, lengths, buckets, block)
    out = _launch(lengths, ss.shape[1], buckets, defs, ss=ss)
    stream_metrics.launches += 1
    return out


stream_metrics.launches = 0


def stream_metrics_carry(ss, lengths, buckets: int, mcar, base=0, *,
                         config=None):
    """B6 on the stamps' device: the CUDA kernel for CUDA tensors (the
    instance ``config`` names, ``None`` the default), the plain version for
    CPU tensors (same contract as :func:`stream_metrics_carry_plain`, at
    ``config``'s ``bucket_block``). Each call that launches the kernel (one
    launch: zeroing, histogram and the carried moment fold) adds one to
    ``stream_metrics_carry.launches``."""
    block = bucket_block_of(config)
    if ss.device.type == "cpu":
        return stream_metrics_carry_plain(ss, lengths, buckets, mcar, base,
                                          bucket_block=block)
    defs = defines(config)
    _check_inputs(ss, lengths, buckets, block)
    S = ss.shape[0]
    if mcar.dtype != torch.float32 or tuple(mcar.shape) != (S, 4) or \
            mcar.device != ss.device or not mcar.is_contiguous():
        raise ValueError("mcar must be a contiguous (S, 4) float32 tensor "
                         "on the stamps' device")
    if not -2 ** 31 <= int(base) < 2 ** 31:
        raise ValueError(f"base {base} outside int32")
    out = _launch(lengths, ss.shape[1], buckets, defs, ss=ss, mcar=mcar,
                  base=base)
    stream_metrics_carry.launches += 1
    return out


stream_metrics_carry.launches = 0


def stream_metrics_time(t, first, t0, lengths, tr, buckets: int, n: int, *,
                        config=None):
    """B3's time form on the timestamps' device: the CUDA kernel for CUDA
    tensors (the instance ``config`` names, ``None`` the default), the plain
    version for CPU tensors (same contract as
    :func:`stream_metrics_time_plain`, at ``config``'s ``bucket_block``).
    ``n`` is the longest row (``lengths.max()``, from the host: it sizes
    the launch). The kernel reads each row's records where ``first`` and
    ``lengths`` put them in ``t`` (the caller keeps them inside ``t``) and
    writes ``hist`` and ``mom`` whole. A launch is one of B3's: it adds one
    to ``stream_metrics.launches``."""
    block = bucket_block_of(config)
    if t.device.type == "cpu":
        return stream_metrics_time_plain(t, first, t0, lengths, tr, buckets,
                                         bucket_block=block)
    defs = defines(config)
    if t.device.type != "cuda" or t.dtype != torch.float64 or \
            t.ndim != 1 or not t.is_contiguous():
        raise ValueError("t must be a contiguous 1-D float64 tensor on cuda "
                         "or cpu")
    S = lengths.shape[0]
    for name, x, dtype in (("first", first, torch.int64),
                           ("t0", t0, torch.float64),
                           ("lengths", lengths, torch.int32),
                           ("tr", tr, torch.int32)):
        if x.dtype != dtype or tuple(x.shape) != (S,) or \
                x.device != t.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({S},) {dtype} "
                             "tensor on the timestamps' device")
    if buckets <= 0 or buckets % block:
        raise ValueError(f"buckets {buckets} must be a positive multiple "
                         f"of {block}")
    if S > 65535 or S * buckets >= 2 ** 31 or not 0 <= n < 2 ** 31:
        raise ValueError(f"batch {S} x {n} (x {buckets} buckets) too large "
                         "for one launch")
    out = _launch(lengths, n, buckets, defs, time=(t, first, t0, tr))
    stream_metrics.launches += 1
    return out
