"""Kernels B3 and B6: fused batched stream metrics — per-row int32
histogram of scale stamps and its moments ``[Σq, Σq²]``, over the whole
timeline (B3) or one time chunk at a time with a carried moment state (B6).

Counterparts of ``repro/kernels/metrics_fused.py``:

- :func:`stream_metrics` (B3, ``stream_metrics_pallas``);
- :func:`stream_metrics_carry` (B6, ``stream_metrics_carry_pallas``): the
  same histogram over one chunk's stamps, counted in bucket ``ss - base``,
  and the moment fold seeded from a per-row Kahan state
  ``[s1, c1, s2, c2]``; it returns the updated state.

Each wrapper launches ``csrc/metrics_fused.cu`` for CUDA tensors (one
launch per call: the histogram's zeroing, the counting and the moment
fold in one kernel, with its span words and done-tickets kept in a
per-stream workspace) and runs its plain version for CPU tensors. Counts
are exact; moments are f32 partials over ``BUCKET_BLOCK``-bucket blocks
folded with Kahan compensation (``repro/kernels/metrics_fused.py:118-132``),
within 1e-5 relative of f64. Kernel and plain version add the partials in
different orders, so their moments agree to that tolerance, not bit for
bit; within each, B6 with a zero carry gives B3's result bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

BUCKET_BLOCK = 512


def _kahan_fold(hist, state):
    """Fold the block partials of q and q² (f32, ``BUCKET_BLOCK``-bucket
    blocks) into the per-row Kahan state ``(S, 4)`` float32
    ``[s1, c1, s2, c2]``, in block order; returns the updated state."""
    S, B = hist.shape
    q = hist.to(torch.float32).reshape(S, B // BUCKET_BLOCK, BUCKET_BLOCK)
    p1, p2 = q.sum(dim=2), (q * q).sum(dim=2)
    s1, c1, s2, c2 = state.to(torch.float32).unbind(dim=1)
    for blk in range(B // BUCKET_BLOCK):
        y1 = p1[:, blk] - c1
        t1 = s1 + y1
        c1 = (t1 - s1) - y1
        s1 = t1
        y2 = p2[:, blk] - c2
        t2 = s2 + y2
        c2 = (t2 - s2) - y2
        s2 = t2
    return torch.stack([s1, c1, s2, c2], dim=1)


def _kahan_moments(hist):
    """``[Σq, Σq²]`` of each row, ``(S, 2)`` float32: the fold from a zero
    state."""
    zero = torch.zeros((hist.shape[0], 4), dtype=torch.float32,
                       device=hist.device)
    return _kahan_fold(hist, zero)[:, ::2].contiguous()


def _histogram(ss, lengths, buckets: int, base: int = 0):
    """Per-row int32 histogram: record ``i`` of row ``s`` counts in bucket
    ``ss - base`` iff ``i < lengths[s]`` and ``0 <= ss - base < buckets``."""
    if buckets % BUCKET_BLOCK:
        raise ValueError(f"buckets {buckets} must be a multiple of "
                         f"{BUCKET_BLOCK}")
    S, n = ss.shape
    i = torch.arange(n, device=ss.device)[None, :]
    local = ss.long() - int(base)
    valid = (i < lengths.to(ss.device)[:, None].long()) & (local >= 0) & \
        (local < buckets)
    slot = torch.where(valid, local, torch.full_like(local, buckets))
    hist = torch.zeros((S, buckets + 1), dtype=torch.int32, device=ss.device)
    hist.scatter_add_(1, slot, torch.ones_like(ss, dtype=torch.int32))
    return hist[:, :buckets].contiguous()


def stream_metrics_plain(ss, lengths, buckets: int):
    """Plain PyTorch version of B3 (any device).

    ss      : (S, N) int32 scale stamps (any order).
    lengths : (S,) int32; record ``i`` of row ``s`` counts iff
              ``i < lengths[s]`` and ``0 <= ss[s, i] < buckets``.
    buckets : histogram width, a multiple of ``BUCKET_BLOCK``.

    Returns ``(hist int32 (S, buckets), mom float32 (S, 2))``.
    """
    hist = _histogram(ss, lengths, buckets)
    return hist, _kahan_moments(hist)


def stream_metrics_carry_plain(ss, lengths, buckets: int, mcar, base=0):
    """Plain PyTorch version of B6 (any device).

    ss      : (S, N) int32 stamps of one chunk; record ``i`` of row ``s``
              counts in bucket ``ss - base`` iff ``i < lengths[s]`` and
              ``0 <= ss - base < buckets``.
    lengths : (S,) int32.
    buckets : chunk histogram width, a multiple of ``BUCKET_BLOCK``.
    mcar    : (S, 4) float32 Kahan state ``[s1, c1, s2, c2]`` carried from
              the previous chunk (zeros for the first).
    base    : the chunk's first absolute bucket (the rebase).

    Returns ``(hist int32 (S, buckets), mom float32 (S, 4))``: the chunk's
    histogram and the state with its buckets folded in (``mom[:, 0]`` and
    ``mom[:, 2]`` are the running ``Σq`` and ``Σq²``).
    """
    hist = _histogram(ss, lengths, buckets, base)
    return hist, _kahan_fold(hist, mcar)


@functools.lru_cache(maxsize=None)
def _entry():
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    return _build.bind("metrics_fused", "metrics_launch",
                       [p, p, i, i, i, p, p, u, p, p, p])


@functools.lru_cache(maxsize=None)
def _carry_entry():
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    return _build.bind("metrics_fused", "metrics_carry_launch",
                       [p, p, i, i, i, i, p, p, u, p, p, p, p])


@functools.lru_cache(maxsize=None)
def _limits():
    """(buckets per zeroed span, buckets per moment partial, largest
    epoch), read from the library."""
    return tuple(_build.bind("metrics_fused", name, [])() for name in (
        "metrics_span_buckets", "metrics_bucket_block", "metrics_max_epoch"))


def _workspace(device):
    return _build.LookbackWorkspace(device, _limits()[2])


#: one workspace per (device, CUDA stream): a word per span and per moment
#: partial of each row's histogram; the ticket counter and two counters a
#: row (its count and its partials done)
_workspaces = {}


def _launch(ss, lengths, buckets: int, mcar=None, base: int = 0):
    """One launch on ``ss``'s device and current stream: B3, or B6 when
    ``mcar`` is given. ``hist`` and ``mom`` are allocated uninitialised;
    the kernel writes them whole."""
    S, n = ss.shape
    dev = ss.device
    hist = torch.empty((S, buckets), dtype=torch.int32, device=dev)
    mom = torch.empty((S, 2 if mcar is None else 4), dtype=torch.float32,
                      device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        ws, stream = _build.per_stream(_workspaces, dev, _workspace)
        span, block, _ = _limits()
        words, counters, epoch = ws.take(
            S * (-(-buckets // span) + buckets // block), 1 + 2 * S)
        scratch = (p(words), p(counters), epoch, p(hist))
        if mcar is None:
            code = _entry()(p(ss), p(lengths), S, n, buckets, *scratch,
                            p(mom), stream)
        else:
            code = _carry_entry()(p(ss), p(lengths), int(base), S, n,
                                  buckets, *scratch, p(mcar), p(mom), stream)
    _build.check(code, "metrics_fused")
    return hist, mom


def _check_inputs(ss, lengths, buckets: int) -> None:
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
    if buckets <= 0 or buckets % BUCKET_BLOCK:
        raise ValueError(f"buckets {buckets} must be a positive multiple "
                         f"of {BUCKET_BLOCK}")
    if S > 65535 or S * n >= 2 ** 31 or S * buckets >= 2 ** 31:
        raise ValueError(f"batch {S} x {n} (x {buckets} buckets) too large "
                         "for one launch")


def stream_metrics(ss, lengths, buckets: int):
    """B3 on the stamps' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (same contract as
    :func:`stream_metrics_plain`). Each call that launches the kernel (one
    launch: zeroing, histogram and moments) adds one to
    ``stream_metrics.launches``."""
    if ss.device.type == "cpu":
        return stream_metrics_plain(ss, lengths, buckets)
    _check_inputs(ss, lengths, buckets)
    out = _launch(ss, lengths, buckets)
    stream_metrics.launches += 1
    return out


stream_metrics.launches = 0


def stream_metrics_carry(ss, lengths, buckets: int, mcar, base=0):
    """B6 on the stamps' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (same contract as
    :func:`stream_metrics_carry_plain`). Each call that launches the
    kernel (one launch: zeroing, histogram and the carried moment fold)
    adds one to ``stream_metrics_carry.launches``."""
    if ss.device.type == "cpu":
        return stream_metrics_carry_plain(ss, lengths, buckets, mcar, base)
    _check_inputs(ss, lengths, buckets)
    S = ss.shape[0]
    if mcar.dtype != torch.float32 or tuple(mcar.shape) != (S, 4) or \
            mcar.device != ss.device or not mcar.is_contiguous():
        raise ValueError("mcar must be a contiguous (S, 4) float32 tensor "
                         "on the stamps' device")
    if not -2 ** 31 <= int(base) < 2 ** 31:
        raise ValueError(f"base {base} outside int32")
    out = _launch(ss, lengths, buckets, mcar, base)
    stream_metrics_carry.launches += 1
    return out


stream_metrics_carry.launches = 0
