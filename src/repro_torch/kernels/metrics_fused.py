"""Kernel B3: fused batched stream metrics — per-row int32 histogram of
scale stamps and its moments ``[Σq, Σq²]``.

Counterpart of ``repro/kernels/metrics_fused.py::stream_metrics_pallas``.
:func:`stream_metrics` launches ``csrc/metrics_fused.cu`` for CUDA tensors
and runs :func:`stream_metrics_plain` for CPU tensors. Counts are exact;
moments are f32 partials over ``BUCKET_BLOCK``-bucket blocks folded with
Kahan compensation (``repro/kernels/metrics_fused.py:118-132``), within
1e-5 relative of f64. The two versions add the partials in different
orders, so their moments agree to that tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

BUCKET_BLOCK = 512


def _kahan_moments(hist):
    """Block partials of q and q² in f32 over ``BUCKET_BLOCK``-bucket
    blocks, folded in block order with Kahan compensation; returns
    ``(S, 2)`` float32."""
    S, B = hist.shape
    q = hist.to(torch.float32).reshape(S, B // BUCKET_BLOCK, BUCKET_BLOCK)
    p1, p2 = q.sum(dim=2), (q * q).sum(dim=2)
    zero = torch.zeros(S, dtype=torch.float32, device=hist.device)
    s1, c1, s2, c2 = zero, zero, zero, zero
    for blk in range(B // BUCKET_BLOCK):
        y1 = p1[:, blk] - c1
        t1 = s1 + y1
        c1 = (t1 - s1) - y1
        s1 = t1
        y2 = p2[:, blk] - c2
        t2 = s2 + y2
        c2 = (t2 - s2) - y2
        s2 = t2
    return torch.stack([s1, s2], dim=1)


def stream_metrics_plain(ss, lengths, buckets: int):
    """Plain PyTorch version (any device).

    ss      : (S, N) int32 scale stamps (any order).
    lengths : (S,) int32; record ``i`` of row ``s`` counts iff
              ``i < lengths[s]`` and ``0 <= ss[s, i] < buckets``.
    buckets : histogram width, a multiple of ``BUCKET_BLOCK``.

    Returns ``(hist int32 (S, buckets), mom float32 (S, 2))``.
    """
    if buckets % BUCKET_BLOCK:
        raise ValueError(f"buckets {buckets} must be a multiple of "
                         f"{BUCKET_BLOCK}")
    S, n = ss.shape
    i = torch.arange(n, device=ss.device)[None, :]
    valid = (i < lengths.to(ss.device)[:, None].long()) & (ss >= 0) & \
        (ss < buckets)
    slot = torch.where(valid, ss.long(), torch.full_like(ss, buckets).long())
    hist = torch.zeros((S, buckets + 1), dtype=torch.int32, device=ss.device)
    hist.scatter_add_(1, slot, torch.ones_like(ss, dtype=torch.int32))
    hist = hist[:, :buckets].contiguous()
    return hist, _kahan_moments(hist)


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("metrics_fused", "metrics_launch",
                       [p, p, i, i, i, p, p, p])


def stream_metrics(ss, lengths, buckets: int):
    """B3 on the stamps' device: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors (same contract as
    :func:`stream_metrics_plain`). Each call that launches the kernels
    (histogram, then moments) adds one to ``stream_metrics.launches``."""
    if ss.device.type == "cpu":
        return stream_metrics_plain(ss, lengths, buckets)
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
    hist = torch.zeros((S, buckets), dtype=torch.int32, device=ss.device)
    mom = torch.empty((S, 2), dtype=torch.float32, device=ss.device)
    p = _build.ptr
    with torch.cuda.device(ss.device):
        code = _entry()(p(ss), p(lengths), S, n, buckets, p(hist), p(mom),
                        _build.stream_handle(ss.device))
    _build.check(code, "metrics_fused")
    stream_metrics.launches += 1
    return hist, mom


stream_metrics.launches = 0
