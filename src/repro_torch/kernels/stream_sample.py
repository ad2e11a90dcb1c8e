"""Kernel B1: the fused, batched NSA inner loop (normalize -> scale stamp
-> systematic keep bit) over ``(S, N)`` stacked streams.

Counterpart of ``repro/kernels/stream_sample.py::stream_sample_pallas``.
:func:`stream_sample` launches ``csrc/stream_sample.cu`` for CUDA tensors
and runs :func:`stream_sample_plain`, the same arithmetic in plain PyTorch,
for CPU tensors. Both are bit-identical to the numpy NSA path: the f32
bucket guess is snapped by +-1 to the exact f64 host tables
(:func:`repro_torch.kernels.ops._nsa_tables`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: the +-1 snap is exact only while the f32 normalize error stays under one
#: bucket: ~4 * max_range * 2^-24 < 1
MAX_RANGE_LIMIT = 1 << 20


def stream_sample_plain(t, starts, counts, ktab, scalars, lengths):
    """Plain PyTorch version of the kernel (any device).

    t       : (S, N) float32 rebased timestamps, sorted per row.
    starts, counts, ktab : (S, W) int32 exact per-bucket tables.
    scalars : (S, 3) float32 rows of (t_min, 1/span, n_buckets).
    lengths : (S,) int32 true row lengths; keep is False past them.

    Returns ``(ss int32 (S, N), keep bool (S, N))``.
    """
    S, n = t.shape
    t_min, inv_span, nb_f = scalars[:, 0:1], scalars[:, 1:2], scalars[:, 2:3]
    nb = nb_f.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=t.device)
    g = torch.floor((t - t_min) * inv_span * nb_f).to(torch.int32)
    g = torch.minimum(torch.maximum(g, zero), nb - 1)
    gidx = torch.arange(n, dtype=torch.int32, device=t.device).expand(S, n)
    s_g = torch.gather(starts, 1, g.long())
    c_g = torch.gather(counts, 1, g.long())
    g = g + (gidx >= s_g + c_g).to(torch.int32) \
        - (gidx < s_g).to(torch.int32)
    ss = torch.minimum(torch.maximum(g, zero), nb - 1)
    start = torch.gather(starts, 1, ss.long())
    c = torch.gather(counts, 1, ss.long())
    k = torch.gather(ktab, 1, ss.long())
    rank = gidx - start
    keep = torch.remainder(rank * k, torch.clamp(c, min=1)) < k
    keep &= gidx < lengths.to(torch.int32)[:, None]
    return ss, keep


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("stream_sample", "stream_sample_launch",
                       [p, p, p, p, p, p, p, p, i, i, i, p])


def _check_inputs(t, starts, counts, ktab, scalars, lengths) -> None:
    S, n = t.shape
    W = starts.shape[1]
    want = {"t": (t, torch.float32, (S, n)),
            "starts": (starts, torch.int32, (S, W)),
            "counts": (counts, torch.int32, (S, W)),
            "ktab": (ktab, torch.int32, (S, W)),
            "scalars": (scalars, torch.float32, (S, 3)),
            "lengths": (lengths, torch.int32, (S,))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != t.device:
            raise ValueError(f"{name} is on {x.device}, t on {t.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if W > MAX_RANGE_LIMIT:
        raise ValueError(f"table width {W} exceeds {MAX_RANGE_LIMIT}")
    if S > 65535 or S * n >= 2 ** 31:
        raise ValueError(f"batch {S} x {n} too large for one launch")


def stream_sample(t, starts, counts, ktab, scalars, lengths):
    """B1 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (same arguments and results as
    :func:`stream_sample_plain`). Each kernel launch adds one to
    ``stream_sample.launches``."""
    if t.device.type == "cpu":
        return stream_sample_plain(t, starts, counts, ktab, scalars,
                                   lengths)
    if t.device.type != "cuda":
        raise ValueError(f"stream_sample runs on cuda or cpu, not "
                         f"{t.device}")
    _check_inputs(t, starts, counts, ktab, scalars, lengths)
    S, n = t.shape
    ss = torch.empty((S, n), dtype=torch.int32, device=t.device)
    keep = torch.empty((S, n), dtype=torch.bool, device=t.device)
    p = _build.ptr
    with torch.cuda.device(t.device):
        code = _entry()(p(t), p(starts), p(counts), p(ktab), p(scalars),
                        p(lengths), p(ss), p(keep), S, n, starts.shape[1],
                        _build.stream_handle(t.device))
    _build.check(code, "stream_sample")
    stream_sample.launches += 1
    return ss, keep


stream_sample.launches = 0
