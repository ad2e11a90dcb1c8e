"""Kernel B1: the fused, batched NSA inner loop (rebase -> normalize ->
scale stamp -> systematic keep bit) over ``S`` rows of ``n`` records.

Counterpart of ``repro/kernels/stream_sample.py::stream_sample_pallas``.
:func:`stream_sample` launches ``csrc/stream_sample.cu`` for CUDA tensors
and runs :func:`stream_sample_plain`, the same arithmetic in plain PyTorch,
for CPU tensors. Both are bit-identical to the numpy NSA path: the f32
bucket guess is snapped by +-1 to the exact f64 host tables
(:func:`repro_torch.kernels.ops._nsa_tables`).

The rows read their records from float64 sources laid end to end in one
buffer, each row from its own first record (:class:`SampleArgs`): rows of
one stream share its copy, and a chunk of a stream is a record offset into
it. The float64 -> f32 rebase happens inside the kernel.

A tile config (:class:`repro_torch.kernels.tuning.TileConfig`) chooses the
kernel's instance: ``record_tile`` records a block, one of
:data:`RECORD_TILES`. It changes no output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

#: the +-1 snap is exact only while the f32 normalize error stays under one
#: bucket: ~4 * max_range * 2^-24 < 1
MAX_RANGE_LIMIT = 1 << 20

#: the kernel's instances (records a block) and the default library's
RECORD_TILES = (1024, 2048, 4096)
DEFAULT_RECORD_TILE = 2048


def defines(config) -> tuple:
    """The ``-D`` macros of ``config``'s instance (``()``: the default
    library); raises for a record tile that has no instance."""
    rt = DEFAULT_RECORD_TILE if config is None else config.record_tile
    if rt not in RECORD_TILES:
        raise ValueError(f"stream_sample: record_tile {rt} has no instance; "
                         f"one of {RECORD_TILES}")
    return () if rt == DEFAULT_RECORD_TILE else (("REPRO_RECORD_TILE", rt),)


class SampleArgs(NamedTuple):
    """B1's arguments, in the order :func:`stream_sample` takes them.

    t       : (T,) float64, the sources' sorted timestamps end to end.
    base    : (S,) int64, each row's first record in ``t``; row ``s``
              reads records ``base[s]`` to ``base[s] + max(lengths[s], 1)
              - 1``.
    t_min   : (S,) float64, each row's rebase origin: the kernel takes
              ``f32(t - t_min)``, numpy's ``(t64 - t_min).astype(float32)``.
    starts, counts, ktab : (S, W) int32 exact per-bucket tables, ``starts``
              counted from the row's first record.
    scalars : (S, 2) float32 rows of (1/span, n_buckets).
    lengths : (S,) int32 row lengths; keep is False past them, and lanes
              past them read the row's last record, as the reference's
              rows padded with their last timestamp do.
    n       : int, the output's width (lanes a row).
    """
    t: torch.Tensor
    base: torch.Tensor
    t_min: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    ktab: torch.Tensor
    scalars: torch.Tensor
    lengths: torch.Tensor
    n: int

    def rows(self, a: int, b: int) -> "SampleArgs":
        """The arguments of rows ``[a, b)``, over the same sources."""
        return SampleArgs(self.t, *(x[a:b] for x in self[1:8]), self.n)


def stream_sample_plain(t, base, t_min, starts, counts, ktab, scalars,
                        lengths, n):
    """Plain PyTorch version of the kernel (any device), on
    :class:`SampleArgs`. Returns ``(ss int32 (S, n), keep bool (S, n))``.
    """
    S = starts.shape[0]
    dev = starts.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    last = (lengths.to(torch.int64) - 1).clamp(min=0)
    rec = base[:, None] + torch.minimum(lane[None, :], last[:, None])
    t32 = (t[rec] - t_min[:, None]).to(torch.float32)
    inv_span, nb_f = scalars[:, 0:1], scalars[:, 1:2]
    nb = nb_f.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    g = torch.floor(t32 * inv_span * nb_f).to(torch.int32)
    g = torch.minimum(torch.maximum(g, zero), nb - 1)
    gidx = lane.to(torch.int32).expand(S, n)
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
def _entry(defs):
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("stream_sample", "stream_sample_launch",
                       [p] * 10 + [i, i, i, p], defs)


def _check_inputs(t, base, t_min, starts, counts, ktab, scalars, lengths,
                  n) -> None:
    if starts.ndim != 2:
        raise ValueError(f"starts: want (S, W), got {tuple(starts.shape)}")
    S, W = starts.shape
    want = {"t": (t, torch.float64, (t.numel(),)),
            "base": (base, torch.int64, (S,)),
            "t_min": (t_min, torch.float64, (S,)),
            "starts": (starts, torch.int32, (S, W)),
            "counts": (counts, torch.int32, (S, W)),
            "ktab": (ktab, torch.int32, (S, W)),
            "scalars": (scalars, torch.float32, (S, 2)),
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
    # one block a (row, record tile): the grid's one dimension
    if n < 0 or S * n >= 2 ** 31 or S * -(-n // min(RECORD_TILES)) >= 2 ** 31:
        raise ValueError(f"batch {S} x {n} too large for one launch")


def stream_sample(t, base, t_min, starts, counts, ktab, scalars, lengths,
                  n, *, config=None):
    """B1 on the tensors' device: the CUDA kernel for CUDA tensors (the
    instance ``config`` names, ``None`` the default), the plain version for
    CPU tensors (same arguments, :class:`SampleArgs`, and results as
    :func:`stream_sample_plain`). Each kernel launch adds one to
    ``stream_sample.launches``."""
    args = (t, base, t_min, starts, counts, ktab, scalars, lengths, int(n))
    if t.device.type == "cpu":
        return stream_sample_plain(*args)
    if t.device.type != "cuda":
        raise ValueError(f"stream_sample runs on cuda or cpu, not "
                         f"{t.device}")
    defs = defines(config)
    _check_inputs(*args)
    S, n = starts.shape[0], args[-1]
    ss = torch.empty((S, n), dtype=torch.int32, device=t.device)
    keep = torch.empty((S, n), dtype=torch.bool, device=t.device)
    p = _build.ptr
    with torch.cuda.device(t.device):
        code = _entry(defs)(p(t), p(base), p(t_min), p(starts), p(counts),
                            p(ktab), p(scalars), p(lengths), p(ss), p(keep),
                            S, n, starts.shape[1],
                            _build.stream_handle(t.device))
    _build.check(code, "stream_sample")
    stream_sample.launches += 1
    return ss, keep


stream_sample.launches = 0
