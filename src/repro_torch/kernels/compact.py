"""Kernel B2: batched mask compaction, keep mask -> kept-record indices.

Counterpart of ``repro/kernels/compact.py::compact_positions_batched_pallas``
plus the XLA scatter after it (``repro/kernels/ops.py``
``compact_mask_batched_device``): the CUDA kernel fuses the scatter into
the scan. :func:`compact` launches ``csrc/compact.cu`` for CUDA tensors and
runs :func:`compact_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def compact_plain(mask):
    """Plain PyTorch version (any device): an inclusive int32 cumsum per
    row gives each kept record its slot, then one scatter.

    mask : (R, N) bool.
    Returns ``(idx int32 (R, N), totals int32 (R,))``: ``idx[r, :totals[r]]``
    are row ``r``'s set indices in ascending order, the rest is ``N``.
    """
    R, n = mask.shape
    m = mask.to(torch.int32)
    incl = torch.cumsum(m, dim=1, dtype=torch.int32)
    idx = torch.full((R, n), n, dtype=torch.int32, device=mask.device)
    if n == 0:
        return idx, torch.zeros(R, dtype=torch.int32, device=mask.device)
    rows, cols = torch.nonzero(mask, as_tuple=True)
    pos = (incl - m)[rows, cols]
    idx[rows, pos.long()] = cols.to(torch.int32)
    return idx, incl[:, -1].contiguous()


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("compact", "compact_launch",
                       [p, i, i, p, p, p, p, p])


@functools.lru_cache(maxsize=None)
def _tile() -> int:
    """Records per block of the count and scatter phases, read from the
    library so the tile-count scratch is always sized as the kernel
    indexes it."""
    return _build.bind("compact", "compact_tile_records", [])()


def compact(mask):
    """B2 on the mask's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor (same contract as
    :func:`compact_plain`). Each kernel launch adds one to
    ``compact.launches``."""
    if mask.device.type == "cpu":
        return compact_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"compact runs on cuda or cpu, not {mask.device}")
    if mask.dtype != torch.bool or mask.ndim != 2:
        raise ValueError(f"mask must be a 2-D bool tensor, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    R, n = mask.shape
    if R > 65535 or R * n >= 2 ** 31:
        raise ValueError(f"batch {R} x {n} too large for one launch")
    n_tiles = -(-n // _tile())
    dev = mask.device
    idx = torch.full((R, n), n, dtype=torch.int32, device=dev)
    totals = torch.empty(R, dtype=torch.int32, device=dev)
    tile_counts = torch.empty((R, max(n_tiles, 1)), dtype=torch.int32,
                              device=dev)
    tile_offsets = torch.empty_like(tile_counts)
    p = _build.ptr
    with torch.cuda.device(dev):
        code = _entry()(p(mask), R, n, p(tile_counts), p(tile_offsets),
                        p(idx), p(totals), _build.stream_handle(dev))
    _build.check(code, "compact")
    compact.launches += 1
    return idx, totals


compact.launches = 0
