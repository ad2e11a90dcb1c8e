"""Kernel B2: batched mask compaction, keep mask -> kept-record indices.

Counterpart of ``repro/kernels/compact.py::compact_positions_batched_pallas``
plus the XLA scatter after it (``repro/kernels/ops.py``
``compact_mask_batched_device``). :func:`compact` launches
``csrc/compact.cu`` for CUDA tensors: one launch per call that scans the
mask, writes the kept indices and fills the sentinel (a single pass with
decoupled look-back, its scratch cached per CUDA stream). It runs
:func:`compact_plain` for CPU tensors.

The default library holds two tile sizes and picks one from the shape
(:func:`shape_tile`). A tile config
(:class:`repro_torch.kernels.tuning.TileConfig`) names one of
:data:`RECORD_TILES` instead: the default library when the shape would
pick that tile anyway, else a library built with that one tile. It changes
no output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: the kernel's instances (records a tile); the default library holds the
#: smallest and the largest and picks by :func:`shape_tile`
RECORD_TILES = (4096, 8192, 16384)


def shape_tile(rows: int, n: int, sms: int) -> int:
    """The tile the default library launches for an ``(rows, n)`` mask on
    a card of ``sms`` SMs: the large one when the call has at least one
    large tile per SM, else the small one (``compact.cu``)."""
    large = RECORD_TILES[-1]
    return large if rows * -(-n // large) >= sms else RECORD_TILES[0]


def defines(config, rows: int, n: int, sms: int) -> tuple:
    """The ``-D`` macros of ``config``'s instance for an ``(rows, n)`` mask
    (``()``: the default library); raises for a record tile that has no
    instance."""
    if config is None:
        return ()
    rt = config.record_tile
    if rt not in RECORD_TILES:
        raise ValueError(f"compact: record_tile {rt} has no instance; one "
                         f"of {RECORD_TILES}")
    return () if rt == shape_tile(rows, n, sms) else \
        (("REPRO_RECORD_TILE", rt),)


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
def _entry(defs):
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("compact", "compact_launch",
                       [p, i, i, p, p, ctypes.c_uint, p, p, p], defs)


@functools.lru_cache(maxsize=None)
def _limits(defs):
    """(records per small tile, largest epoch), read from the library:
    one status word per small tile is enough for either tile size the
    kernel picks."""
    return (_build.bind("compact", "compact_tile_records", [], defs)(),
            _build.bind("compact", "compact_max_epoch", [], defs)())


#: one look-back workspace per (device, CUDA stream), shared by the
#: instances (each call takes a new epoch; the words grow to the call's
#: tile count)
_workspaces = {}


def compact(mask, *, config=None):
    """B2 on the mask's device: the CUDA kernel for a CUDA tensor (the
    instance ``config`` names, ``None`` the default library), the plain
    version for a CPU tensor (same contract as :func:`compact_plain`). One
    launch per call, the sentinel fill included; each adds one to
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
    if R * n >= 2 ** 31:
        raise ValueError(f"batch {R} x {n} too large for one launch")
    dev = mask.device
    idx = torch.empty((R, n), dtype=torch.int32, device=dev)
    totals = torch.empty(R, dtype=torch.int32, device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        defs = defines(config, R, n,
                       _build.sm_count(torch.cuda.current_device()))
        tile, max_epoch = _limits(defs)
        ws, stream = _build.per_stream(
            _workspaces, dev,
            lambda d: _build.LookbackWorkspace(d, max_epoch))
        words, counter, epoch = ws.take(R * -(-n // tile))
        code = _entry(defs)(p(mask), R, n, p(words), p(counter), epoch, p(idx),
                        p(totals), stream)
    _build.check(code, "compact")
    compact.launches += 1
    return idx, totals


compact.launches = 0
