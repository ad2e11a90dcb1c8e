"""Kernels B4, B5 and B7: the device half of the Fig.-6 trend chain.

Counterparts of ``repro/kernels/trend_scan.py``:

- :func:`trend_scan` (B4, ``trend_scan_pallas``): per-row inclusive int32
  prefix sums of ``(S, N)`` count series. It launches
  ``csrc/trend_scan.cu`` (one launch: a single-pass scan with decoupled
  look-back, its scratch cached per CUDA stream) for CUDA tensors and runs
  :func:`trend_scan_plain` for CPU tensors. Exact while a row's total
  stays below 2³¹ (the ops layer guards that before the call).
- :func:`trend_scan_carry` (B7, ``trend_scan_carry_pallas``): the same scan
  over one time chunk, each row's running total seeded from ``init`` and
  returned as ``tail`` for the next chunk (same source, same exactness;
  ``init = 0`` gives B4's prefix sums bit for bit).
- :func:`pair_stats` (B5, ``pair_stats_pallas``): per-row sums and the
  Gram matrix ``x·xᵀ`` of ``(S, K)`` float32 trends. It launches
  ``csrc/pair_stats.cu`` for CUDA tensors (one launch: output tiles times
  splits of the time axis in thread block clusters, each input byte read
  once, the splits' partials folded in a fixed order; :func:`pair_plan`
  cuts the input) and runs :func:`pair_stats_plain` for CPU tensors. The
  kernel accumulates in f32 without TF32; the plain version computes in
  float64 and rounds once, so it is the oracle the kernel is held to
  (within ``1e-4·sqrt(G[a,a]·G[b,b])``).

Each wrapper adds one to its ``launches`` count where it launches its
kernel, and nowhere else.

A tile config (:class:`repro_torch.kernels.tuning.TileConfig`) chooses B4's
and B7's instance by ``record_tile`` (entries a tile, one of
:data:`RECORD_TILES`; no output changes) and B5's time quantum by
``bucket_block`` (the plan's split floor is 32 quanta of bytes, one of
:data:`PAIR_QUANTA`; no new library, the sums change in their last bits).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: B4's and B7's instances (entries a tile) and the default library's
RECORD_TILES = (1024, 2048, 4096)
DEFAULT_RECORD_TILE = 2048
#: B5's time quanta (a tile config's ``bucket_block``): the ops layer pads
#: the time axis to one, and the plan takes at least 32 of them in bytes a
#: split; 512 (16 KiB) by default
PAIR_QUANTA = (256, 512, 1024)
PAIR_QUANTUM = 512


def defines(config) -> tuple:
    """The ``-D`` macros of ``config``'s B4/B7 instance (``()``: the
    default library); raises for a record tile that has no instance."""
    rt = DEFAULT_RECORD_TILE if config is None else config.record_tile
    if rt not in RECORD_TILES:
        raise ValueError(f"trend_scan: record_tile {rt} has no instance; "
                         f"one of {RECORD_TILES}")
    return () if rt == DEFAULT_RECORD_TILE else (("REPRO_RECORD_TILE", rt),)


def pair_quantum(config) -> int:
    """B5's time quantum under ``config`` (``None``: the default); raises
    for a quantum the plan does not take."""
    bb = PAIR_QUANTUM if config is None else int(config.bucket_block)
    if bb not in PAIR_QUANTA:
        raise ValueError(f"pair_stats: bucket_block {bb} is not one of "
                         f"{PAIR_QUANTA}")
    return bb


# ------------------------------------------------------------------ B4
def trend_scan_plain(q):
    """Plain PyTorch version of B4 (any device): ``(S, N)`` int32 counts ->
    ``(S, N)`` int32 inclusive prefix sums per row."""
    return torch.cumsum(q, dim=1, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _scan_entry(defs):
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("trend_scan", "trend_scan_launch",
                       [p, i, i, p, p, ctypes.c_uint, p, p], defs)


@functools.lru_cache(maxsize=None)
def _scan_limits(defs):
    """(entries per tile, largest epoch), read from the library so the
    status array is sized as the kernel indexes it."""
    return (_build.bind("trend_scan", "trend_scan_tile_entries", [], defs)(),
            _build.bind("trend_scan", "trend_scan_max_epoch", [], defs)())


#: one workspace per (device, CUDA stream), shared by B4, B7 and their
#: instances (each call takes a new epoch and sizes the words by its own
#: tile count)
_workspaces = {}


def _scan_scratch(dev, S: int, n: int, defs):
    """``(status words, counter, epoch, stream)`` for one scan call."""
    tile, max_epoch = _scan_limits(defs)
    ws, stream = _build.per_stream(
        _workspaces, dev, lambda d: _build.LookbackWorkspace(d, max_epoch))
    return (*ws.take(S * -(-n // tile)), stream)


def _check_counts(q, what):
    """The counts' shape ``(S, N)``, after the checks both scans share."""
    if q.dtype != torch.int32 or q.ndim != 2 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous 2-D int32 tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    S, n = q.shape
    if S > 65535 or S * n >= 2 ** 31:
        raise ValueError(f"{what}: batch {S} x {n} too large for one launch")
    return S, n


def trend_scan(q, *, config=None):
    """B4 on the counts' device: the CUDA kernel for a CUDA tensor (the
    instance ``config`` names, ``None`` the default), the plain version for
    a CPU tensor (same contract as :func:`trend_scan_plain`). One launch
    per call; each adds one to ``trend_scan.launches``."""
    if q.device.type == "cpu":
        return trend_scan_plain(q)
    if q.device.type != "cuda":
        raise ValueError(f"trend_scan runs on cuda or cpu, not {q.device}")
    defs = defines(config)
    S, n = _check_counts(q, "trend_scan")
    dev = q.device
    psum = torch.empty((S, n), dtype=torch.int32, device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        words, counter, epoch, stream = _scan_scratch(dev, S, n, defs)
        code = _scan_entry(defs)(p(q), S, n, p(words), p(counter), epoch,
                                 p(psum), stream)
    _build.check(code, "trend_scan")
    trend_scan.launches += 1
    return psum


trend_scan.launches = 0


# ------------------------------------------------------------------ B7
def trend_scan_carry_plain(q, init):
    """Plain PyTorch version of B7 (any device).

    q    : (S, N) int32 counts of one time chunk.
    init : (S,) int32 — each row's running total through the previous
           chunk.

    Returns ``(psum int32 (S, N), tail int32 (S,))`` with
    ``psum[s, i] = init[s] + q[s, 0] + ... + q[s, i]`` and ``tail[s]`` the
    row's total through this chunk (``init[s]`` for an empty chunk).
    """
    init = init.to(device=q.device, dtype=torch.int32).reshape(-1)
    psum = torch.cumsum(q, dim=1, dtype=torch.int32) + init[:, None]
    tail = psum[:, -1].clone() if q.shape[1] else init.clone()
    return psum, tail


@functools.lru_cache(maxsize=None)
def _scan_carry_entry(defs):
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("trend_scan", "trend_scan_carry_launch",
                       [p, p, i, i, p, p, ctypes.c_uint, p, p, p], defs)


def trend_scan_carry(q, init, *, config=None):
    """B7 on the counts' device: the CUDA kernel for a CUDA tensor (the
    instance ``config`` names, ``None`` the default), the plain version for
    a CPU tensor (same contract as :func:`trend_scan_carry_plain`). One
    launch per call, an empty chunk included; each adds one to
    ``trend_scan_carry.launches``."""
    if q.device.type == "cpu":
        return trend_scan_carry_plain(q, init)
    if q.device.type != "cuda":
        raise ValueError(f"trend_scan_carry runs on cuda or cpu, not "
                         f"{q.device}")
    defs = defines(config)
    S, n = _check_counts(q, "trend_scan_carry")
    if init.dtype != torch.int32 or tuple(init.shape) != (S,) or \
            init.device != q.device or not init.is_contiguous():
        raise ValueError("init must be a contiguous (S,) int32 tensor on "
                         "the counts' device")
    dev = q.device
    psum = torch.empty((S, n), dtype=torch.int32, device=dev)
    tail = torch.empty(S, dtype=torch.int32, device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        words, counter, epoch, stream = _scan_scratch(dev, S, n, defs)
        code = _scan_carry_entry(defs)(p(q), p(init), S, n, p(words),
                                       p(counter), epoch, p(psum), p(tail),
                                       stream)
    _build.check(code, "trend_scan_carry")
    trend_scan_carry.launches += 1
    return psum, tail


trend_scan_carry.launches = 0


# ------------------------------------------------------------------ B5
def pair_stats_plain(x):
    """Plain PyTorch version of B5 (any device), computed in float64 and
    rounded once to float32, so it does not depend on any TF32 setting.

    x : (S, K) float32. Returns ``(sums f32 (S, 1), gram f32 (S, S))`` with
    ``sums[a] = Σ_t x[a, t]`` and ``gram[a, b] = Σ_t x[a, t]·x[b, t]``.
    """
    x64 = x.to(torch.float64)
    return (x64.sum(dim=1, keepdim=True).to(torch.float32),
            (x64 @ x64.T).to(torch.float32))


#: B5's plan: at least this many bytes of input a block where a tile takes
#: more than one cluster of splits (32 default time quanta)
PAIR_MIN_SPLIT_BYTES = 32 * PAIR_QUANTUM


def pair_plan(S: int, K: int, max_clusters: int, tile: int, cluster: int,
              min_split_bytes: int = PAIR_MIN_SPLIT_BYTES):
    """How B5's kernel cuts an ``(S, K)`` input: ``(kc, n_splits,
    pstride, tiles)`` -- columns a split (a multiple of 4), splits a tile
    (a multiple of ``cluster``; splits past K are empty), floats a
    workspace slot (the largest tile's partial: 16 a 4 x 4 micro-tile of
    row groups, plus a diagonal tile's row sums) and output tiles (the
    upper triangle of ``ceil(S / tile)`` row tiles). The grid holds at most
    ``max_clusters`` clusters (what the card runs at once) and the
    workspace is needed only with more than one cluster a tile; a split
    takes at least ``min_split_bytes`` of input (32 time quanta)."""
    nt = -(-S // tile)
    tiles = nt * (nt + 1) // 2
    if nt == 1:
        g = -(-S // 4)
        pstride = 16 * g * (g + 1) // 2 + 4 * g
        rows = S
    else:
        pstride = (tile // 4) ** 2 * 16
        rows = 2 * tile
    clusters = max(1, min(max_clusters // tiles,
                          rows * K * 4 // (cluster * min_split_bytes)))
    n = cluster * clusters
    kc = -(-K // (4 * n)) * 4
    return kc, n, pstride, tiles


@functools.lru_cache(maxsize=None)
def _pair_entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("pair_stats", "pair_stats_launch",
                       [p, i, i, i, i, i, p, p, p, p, p])


@functools.lru_cache(maxsize=None)
def _pair_limits():
    """(rows of an output tile, splits of a cluster), read from the
    library so the plan matches what the kernel indexes."""
    return (_build.bind("pair_stats", "pair_stats_tile", [])(),
            _build.bind("pair_stats", "pair_stats_cluster", [])())


@functools.lru_cache(maxsize=None)
def _pair_max_clusters(index: int) -> int:
    """Clusters of B5's kernel that device ``index`` runs at once."""
    with torch.cuda.device(index):
        n = _build.bind("pair_stats", "pair_stats_max_clusters", [])()
    if n < 1:
        raise RuntimeError(f"pair_stats: occupancy query failed ({n})")
    return n


#: B5's cluster sums and tickets, one workspace per (device, CUDA stream)
_pair_workspaces = {}


def pair_stats(x, *, config=None):
    """B5 on the trends' device: the CUDA kernel for a CUDA tensor, planned
    with ``config``'s time quantum (``None``: the default), the plain
    version for a CPU tensor (same contract as :func:`pair_stats_plain`,
    for any S >= 1 and K >= 0). One launch per call (the splits' partials
    folded inside it, in an order fixed by the shape and the quantum, so
    two calls are bit-identical); each adds one to
    ``pair_stats.launches``."""
    if x.device.type == "cpu":
        return pair_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"pair_stats runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    S, k = x.shape
    if S < 1 or S * S >= 2 ** 31 or S * k >= 2 ** 31:
        raise ValueError(f"batch {S} x {k} outside one launch")
    dev = x.device
    tile, cluster = _pair_limits()
    kc, n, pstride, tiles = pair_plan(
        S, k, _pair_max_clusters(dev.index or 0), tile, cluster,
        32 * pair_quantum(config))
    sums = torch.empty((S, 1), dtype=torch.float32, device=dev)
    gram = torch.empty((S, S), dtype=torch.float32, device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        ws, stream = _build.per_stream(_pair_workspaces, dev,
                                       _build.SplitWorkspace)
        if n > cluster:
            ws.take(tiles * n // cluster * pstride, tiles)
        code = _pair_entry()(p(x), S, k, kc, n, pstride, p(ws.partials),
                             p(ws.tickets), p(sums), p(gram), stream)
    _build.check(code, "pair_stats")
    pair_stats.launches += 1
    return sums, gram


pair_stats.launches = 0
