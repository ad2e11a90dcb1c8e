"""Kernel B8: GQA decode attention over a KV cache, masked by lengths.

Counterpart of ``repro/kernels/flash_decode.py::flash_decode_pallas`` and
its oracle ``repro/kernels/ref.py::flash_decode_ref``:
:func:`flash_decode` launches ``csrc/flash_decode.cu`` (split-KV
flash-decoding in one launch, the splits merged inside the kernel) for
CUDA tensors and runs :func:`flash_decode_plain` for CPU tensors.

Contract of both: q (B, H, D), k and v (B, S, Kh, D) with H = Kh * G,
lengths (B,) int32. For each (b, h), a softmax of ``q·k / sqrt(D)`` over
the cache positions ``s < min(lengths[b], S)``, then the weighted sum of
v, accumulated in float32 and returned in q's dtype. A length above S
means the whole cache, and a row of length 0 gives zeros. The kernel
takes any group G >= 1 (a block holds up to 8 query rows; a larger group
runs as :func:`group_slices` side by side in one launch) and the head
dimensions of :data:`HEAD_DIMS`; another shape raises ``ValueError``.

Positions at or past a row's length: the CUDA kernel never reads them, so
its output does not depend on what they hold, NaN and inf included. The
plain version keeps ``ref.flash_decode_ref``'s semantics: it computes
scores over the whole cache and masks them, so finite values there do not
matter, but a NaN or inf there gives NaN, as in the reference.

Each kernel launch adds one to ``flash_decode.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: head dimensions the CUDA kernel is built for, by dtype: every
#: (dtype, head_dim) of a config in ``configs/`` (the smoke configs' 16,
#: musicgen's and the consumer LM's 64, the 128 of most, recurrentgemma's
#: 256 in bfloat16)
HEAD_DIMS = {torch.float32: (16, 64, 128),
             torch.bfloat16: (16, 64, 128, 256)}
#: tiles a split keeps at least, so that its ring has a tile in flight
#: while one is read
MIN_SPLIT_TILES = 2


def flash_decode_plain(q, k, v, lengths):
    """Plain PyTorch version of B8 (any device), after
    ``repro/kernels/ref.py::flash_decode_ref``: f32 scores over the whole
    cache, masked to ``s < lengths[b]``, a softmax normalised before the
    product with v."""
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    qf = q.reshape(B, Kh, H // Kh, D).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) / torch.sqrt(
        torch.tensor(D, dtype=torch.float32, device=q.device))
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < lengths.to(q.device)[:, None]            # (B, S)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(torch.finfo(
        torch.float32).tiny)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("flash_decode", "flash_decode_launch",
                       [i, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p,
                        p])


@functools.lru_cache(maxsize=None)
def _limits():
    """(positions per tile, largest query group) read from the library, so
    the split size and the check match what the kernel indexes."""
    return (_build.bind("flash_decode", "flash_decode_tile", [])(),
            _build.bind("flash_decode", "flash_decode_max_group", [])())


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: int, dtype_code: int, head_dim: int) -> int:
    """Blocks of the (dtype, head_dim) instance one SM of ``device`` holds
    at once, from the CUDA occupancy calculator (the instance's shared
    memory decides it: one block at bf16 D = 256 or f32 D = 128, two at
    bf16 D = 128)."""
    i = ctypes.c_int
    with torch.cuda.device(device):
        n = _build.bind("flash_decode", "flash_decode_blocks_per_sm",
                        [i, i])(dtype_code, head_dim)
    if n < 1:
        raise RuntimeError(f"flash_decode: occupancy {n} for dtype code "
                           f"{dtype_code}, D={head_dim}")
    return n


def group_slices(G: int, max_group: int) -> tuple:
    """``(n_slices, slice)``: a group of ``G`` query heads per KV head cut
    into the fewest slices of at most ``max_group`` heads (one block's
    query rows), of equal size but the last, which may be smaller."""
    n = -(-G // max_group)
    return n, -(-G // n)


def split_size(B: int, Kh: int, S: int, sm_count: int, tile: int,
               blocks_per_sm: int) -> int:
    """Cache positions per split: the whole cache in whole tiles of
    ``tile`` positions (the kernel's stage), halved while the halves keep
    at least :data:`MIN_SPLIT_TILES` tiles and the (split, KV head,
    sequence) grid over a full cache still fits in one wave, the
    ``blocks_per_sm`` blocks of the instance that each of ``sm_count`` SMs
    holds at once. Fewer, longer splits keep each block's copies
    pipelined and the merge short; more blocks than a wave only queue.
    ``Kh`` counts the blocks across the heads: KV heads times their group
    slices (:func:`group_slices`)."""
    chunk = -(-S // tile) * tile
    wave = blocks_per_sm * sm_count
    while True:
        half = chunk // 2 // tile * tile
        if half < MIN_SPLIT_TILES * tile or B * Kh * -(-S // half) > wave:
            return chunk
        chunk = half


#: one workspace per (device, CUDA stream)
_workspaces = {}


def flash_decode(q, k, v, lengths, *, block_s: int = 512,
                 _chunk: int | None = None):
    """B8 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same contract as :func:`flash_decode_plain`).
    ``block_s`` is the reference's block knob, kept for its signature: the
    kernel's split follows from the shapes, the SM count and the
    instance's occupancy (:func:`split_size`), and the result does not
    depend on it. ``_chunk`` forces the positions per split (a multiple
    of the tile), for timing the splits against each other. One launch
    per call; each adds one to ``flash_decode.launches``."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2] or \
            tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)} are not (B, H, D), "
                         "(B, S, Kh, D) twice and (B,)")
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    if D not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head_dim {D} not built in {q.dtype}; the kernel "
                         f"takes {HEAD_DIMS[q.dtype]}")
    if Kh < 1 or H % Kh or H < Kh:
        raise ValueError(f"{H} query heads over {Kh} KV heads: not a whole "
                         "group per KV head")
    if B > 65535 or S < 1:
        raise ValueError(f"B={B}, S={S} outside one launch")
    tensors = (q, k, v, lengths)
    if any(t.device != q.device for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v and lengths must be contiguous tensors on "
                         "one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    dev = q.device
    dtype_code = 0 if q.dtype == torch.float32 else 1
    tile, max_group = _limits()
    n_slices, slice_ = group_slices(H // Kh, max_group)
    chunk = _chunk or split_size(B, Kh * n_slices, S,
                                 _build.sm_count(dev.index), tile,
                                 _blocks_per_sm(dev.index, dtype_code, D))
    n_splits = -(-S // chunk)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    n_ml = B * H * n_splits * 2
    p = _build.ptr
    with torch.cuda.device(dev):
        ws, stream = _build.per_stream(_workspaces, dev,
                                       _build.SplitWorkspace)
        partials, tickets = ws.take(n_ml + B * H * n_splits * D,
                                    B * Kh * n_slices)
        ws_ml = partials.data_ptr()
        code = _entry()(dtype_code, p(q), p(k), p(v), p(lengths), B, S, Kh,
                        H // Kh, D, slice_, chunk, n_splits,
                        ctypes.c_void_p(ws_ml),
                        ctypes.c_void_p(ws_ml + 4 * n_ml), p(tickets),
                        p(out), stream)
    _build.check(code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
