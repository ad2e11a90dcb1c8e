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
means the whole cache, and a row of length 0 gives zeros.

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

#: head dimensions the CUDA kernel is built for
HEAD_DIMS = (64, 128)
#: blocks per SM the split aims for over a full cache
BLOCKS_PER_SM = 8


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
                       [i, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p])


@functools.lru_cache(maxsize=None)
def _limits():
    """(positions per tile, largest query group) read from the library, so
    the split size and the check match what the kernel indexes."""
    return (_build.bind("flash_decode", "flash_decode_tile", [])(),
            _build.bind("flash_decode", "flash_decode_max_group", [])())


def split_size(B: int, Kh: int, S: int, sm_count: int, tile: int) -> int:
    """Cache positions per split: the whole cache in whole tiles of
    ``tile`` positions (the kernel's stage), halved (down to one tile)
    until the (split, KV head, sequence) grid has at least
    :data:`BLOCKS_PER_SM` blocks per SM over a full cache, about four waves
    of the two blocks an SM holds at once."""
    chunk = -(-S // tile) * tile
    while chunk > tile and B * Kh * -(-S // chunk) < BLOCKS_PER_SM * sm_count:
        chunk = max(tile, chunk // 2 // tile * tile)
    return chunk


#: one workspace per (device, CUDA stream)
_workspaces = {}


def flash_decode(q, k, v, lengths, *, block_s: int = 512):
    """B8 on the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same contract as :func:`flash_decode_plain`).
    ``block_s`` is the reference's block knob, kept for its signature: the
    kernel's split follows from the shapes and the SM count
    (:func:`split_size`), and the result does not depend on it. One launch
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
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if H % Kh or not 1 <= H // Kh <= _limits()[1]:
        raise ValueError(f"{H} query heads over {Kh} KV heads: the kernel "
                         f"takes groups of 1..{_limits()[1]}")
    if B > 65535 or Kh > 65535 or S < 1:
        raise ValueError(f"B={B}, Kh={Kh}, S={S} outside one launch")
    tensors = (q, k, v, lengths)
    if any(t.device != q.device for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v and lengths must be contiguous tensors on "
                         "one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    dev = q.device
    chunk = split_size(B, Kh, S, _build.sm_count(dev.index or 0),
                       _limits()[0])
    n_splits = -(-S // chunk)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    n_ml = B * H * n_splits * 2
    p = _build.ptr
    with torch.cuda.device(dev):
        ws, stream = _build.per_stream(_workspaces, dev,
                                       _build.SplitWorkspace)
        partials, tickets = ws.take(n_ml + B * H * n_splits * D, B * Kh)
        ws_ml = partials.data_ptr()
        code = _entry()(0 if q.dtype == torch.float32 else 1, p(q), p(k),
                        p(v), p(lengths), B, S, Kh, H // Kh, D, chunk,
                        n_splits, ctypes.c_void_p(ws_ml),
                        ctypes.c_void_p(ws_ml + 4 * n_ml), p(tickets),
                        p(out), stream)
    _build.check(code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
