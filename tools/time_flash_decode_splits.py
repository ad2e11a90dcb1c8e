#!/usr/bin/env python3
"""Kernel B8 (``flash_decode``) at the split sizes it could take, on one
NVIDIA card.

    python3 tools/time_flash_decode_splits.py [--reps 20] [--seed 0]
        [--out FILE]

At each shape (recurrentgemma-2b's local layers with full and ragged
2048-slot rings, at the serving cache of 512 slots and at batch 1;
llama3-8b's decode_32k shape; command-r-plus-104b's heads over 4096
positions), B8 runs with the shipped split (``split_size`` over the
instance's blocks per SM) and with the split forced (``flash_decode(...,
_chunk=)``) to each power-of-two multiple of the kernel's 64-position
stage from 64 to the whole cache. Each forced run is held to the plain
version (its largest absolute difference printed); every run is timed
with ``chip_smoke._time_ms`` (CUDA events, cold L2), beside
``scaled_dot_product_attention`` (``enable_gqa``) and the bound from the
bytes read. All in one process, so the splits are compared within one
call. Prints one JSON object per shape, and one for all of them, which
it also writes to ``--out`` when given. Needs a CUDA device; fails
without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

#: name: (B, S, H, Kh, D, lengths)
SHAPES = {
    "recurrentgemma_full": (8, 2048, 10, 1, 256, [2048] * 8),
    "recurrentgemma_ragged": (8, 2048, 10, 1, 256,
                              [1, 100, 777, 1500, 2047, 2048, 2048, 2048]),
    "recurrentgemma_serve": (8, 512, 10, 1, 256,
                             [17, 20, 24, 28, 18, 21, 25, 30]),
    "recurrentgemma_b1": (1, 2048, 10, 1, 256, [2048]),
    "llama3_decode_32k": (16, 32768, 32, 8, 128, [32768] * 16),
    "command_r_plus_4k": (8, 4096, 96, 8, 128, [4096] * 8),
}


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_decode_splits: needs a CUDA device",
              file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    tile, max_group = fd._limits()
    sms = _build.sm_count(0)
    out = {"card": cs._card_line()}
    for name, (B, S, H, Kh, D, lens) in SHAPES.items():
        q, k, v, ln = cs._decode_inputs(gen, B, S, H, Kh, D, "bfloat16",
                                        lens, "cuda")
        want = fd.flash_decode_plain(q, k, v, ln)
        n_slices = fd.group_slices(H // Kh, max_group)[0]
        blocks = fd._blocks_per_sm(0, 1, D)
        row = {"blocks_per_sm": blocks,
               "shipped_chunk": fd.split_size(B, Kh * n_slices, S, sms, tile,
                                              blocks),
               "shipped_ms": cs._time_ms(lambda: fd.flash_decode(q, k, v, ln),
                                         args.reps)}
        chunk = tile
        while chunk < 2 * S:
            got = fd.flash_decode(q, k, v, ln, _chunk=chunk)
            row[str(chunk)] = {
                "max_abs_err": float((got.float() - want.float())
                                     .abs().max()),
                "ms": cs._time_ms(lambda c=chunk: fd.flash_decode(
                    q, k, v, ln, _chunk=c), args.reps)}
            chunk *= 2
        row["sdpa_ms"] = cs._time_ms(
            lambda: cs._decode_attention_sdpa(q, k, v, ln), args.reps)
        row["bound_ms"] = cs._decode_bound(lens, S, H, Kh, D, 2)[0]
        out[name] = row
        print(name, json.dumps(row), flush=True)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
