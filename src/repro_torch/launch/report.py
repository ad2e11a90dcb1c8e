"""Assemble the dry-run's tables from the port's records
(``results/torch_dryrun/*.json``, :mod:`repro_torch.launch.dryrun`).

Counterpart of ``repro/launch/report.py``: the same tables in the same
order; the dry-run table's ``compile_s`` column is ``trace_s`` (the port
traces each step once and compiles nothing)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

ARCH_ORDER = [
    "recurrentgemma-2b", "qwen3-32b", "qwen1_5-110b", "llama3-8b",
    "command-r-plus-104b", "rwkv6-1_6b", "deepseek-v3-671b",
    "llama4-scout-17b-a16e", "musicgen-medium", "llava-next-34b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_s(x):
    if x >= 100:
        return f"{x:.0f}"
    if x >= 1:
        return f"{x:.2f}"
    return f"{x:.4f}"


def load(outdir: Path, tag: str):
    recs = {}
    for p in sorted(outdir.glob(f"{tag}__*.json")):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def roofline_table(recs, mesh="single") -> str:
    rows = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
            "| bytes/dev GiB | useful FLOPs ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh))
            if r is None:
                continue
            if r.get("skipped"):
                rows.append(f"| {a} | {s} | — | — | — | skipped "
                            f"(full attention @500k) | — | — | — |")
                continue
            rl = r["roofline"]
            rows.append(
                f"| {a} | {s} | {fmt_s(rl['compute_s'])} "
                f"| {fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} "
                f"| {rl['dominant'].replace('_s','')} "
                f"| {r['memory']['per_device_bytes']/2**30:.2f} "
                f"| {rl['useful_flops_ratio']:.3f} "
                f"| {rl['roofline_fraction']:.4f} |")
    return "\n".join(rows)


def dryrun_table(recs) -> str:
    rows = ["| arch | shape | mesh | trace_s | HLO flops/dev | bytes/dev "
            "| collective GB/dev | collective mix |",
            "|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            for m in ("single", "multi"):
                r = recs.get((a, s, m))
                if r is None or r.get("skipped"):
                    continue
                mix = ",".join(f"{k.replace('all-','a').replace('reduce-','r')}"
                               f"×{v['count']}"
                               for k, v in sorted(r["collectives"].items()))
                rows.append(
                    f"| {a} | {s} | {m} | {r['trace_s']:.0f} "
                    f"| {r['hlo_flops']:.2e} | {r['hlo_bytes']:.2e} "
                    f"| {r['collective_bytes_per_device']/1e9:.2f} | {mix} |")
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--table", choices=["roofline", "dryrun"],
                    default="roofline")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    recs = load(Path(args.out), args.tag)
    if args.table == "roofline":
        print(roofline_table(recs, args.mesh))
    else:
        print(dryrun_table(recs))


if __name__ == "__main__":
    main()
