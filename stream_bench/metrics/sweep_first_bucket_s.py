"""sweep_first_bucket_s: ``first_bucket_s`` read the same way (its reader) in the sweep
cells, where it names ``device_peak_bytes`` as the end-to-end metric it
moves: their host-clock times spread by more than half the widest bound
allowed, so they carry no end-to-end time (PERF.md, section 2)."""

from pathlib import Path

from stream_bench.bench import load_reader

read = load_reader("first_bucket_s", Path(__file__).resolve().parent.parent)
